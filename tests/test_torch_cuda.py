"""The hand-written CUDA kernels against their plain PyTorch versions,
on the card, and the port's rounds on the card against the same rounds
on the CPU.  Marked ``gpu``: without a CUDA device every test skips
(the decision is made in a fixture, so every worker collects the same
tests).  Run on a GPU machine with

    python -m pytest -q -m gpu tests/test_torch_cuda.py

The machine with the card has no JAX, so this file imports only the
port; the JAX package is held against the plain versions on the CPU
(test_torch_packet_scatter.py, test_torch_server.py,
test_torch_fedavg_accum.py, test_torch_aggregation.py,
test_torch_fedavg.py).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.core import aggregation as agg
from repro_torch.core import engine_compiled as ec
from repro_torch.core import rounds
from repro_torch.core import server
from repro_torch.core.fedavg import FedAvgConfig, ModelFns, run_fedavg
from repro_torch.core.packets import quantize_payload
from repro_torch.data.federated import partition_iid
from repro_torch.data.synthetic import synthetic_image_classification
from repro_torch.kernels import fedavg_accum as fa
from repro_torch.kernels import packet_scatter as ps
from repro_torch.kernels import quantized_accum as qa
from repro_torch.models import cnn

pytestmark = pytest.mark.gpu

S, W, N = 40, 37, 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _batch(seed, dev, *, q8, integer):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, S, N).astype(np.int32)
    idx[5] = idx[9] = idx[0]                     # duplicates
    idx[-8:] = -1                                # padding
    idx[-9] = S + 1                              # out of range
    w = rng.integers(1, 4, N).astype(np.float32)
    w[9] = 0.0
    w[-8:] = 0.0
    if q8:
        pk = rng.integers(-127, 128, (N, W)).astype(np.int8)
        sc = ((2.0 ** rng.integers(-5, 1, N)) if integer
              else rng.uniform(1e-3, 1e-1, N)).astype(np.float32)
    else:
        pk = (rng.integers(-8, 9, (N, W)) if integer
              else rng.normal(size=(N, W))).astype(np.float32)
        sc = None
    acc = (rng.integers(-8, 9, (S, W)) if integer
           else rng.normal(size=(S, W))).astype(np.float32)
    cnt = rng.integers(0, 3, S).astype(np.float32)
    t = lambda a: None if a is None else torch.from_numpy(a).to(dev)
    return t(pk), t(sc), t(idx), t(w), t(acc), t(cnt)


def _run(pk, sc, idx, w, acc, cnt, exact, plain):
    if sc is None:
        fn = ps.packet_scatter_accum_plain if plain else ps.packet_scatter_accum
        return fn(pk, idx, w, acc, cnt, exact=exact)
    fn = ps.packet_scatter_accum_q8_plain if plain \
        else ps.packet_scatter_accum_q8
    return fn(pk, sc, idx, w, acc, cnt, exact=exact)


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "approx"])
@pytest.mark.parametrize("integer", [True, False], ids=["int", "gauss"])
def test_kernel_matches_plain(cuda, q8, exact, integer):
    pk, sc, idx, w, acc, cnt = _batch(0, cuda, q8=q8, integer=integer)
    want = _run(pk, sc, idx, w, acc, cnt, exact, plain=True)
    counter = ps.packet_scatter_accum_q8 if q8 else ps.packet_scatter_accum
    before = counter.launches
    a, c = acc.clone(), cnt.clone()
    out = _run(pk, sc, idx, w, a, c, exact, plain=False)
    torch.cuda.synchronize()
    assert out[0] is a and out[1] is c
    assert counter.launches == before + 1
    # the plain version sums a slot's hits in the kernel's order: bitwise
    # on Gaussian payloads too
    torch.testing.assert_close(a, want[0], rtol=0, atol=0)
    torch.testing.assert_close(c, want[1], rtol=0, atol=0)


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
def test_all_padding_batch_is_inert(cuda, q8):
    pk, sc, idx, w, acc, cnt = _batch(1, cuda, q8=q8, integer=True)
    idx.fill_(-1)
    a, c = acc.clone(), cnt.clone()
    _run(pk, sc, idx, w, a, c, True, plain=False)
    torch.cuda.synchronize()
    assert torch.equal(a, acc) and torch.equal(c, cnt)


def _schedule(seed, dev, *, q8, hot):
    """Gaussian drain schedule: 8 rows of ``_batch`` (duplicates within
    and across rows, weight-0 arrivals, padding, idx >= S), or with
    ``hot`` 40 rows in which slot 3 takes 60 positions each (2,400 hits,
    above the fold's shared-memory sort)."""
    rows = [_batch(10 + r, dev, q8=q8, integer=False)
            for r in range(40 if hot else 8)]
    sidx = torch.stack([r[2] for r in rows])
    if hot:
        sidx[:, :60] = 3
    sw = torch.stack([r[3] for r in rows])
    spk = torch.stack([r[0] for r in rows])
    ssc = None if not q8 else torch.stack([r[1] for r in rows])
    return sidx, sw, spk, ssc, rows[0][4], rows[0][5]


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "approx"])
@pytest.mark.parametrize("hot", [False, True], ids=["mixed", "hot"])
def test_round_fold_launches_once_and_matches_the_row_by_row_fold(
        cuda, q8, exact, hot):
    """One round fold on the counter and none of the per-batch kernel;
    kernel == plain slot-major == the per-batch kernel run row by row,
    bit for bit on Gaussian payloads; two runs give the same bits."""
    sidx, sw, spk, ssc, acc, cnt = _schedule(0, cuda, q8=q8, hot=hot)
    want = ps.packet_scatter_accum_rounds_plain(sidx, sw, spk, acc, cnt,
                                                sched_scales=ssc,
                                                exact=exact)
    a_row, c_row = acc.clone(), cnt.clone()
    for r in range(sidx.shape[0]):
        _run(spk[r], None if ssc is None else ssc[r], sidx[r], sw[r], a_row,
             c_row, exact, plain=False)
    counters = (ps.packet_scatter_accum_rounds, ps.packet_scatter_accum,
                ps.packet_scatter_accum_q8)
    runs = []
    for _ in range(2):
        before = [f.launches for f in counters]
        a, c = acc.clone(), cnt.clone()
        out = ps.packet_scatter_accum_rounds(sidx, sw, spk, a, c,
                                             sched_scales=ssc, exact=exact)
        assert out[0] is a and out[1] is c
        assert [f.launches - b for f, b in zip(counters, before)] == [1, 0, 0]
        runs.append((a, c))
    torch.cuda.synchronize()
    for a, c in runs + [(a_row, c_row)]:
        assert torch.equal(a, want[0]) and torch.equal(c, want[1])


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "approx"])
def test_drain_kernel_matches_plain_at_the_eager_shape(cuda, q8, exact):
    """The per-drain kernel on one ring of 64 rows at the paper's widths
    (f32: 12,495 slots x 367; q8: 3,133 x 1,464), Gaussian payloads,
    a few slots hit twice: bit for bit."""
    rng = np.random.default_rng(5)
    n_slots, width = (3133, 1464) if q8 else (12495, 367)
    idx = rng.choice(n_slots, 64, replace=False).astype(np.int32)
    idx[1::9] = idx[0::9][:len(idx[1::9])]
    w = rng.integers(1, 4, 64).astype(np.float32)
    w[5] = 0.0
    t = lambda a: torch.from_numpy(a).to(cuda)
    pk = (t(rng.integers(-127, 128, (64, width)).astype(np.int8)) if q8
          else t(rng.normal(size=(64, width)).astype(np.float32)))
    sc = t(rng.uniform(1e-3, 1e-1, 64).astype(np.float32)) if q8 else None
    acc = t(rng.normal(size=(n_slots, width)).astype(np.float32))
    cnt = t(rng.integers(0, 3, n_slots).astype(np.float32))
    want = _run(pk, sc, t(idx), t(w), acc, cnt, exact, plain=True)
    a, c = acc.clone(), cnt.clone()
    _run(pk, sc, t(idx), t(w), a, c, exact, plain=False)
    torch.cuda.synchronize()
    assert torch.equal(a, want[0]) and torch.equal(c, want[1])


def test_wrapper_rejects_mixed_devices_and_dtypes(cuda):
    pk, _, idx, w, acc, cnt = _batch(2, cuda, q8=False, integer=True)
    with pytest.raises(ValueError):
        ps.packet_scatter_accum(pk.cpu(), idx, w, acc, cnt)
    with pytest.raises(TypeError):
        ps.packet_scatter_accum(pk, idx.long(), w, acc, cnt)


@pytest.mark.parametrize("wire", ["f32", "q8"])
@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_round_on_the_card_matches_the_cpu(cuda, wire, mode):
    K, P, Wp = 5, 2000, 64
    rng = np.random.default_rng(3)
    flats = rng.integers(-8, 9, (K, P)).astype(np.float32)
    prev = rng.integers(-8, 9, P).astype(np.float32)
    Np = -(-P // Wp)
    down = (rng.random((K, Np)) > 0.1).astype(np.float32)
    weights = rng.integers(1, 4, K).astype(np.float32)
    if wire == "q8":
        pk = rng.integers(-127, 128, (K, Np, Wp)).astype(np.int8)
        scales = (2.0 ** rng.integers(-4, 1, (K, Np))).astype(np.float32)
    else:
        pk = np.zeros((K, Np * Wp), np.float32)
        pk[:, :P] = flats
        pk, scales = pk.reshape(K, Np, Wp), None
    events, _ = server.make_uplink_stream(rng, pk, loss_rate=0.1,
                                          dup_rate=0.2, scales=scales)
    res = {}
    for dev in ("cpu", cuda):
        for compiled in (False, True):
            cfg = server.EngineConfig(n_clients=K, n_params=P, payload=Wp,
                                      ring_capacity=16, mode=mode,
                                      compile=compiled)
            r = server.run_engine_round(cfg, flats, prev, events,
                                        down_mask=down, weights=weights,
                                        device=dev)
            res[(str(dev), compiled)] = r
    base = res[("cpu", False)]
    for r in res.values():
        for name in ("new_global", "counts", "up_mask", "new_client_flats"):
            assert torch.equal(getattr(r, name).cpu(),
                               getattr(base, name)), name
        assert r.stats == base.stats
    chained = ec.run_compiled_rounds(
        server.EngineConfig(n_clients=K, n_params=P, payload=Wp,
                            ring_capacity=16, mode=mode, compile=True),
        [(events, flats, down)] * 2, prev, weights=weights, device=cuda)
    assert torch.equal(chained[0].new_global.cpu(), base.new_global)


def _accum(seed, dev, kcw, kind, integer):
    K, C, W = kcw
    rng = np.random.default_rng(seed)
    m = ((rng.random((K, C)) > 0.2)
         * rng.integers(1, 4, (K, 1))).astype(np.float32)
    m[:, 0] = 0.0                                # a zero-count row
    t = lambda a: torch.from_numpy(a).to(dev)
    if kind == "int8":
        q = rng.integers(-127, 128, (K, C, W)).astype(np.int8)
        s = ((2.0 ** rng.integers(-6, 0, (K, C))) if integer
             else rng.random((K, C)) / 127).astype(np.float32)
        return (t(q), t(s), t(m))
    x = t((rng.integers(-8, 9, (K, C, W)) if integer
           else rng.normal(size=(K, C, W))).astype(np.float32))
    return (x.to(torch.bfloat16) if kind == "bf16" else x, t(m))


@pytest.mark.parametrize("kcw", [(1, 8, 128), (10, 37, 67), (17, 5, 367)],
                         ids=str)
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("finalize", [True, False], ids=["avg", "raw"])
@pytest.mark.parametrize("integer", [True, False], ids=["int", "gauss"])
def test_accum_kernels_match_plain(cuda, kcw, kind, finalize, integer):
    args = _accum(0, cuda, kcw, kind, integer)
    if kind == "int8":
        kernel, plain = qa.quantized_accum, qa.quantized_accum_plain
    else:
        kernel, plain = fa.fedavg_accum, fa.fedavg_accum_plain
    want = plain(*args, finalize=finalize)
    before = kernel.launches
    got = kernel(*args, finalize=finalize)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    tol = dict(rtol=0, atol=0) if integer else dict(rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[0], want[0], **tol)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    assert not got[0][0].any() and got[1][0] == 0


@pytest.mark.parametrize("integer", [True, False], ids=["int", "gauss"])
def test_fedavg_accum_into_updates_in_place(cuda, integer):
    x, m = _accum(1, cuda, (9, 21, 45), "f32", integer)
    total = torch.randn((21, 45), device=cuda)
    if integer:
        total = total.round()
    counts = torch.ones(21, device=cuda)
    sums, cnts = fa.fedavg_accum_plain(x, m, finalize=False)
    want = (total + sums, counts + cnts)
    t, c = total.clone(), counts.clone()
    before = fa.fedavg_accum.launches
    out = fa.fedavg_accum_into(t, c, x, m)
    torch.cuda.synchronize()
    assert out[0] is t and out[1] is c
    assert fa.fedavg_accum.launches == before + 1
    tol = dict(rtol=0, atol=0) if integer else dict(rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(t, want[0], **tol)
    torch.testing.assert_close(c, want[1], rtol=0, atol=0)


def test_quantize_payload_on_the_card_matches_the_cpu(cuda):
    x = torch.randn((7, 33, 367))
    q, s = quantize_payload(x)
    qc, sc = quantize_payload(x.to(cuda))
    assert torch.equal(qc.cpu(), q) and torch.equal(sc.cpu(), s)


@pytest.mark.parametrize("mode", ["exact", "int8"])
def test_fused_round_step_on_the_card_matches_the_cpu(cuda, mode):
    K, P, Wp = 6, 5000, 367
    rng = np.random.default_rng(4)
    N = -(-P // Wp)
    host = [rng.integers(-8, 9, (K, P)).astype(np.float32),
            (rng.random((K, N)) > 0.1).astype(np.float32),
            (rng.random((K, N)) > 0.1).astype(np.float32),
            rng.integers(-8, 9, P).astype(np.float32),
            rng.integers(1, 4, K).astype(np.float32)]
    counter = fa.fedavg_accum if mode == "exact" else qa.quantized_accum
    outs = []
    for dev in (cuda, torch.device("cpu")):
        before = counter.launches
        args = [torch.from_numpy(a).to(dev) for a in host]
        outs.append([t.cpu() for t in agg.fused_round_step(
            *args[:4], Wp, mode=mode, weights=args[4], mix_alpha=0.25)])
        assert counter.launches == before + (dev.type == "cuda")
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["exact", "int8", "approx"])
def test_run_fedavg_on_the_card(cuda, mode):
    cfg = CNNConfig(image_size=8, conv_channels=(8, 16, 16, 16),
                    fc_hidden=32)
    fns = ModelFns(
        init=lambda g: cnn.init_cnn(g, cfg),
        loss=lambda p, b, g: cnn.cnn_loss(p, b, cfg, dropout_rng=g),
        test_metrics=lambda p, d: {
            "test_loss": cnn.cnn_loss(p, d, cfg, train=False),
            "test_acc": cnn.cnn_accuracy(p, d, cfg)})
    rng = np.random.default_rng(0)
    data = partition_iid(synthetic_image_classification(rng, 256,
                                                        image_size=8), 4)
    test = synthetic_image_classification(rng, 128, image_size=8)
    before = (fa.fedavg_accum.launches, qa.quantized_accum.launches)
    h = run_fedavg(fns, data, test,
                   FedAvgConfig(n_clients=4, rounds=3, batch_size=32,
                                agg_mode=mode, conflict_rate=0.01,
                                uplink_loss=0.05, downlink_loss=0.05))
    rise = (fa.fedavg_accum.launches - before[0],
            qa.quantized_accum.launches - before[1])
    assert rise == {"exact": (3, 0), "int8": (0, 3), "approx": (0, 0)}[mode]
    assert np.isfinite(h["test_loss"]).all()
    assert h["test_loss"][-1] < h["test_loss"][0]


# ---------------------------------------------------------------------------
# The robust finalize (kernel 5) and placement (kernel 6)
# ---------------------------------------------------------------------------

def _table(seed, dev, S, k, width, integer):
    rng = np.random.default_rng(seed)
    tab = (rng.integers(-4, 5, (S, k, width)) if integer
           else rng.normal(size=(S, k, width))).astype(np.float32)
    pres = (rng.random((S, k)) < 0.7).astype(np.float32)
    pres[0] = 0.0
    pres[1] = 1.0
    t = lambda a: torch.from_numpy(a).to(dev)
    return t(tab * pres[:, :, None]), t(pres)


@pytest.mark.parametrize("k", [1, 2, 3, 10, 33])
@pytest.mark.parametrize("median,beta", [(False, 0.2), (True, 0.0),
                                         (False, 0.35)])
@pytest.mark.parametrize("integer", [True, False], ids=["int", "gauss"])
def test_robust_finalize_matches_plain(cuda, k, median, beta, integer):
    """Bitwise on any payload: the kernel and its plain version rank and
    sum in one order (register path up to K=32, global memory above)."""
    tab, pres = _table(k, cuda, 41, k, 67, integer)
    want = ps.robust_finalize_plain(tab, pres, median=median, beta=beta)
    before = ps.robust_finalize.launches
    got = ps.robust_finalize(tab, pres, median=median, beta=beta)
    torch.cuda.synchronize()
    assert ps.robust_finalize.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_robust_finalize_trims_in_f32(cuda):
    """m=180, beta=0.35: the trim depth is floor(f32(180) * f32(0.35)) =
    63 (f64 gives 62)."""
    rng = np.random.default_rng(7)
    tab = rng.integers(-50, 51, (3, 180, 16)).astype(np.float32)
    got, m = ps.robust_finalize(torch.from_numpy(tab).to(cuda),
                                torch.ones((3, 180), device=cuda), beta=0.35)
    want = np.sort(tab, axis=1)[:, 63:117].mean(axis=1)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert (m == 180).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8,
                                   torch.bfloat16])
@pytest.mark.parametrize("with_init", [False, True], ids=["zeros", "init"])
def test_packet_scatter_matches_plain(cuda, dtype, with_init):
    rng = np.random.default_rng(8)
    n, slots, width = 300, 257, 131
    idx = rng.integers(0, slots, n).astype(np.int32)
    idx[:4] = -1
    idx[4] = slots + 2                              # inert
    pk = torch.from_numpy(rng.normal(size=(n, width)).astype(np.float32) * 9)
    pk = pk.to(dtype).to(cuda)
    it = torch.from_numpy(idx).to(cuda)
    init = (torch.from_numpy(rng.normal(size=(slots, width)).astype(
        np.float32)).to(dtype).to(cuda) if with_init else None)
    want = ps.packet_scatter_plain(pk, it, slots, init)
    before = ps.packet_scatter.launches
    buf = None if init is None else init.clone()
    got = ps.packet_scatter(pk, it, slots, buf)
    torch.cuda.synchronize()
    assert ps.packet_scatter.launches == before + 1
    assert buf is None or got is buf
    assert torch.equal(got, want)


@pytest.mark.parametrize("agg", ["trimmed_mean", "median", "norm_clip"])
@pytest.mark.parametrize("wire", ["f32", "q8"])
@pytest.mark.parametrize("integer", [True, False], ids=["int", "gauss"])
def test_robust_round_on_the_card_matches_the_cpu(cuda, agg, wire, integer):
    """Eager and compiled, on the card and on the CPU: one result, bit
    for bit, on any payload (the kernels and their plain versions share
    every order of operations)."""
    K, P, Wp = 5, 2000, 64
    rng = np.random.default_rng(4)
    Np = -(-P // Wp)
    flats = (rng.integers(-8, 9, (K, P)) if integer
             else rng.normal(size=(K, P))).astype(np.float32)
    prev = rng.integers(-8, 9, P).astype(np.float32)
    down = (rng.random((K, Np)) > 0.1).astype(np.float32)
    weights = rng.integers(1, 4, K).astype(np.float32)
    if wire == "q8":
        pk = rng.integers(-127, 128, (K, Np, Wp)).astype(np.int8)
        scales = ((2.0 ** rng.integers(-4, 1, (K, Np))) if integer
                  else rng.uniform(1e-3, 1e-1, (K, Np))).astype(np.float32)
    else:
        pk = np.zeros((K, Np * Wp), np.float32)
        pk[:, :P] = flats
        pk, scales = pk.reshape(K, Np, Wp), None
    events, _ = server.make_uplink_stream(rng, pk, loss_rate=0.1,
                                          dup_rate=0.2, scales=scales)
    res = {}
    before = ps.robust_finalize.launches
    for dev in ("cpu", cuda):
        for compiled in (False, True):
            cfg = server.EngineConfig(n_clients=K, n_params=P, payload=Wp,
                                      ring_capacity=16, compile=compiled,
                                      agg_mode=agg, trim_beta=0.2,
                                      clip_tau=20.0)
            res[(str(dev), compiled)] = server.run_engine_round(
                cfg, flats, prev, events, down_mask=down, weights=weights,
                device=dev)
    torch.cuda.synchronize()
    table_modes = agg != "norm_clip"
    assert ps.robust_finalize.launches == before + 2 * table_modes
    base = res[("cpu", False)]
    for r in res.values():
        for name in ("new_global", "counts", "up_mask", "new_client_flats"):
            assert torch.equal(getattr(r, name).cpu(),
                               getattr(base, name)), name
        assert r.stats == base.stats


def test_attack_driver_on_the_card_matches_the_cpu(cuda):
    K, P, Wp = 6, 480, 48
    rng = np.random.default_rng(7)
    flats = rng.integers(-4, 5, (K, P)).astype(np.float32)
    churn = rounds.ChurnConfig(participation=0.9, straggle_rate=0.15,
                               loss_rate=0.1, dup_rate=0.05)
    att = rounds.AttackConfig("scale", n_attackers=1, boost=1e4)
    cfg = server.EngineConfig(n_clients=K, n_params=P, payload=Wp,
                              ring_capacity=7, compile=True,
                              agg_mode="trimmed_mean", trim_beta=0.25,
                              min_clients=1)
    hists = [rounds.run_churn_rounds(cfg, churn, flats,
                                     np.zeros(P, np.float32), 3,
                                     rng=np.random.default_rng(11),
                                     attack=att, device=dev)
             for dev in ("cpu", cuda)]
    for a, b in zip(hists[0].results, hists[1].results):
        assert torch.equal(a.new_global, b.new_global.cpu())
        assert torch.equal(a.counts, b.counts.cpu())
    err = np.abs(hists[1].final_global.cpu().numpy()
                 - flats.mean(axis=0)).max()
    assert err < 20.0
