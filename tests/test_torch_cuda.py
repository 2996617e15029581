"""The hand-written CUDA kernels against their plain PyTorch versions,
on the card.  Marked ``gpu``: without a CUDA device every test skips
(the decision is made in a fixture, so every worker collects the same
tests).  Run on a GPU machine with

    python -m pytest -q -m gpu tests/test_torch_cuda.py

The machine with the card has no JAX, so this file imports only the
port; the JAX package is held against the plain versions on the CPU
(test_torch_packet_scatter.py, test_torch_server.py).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import engine_compiled as ec
from repro_torch.core import server
from repro_torch.kernels import packet_scatter as ps

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
    tol = dict(rtol=0, atol=0) if integer else dict(rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(a, want[0], **tol)
    torch.testing.assert_close(c, want[1], rtol=0, atol=0)


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
def test_all_padding_batch_is_inert(cuda, q8):
    pk, sc, idx, w, acc, cnt = _batch(1, cuda, q8=q8, integer=True)
    idx.fill_(-1)
    a, c = acc.clone(), cnt.clone()
    _run(pk, sc, idx, w, a, c, True, plain=False)
    torch.cuda.synchronize()
    assert torch.equal(a, acc) and torch.equal(c, cnt)


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
def test_rounds_launch_once_per_row_and_match_plain(cuda, q8):
    rows = [_batch(10 + r, cuda, q8=q8, integer=True) for r in range(6)]
    sidx = torch.stack([r[2] for r in rows])
    sw = torch.stack([r[3] for r in rows])
    spk = torch.stack([r[0] for r in rows])
    ssc = None if not q8 else torch.stack([r[1] for r in rows])
    acc, cnt = rows[0][4].clone(), rows[0][5].clone()
    a_ref, c_ref = acc.clone(), cnt.clone()
    for r in range(6):
        a_ref, c_ref = _run(spk[r], None if ssc is None else ssc[r],
                            sidx[r], sw[r], a_ref, c_ref, True, plain=True)
    counter = ps.packet_scatter_accum_q8 if q8 else ps.packet_scatter_accum
    before = counter.launches
    ps.packet_scatter_accum_rounds(sidx, sw, spk, acc, cnt,
                                   sched_scales=ssc)
    torch.cuda.synchronize()
    assert counter.launches == before + 6
    assert torch.equal(acc, a_ref) and torch.equal(cnt, c_ref)


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
