"""The port's Byzantine-robust round (DESIGN.md §11) and its two kernels'
plain versions, held against the JAX package on the same seeded numpy
inputs.

- ``robust_finalize_plain`` against ``robust_finalize_pallas``
  (interpret mode) and ``robust_finalize_jnp``: bitwise on integer
  tables, where every sum is exact (the Pallas body sums in client
  order, the jnp twin in sorted order, the port in client order);
  rtol 1e-5 on Gaussian tables.
- ``norm_clip_weights``, ``packet_table_scatter`` and
  ``packet_scatter_plain`` against their reference functions.
- The engine cells of tests/test_robust_agg.py that run unsharded:
  port eager == port compiled bit for bit, and port == JAX bitwise on
  integer payloads (power-of-two q8 scales).  ``norm_clip`` scales each
  packet's weight by a factor that is not exact, so there the fold's
  order of additions matters: port == JAX to rtol 1e-5 (eager ==
  compiled stays bitwise in each package).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_shim import given, settings, st

from repro.core import protocol as ref_protocol
from repro.core import rounds as ref_rounds
from repro.core import server as ref
from repro.core.packets import packetize as ref_packetize
from repro.kernels import ops as ref_ops
from repro.kernels import packet_scatter as ref_ps
from repro_torch.core import engine_compiled as ec
from repro_torch.core import rounds
from repro_torch.core import server as port
from repro_torch.core.packets import packetize
from repro_torch.kernels import ops
from repro_torch.kernels import packet_scatter as ps

K, P, W = 6, 480, 48
N = P // W
MODES = ["mean", "trimmed_mean", "median", "norm_clip"]
ROBUST = ["trimmed_mean", "median", "norm_clip"]


# ---------------------------------------------------------------------------
# Kernel 5: robust_finalize
# ---------------------------------------------------------------------------

def _table(seed, S, k, width, *, integer=True, p_present=0.7):
    """A client table with absent entries (zeroed), ties (integers in a
    narrow range), a slot where every client is absent (slot 0) and one
    where every client is present (slot 1)."""
    rng = np.random.default_rng(seed)
    tab = (rng.integers(-4, 5, (S, k, width)) if integer
           else rng.normal(size=(S, k, width))).astype(np.float32)
    pres = (rng.random((S, k)) < p_present).astype(np.float32)
    pres[0] = 0.0
    pres[1] = 1.0
    return tab * pres[:, :, None], pres


FINALIZE_CASES = [(False, 0.2), (True, 0.0), (False, 0.45), (False, 0.0)]


@pytest.mark.parametrize("k", [1, 2, 3, 10])
@pytest.mark.parametrize("median,beta", FINALIZE_CASES)
def test_robust_finalize_plain_bitwise_on_integer_tables(k, median, beta):
    tab, pres = _table(k, 16, k, 24)
    agg, m = ps.robust_finalize_plain(torch.from_numpy(tab),
                                      torch.from_numpy(pres), median=median,
                                      beta=beta)
    aj, mj = ref_ps.robust_finalize_jnp(jnp.asarray(tab), jnp.asarray(pres),
                                        median=median, beta=beta)
    ap, mp = ref_ps.robust_finalize_pallas(jnp.asarray(tab),
                                           jnp.asarray(pres), median=median,
                                           beta=beta, interpret=True)
    for a, mm in ((aj, mj), (ap, mp)):
        np.testing.assert_array_equal(agg.numpy(), np.asarray(a))
        np.testing.assert_array_equal(m.numpy(), np.asarray(mm))
    assert (agg[0] == 0).all() and m[0] == 0       # nobody delivered


@pytest.mark.parametrize("k", [1, 2, 3, 10])
@pytest.mark.parametrize("median,beta", FINALIZE_CASES[:2])
def test_robust_finalize_plain_gaussian_within_rtol(k, median, beta):
    tab, pres = _table(100 + k, 16, k, 24, integer=False)
    agg, _ = ps.robust_finalize_plain(torch.from_numpy(tab),
                                      torch.from_numpy(pres), median=median,
                                      beta=beta)
    for fn in (ref_ps.robust_finalize_jnp,
               lambda *a, **kw: ref_ps.robust_finalize_pallas(
                   *a, interpret=True, **kw)):
        want, _ = fn(jnp.asarray(tab), jnp.asarray(pres), median=median,
                     beta=beta)
        np.testing.assert_allclose(agg.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def test_trim_depth_is_f32_arithmetic():
    """beta=0.35, m=180: floor(f32(180) * f32(0.35)) = 63, while the same
    product in f64 floors to 62.  The finalize must trim 63 per side."""
    assert np.floor(180 * 0.35) == 62.0
    t = ps._robust_trim(torch.tensor([180.0]), median=False, beta=0.35)
    assert float(t[0]) == 63.0
    want = ref_ps._robust_trim(jnp.asarray([180.0]), median=False, beta=0.35)
    assert float(want[0]) == 63.0
    rng = np.random.default_rng(5)
    tab = rng.integers(-50, 51, (2, 180, 8)).astype(np.float32)
    pres = np.ones((2, 180), np.float32)
    agg, m = ps.robust_finalize_plain(torch.from_numpy(tab),
                                      torch.from_numpy(pres), beta=0.35)
    ap, _ = ref_ps.robust_finalize_pallas(jnp.asarray(tab), jnp.asarray(pres),
                                          beta=0.35, block_slots=2,
                                          interpret=True)
    np.testing.assert_array_equal(agg.numpy(), np.asarray(ap))
    srt = np.sort(tab, axis=1)[:, 63:180 - 63]
    np.testing.assert_array_equal(agg.numpy(), srt.mean(axis=1))


def test_robust_finalize_sentinel_valued_entry_ranks_like_reference():
    """A present value equal to the FLT_MAX sentinel ranks against the
    absent entries as the Pallas body ranks it, ties by client order."""
    big = np.finfo(np.float32).max
    tab = np.zeros((8, 5, 4), np.float32)
    pres = np.zeros((8, 5), np.float32)
    tab[:, 1] = big
    tab[:, 3] = 2.0
    tab[:, 4] = -1.0
    pres[:, [1, 3, 4]] = 1.0
    pres[4:, 0] = 1.0                    # a present 0 before the sentinel
    for median, beta in FINALIZE_CASES:
        agg, m = ps.robust_finalize_plain(torch.from_numpy(tab),
                                          torch.from_numpy(pres),
                                          median=median, beta=beta)
        ap, mp = ref_ps.robust_finalize_pallas(
            jnp.asarray(tab), jnp.asarray(pres), median=median, beta=beta,
            interpret=True)
        np.testing.assert_array_equal(agg.numpy(), np.asarray(ap))
        np.testing.assert_array_equal(m.numpy(), np.asarray(mp))


def test_robust_finalize_wrappers_on_cpu_run_the_plain_version():
    tab, pres = _table(7, 8, 4, 16, integer=False)
    before = ps.robust_finalize.launches
    a, m = ops.robust_finalize(torch.from_numpy(tab).double(),
                               torch.from_numpy(pres), median=True)
    b, mb = ps.robust_finalize_plain(torch.from_numpy(tab),
                                     torch.from_numpy(pres), median=True)
    assert torch.equal(a, b) and torch.equal(m, mb)
    assert ps.robust_finalize.launches == before      # no kernel on CPU
    with pytest.raises(TypeError):
        ps.robust_finalize(torch.from_numpy(tab).double(),
                           torch.from_numpy(pres))
    with pytest.raises(ValueError):
        ps.robust_finalize(torch.from_numpy(tab), torch.ones(8, 5))


# ---------------------------------------------------------------------------
# norm clip and the table fold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("integer", [True, False], ids=["int", "gauss"])
@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
def test_norm_clip_weights_matches_reference(integer, q8):
    rng = np.random.default_rng(11)
    if q8:
        rows = rng.integers(-127, 128, (5, 7, 33)).astype(np.int8)
        sc = ((2.0 ** rng.integers(-6, -1, (5, 7))) if integer
              else rng.uniform(1e-3, 1e-1, (5, 7))).astype(np.float32)
    else:
        rows = (rng.integers(-8, 9, (5, 7, 33)) if integer
                else rng.normal(size=(5, 7, 33))).astype(np.float32)
        sc = None
    w = rng.integers(1, 4, (5, 7)).astype(np.float32)
    w[0, 0] = 0.0                                   # inert padding
    decoded = rows.astype(np.float32) * (1.0 if sc is None else sc[..., None])
    tau = float(np.median(np.linalg.norm(decoded, axis=-1)))
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = ps.norm_clip_weights(t(w), t(rows), tau=tau, scales=t(sc))
    want = ref_ps.norm_clip_weights(
        jnp.asarray(w), jnp.asarray(rows), tau=tau,
        scales=None if sc is None else jnp.asarray(sc))
    assert got.dtype == torch.float32 and got[0, 0] == 0.0
    if integer:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    assert (got < t(w)).any()                       # the clip was active


def test_norm_clip_root_is_correctly_rounded():
    """The clip's norm takes the IEEE square root on either device;
    torch's CPU sqrt is off by an ulp for some inputs (15698.1875 among
    them, seen against the card), numpy's and XLA's are not."""
    rng = np.random.default_rng(14)
    x = np.concatenate([rng.random(100_000) * 1e6,
                        rng.integers(0, 1 << 20, 100_000),
                        [0.0, 15698.1875, 1e-40, 4.0, 3.4e38]]
                       ).astype(np.float32)
    np.testing.assert_array_equal(ps._sqrt_rn(torch.from_numpy(x)).numpy(),
                                  np.sqrt(x))
    normal = x[(x == 0) | (x >= np.finfo(np.float32).tiny)]  # XLA: FTZ
    np.testing.assert_array_equal(
        ps._sqrt_rn(torch.from_numpy(normal)).numpy(),
        np.asarray(jnp.sqrt(jnp.asarray(normal))))


def test_norm_clip_weights_one_row_gives_the_same_bits_in_any_shape():
    """The eager engine clips (B, W) drain batches, the compiled one
    (R, B, W) schedules: a row's factor must not depend on which."""
    rng = np.random.default_rng(12)
    rows = torch.from_numpy(rng.normal(size=(9, 64, 367)).astype(np.float32))
    w = torch.from_numpy(rng.random((9, 64)).astype(np.float32))
    whole = ps.norm_clip_weights(w, rows, tau=3.0)
    for r in range(9):
        assert torch.equal(ps.norm_clip_weights(w[r], rows[r], tau=3.0),
                           whole[r])
        assert torch.equal(ps.norm_clip_weights(w[r, :5], rows[r, :5],
                                                tau=3.0), whole[r, :5])


def test_norm_clip_weights_identity_inside_ball():
    rng = np.random.default_rng(4)
    rows = rng.normal(size=(32, W)).astype(np.float32)
    nrm = np.linalg.norm(rows, axis=1)
    w = rng.random(32).astype(np.float32)
    out = ps.norm_clip_weights(torch.from_numpy(w), torch.from_numpy(rows),
                               tau=float(nrm.max()) * 2.0)
    np.testing.assert_array_equal(out.numpy(), w)


@pytest.mark.parametrize("integer", [True, False], ids=["int", "gauss"])
@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
def test_packet_table_scatter_matches_reference(integer, q8):
    """A unique-index schedule with -1 padding: every row lands as
    0 + w*payload, so the fold is bitwise on any payload."""
    rng = np.random.default_rng(13)
    R, B, SK, width = 4, 16, 90, 12
    idx = np.full((R, B), -1, np.int32)
    real = rng.random((R, B)) < 0.8
    idx[real] = rng.permutation(SK)[:int(real.sum())]
    w = real.astype(np.float32)
    if q8:
        pk = rng.integers(-127, 128, (R, B, width)).astype(np.int8)
        sc = rng.uniform(1e-3, 1e-1, (R, B)).astype(np.float32)
    else:
        pk = (rng.integers(-8, 9, (R, B, width)) if integer
              else rng.normal(size=(R, B, width))).astype(np.float32)
        sc = None
    acc, cnt = torch.zeros((SK, width)), torch.zeros(SK)
    t = lambda a: None if a is None else torch.from_numpy(a)
    out = ps.packet_table_scatter(t(idx), t(w), t(pk), acc, cnt,
                                  sched_scales=t(sc))
    assert out[0] is acc and out[1] is cnt           # in place
    ra, rc = ref_ps.packet_table_scatter(
        jnp.asarray(idx), jnp.asarray(w), jnp.asarray(pk),
        jnp.zeros((SK + 1, width)), jnp.zeros((SK + 1, 1)),
        sched_scales=None if sc is None else jnp.asarray(sc))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(ra)[:SK])
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(rc)[:SK, 0])


# ---------------------------------------------------------------------------
# Kernel 6: placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,slots,w", [(8, 8, 128), (16, 24, 256),
                                       (1, 4, 128), (32, 32, 512)])
def test_packet_scatter_plain_matches_reference(n, slots, w):
    rng = np.random.default_rng(n * slots)
    pkts = rng.normal(size=(n, w)).astype(np.float32)
    idx = rng.permutation(slots)[:n].astype(np.int32)
    got = ps.packet_scatter_plain(torch.from_numpy(pkts),
                                  torch.from_numpy(idx), slots)
    want = ref_ops.packet_scatter(jnp.asarray(pkts), jnp.asarray(idx), slots)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_packet_scatter_uncovered_rows_keep_init_in_place():
    rng = np.random.default_rng(1)
    pkts = rng.normal(size=(3, 128)).astype(np.float32)
    init = rng.normal(size=(8, 128)).astype(np.float32)
    idx = np.asarray([6, 0, 3], np.int32)
    want = np.asarray(ref_ops.packet_scatter(
        jnp.asarray(pkts), jnp.asarray(idx), 8, jnp.asarray(init)))
    buf = torch.from_numpy(init.copy())
    out = ops.packet_scatter(torch.from_numpy(pkts), torch.from_numpy(idx), 8,
                             buf)
    assert out is buf                                 # the aliased buffer
    np.testing.assert_array_equal(buf.numpy(), want)
    np.testing.assert_array_equal(buf.numpy()[[1, 2, 4, 5, 7]],
                                  init[[1, 2, 4, 5, 7]])
    plain = ps.packet_scatter_plain(torch.from_numpy(pkts),
                                    torch.from_numpy(idx), 8,
                                    torch.from_numpy(init))
    np.testing.assert_array_equal(plain.numpy(), want)


def test_packet_scatter_without_init_zero_fills():
    rng = np.random.default_rng(2)
    pkts = rng.normal(size=(2, 128)).astype(np.float32)
    out = ops.packet_scatter(torch.from_numpy(pkts), torch.tensor([1, 3]), 5)
    want = np.asarray(ref_ops.packet_scatter(jnp.asarray(pkts),
                                             jnp.asarray([1, 3]), 5))
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(out.numpy()[[0, 2, 4]], 0.0)


def test_packet_scatter_duplicate_idx_last_writer_wins():
    rng = np.random.default_rng(3)
    pkts = rng.normal(size=(6, 128)).astype(np.float32)
    idx = np.asarray([2, 5, 2, 2, 7, 5], np.int32)
    init = rng.normal(size=(8, 128)).astype(np.float32)
    got = ps.packet_scatter_plain(torch.from_numpy(pkts),
                                  torch.from_numpy(idx), 8,
                                  torch.from_numpy(init))
    want = ref_ops.packet_scatter(jnp.asarray(pkts), jnp.asarray(idx), 8,
                                  jnp.asarray(init))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[2], pkts[3])
    np.testing.assert_array_equal(got.numpy()[5], pkts[5])


def test_packet_scatter_out_of_range_idx_is_inert_and_any_dtype_places():
    """idx < 0 and idx >= n_slots are inert in the port (the reference
    leaves them undefined); rows are placed as bit patterns."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.integers(-127, 128, (5, 9)).astype(np.int8))
    idx = torch.tensor([3, -1, 9, 0, 3], dtype=torch.int32)
    init = torch.full((4, 9), 7, dtype=torch.int8)
    out = ps.packet_scatter(q, idx, 4, init.clone())
    want = init.clone()
    want[0], want[3] = q[3], q[4]
    assert torch.equal(out, want)
    before = ps.packet_scatter.launches
    ps.packet_scatter(q.double(), idx, 4)
    assert ps.packet_scatter.launches == before       # no kernel on CPU
    with pytest.raises(TypeError):
        ps.packet_scatter(q, idx.long(), 4)
    with pytest.raises(TypeError):
        ps.packet_scatter(q, idx, 4, init.float())


# ---------------------------------------------------------------------------
# Engine cells: port eager == port compiled, port == JAX
# ---------------------------------------------------------------------------

def _inputs(seed, *, integer=True):
    rng = np.random.default_rng(seed)
    flats = (rng.integers(-8, 9, (K, P)) if integer
             else rng.normal(size=(K, P))).astype(np.float32)
    prev = rng.integers(-8, 9, P).astype(np.float32)
    pk = np.asarray(jax.vmap(lambda f: ref_packetize(f, W))(
        jnp.asarray(flats)))
    return rng, flats, prev, pk


def _to_ref(events):
    """A port event stream as the JAX package's ``Packet``s."""
    return [(ref_protocol.Packet(**{**dataclasses.asdict(p),
                                    "kind": ref_protocol.Kind[p.kind.name]}),
             x) for p, x in events]


def _mixed(events):
    """Re-encode every other DATA packet of a q8 stream as f32 (the
    decoded row): both wires on one socket."""
    out = []
    for i, (p, pay) in enumerate(events):
        if p.kind.name == "DATA" and i % 2:
            pay = pay.astype(np.float32) * np.float32(p.scale)
            p = dataclasses.replace(p, wire_dtype="f32", scale=1.0)
        out.append((p, pay))
    return out


def _streams(seed, wire, *, loss=0.3, dup=0.3):
    """One round's stream through both packages' make_uplink_stream
    (the same draws) on integer payloads; q8 rows are int8 with
    power-of-two scales, so every decoded value is exact."""
    rng, flats, prev, pk = _inputs(seed)
    weights = rng.integers(1, 4, K).astype(np.float32)
    down = (rng.random((K, N)) > 0.2).astype(np.float32)
    scales = None
    if wire != "f32":
        pk = rng.integers(-127, 128, pk.shape).astype(np.int8)
        scales = (2.0 ** rng.integers(-4, 1, pk.shape[:2])).astype(
            np.float32)
    ev_ref, _ = ref.make_uplink_stream(np.random.default_rng(seed + 1), pk,
                                       loss_rate=loss, dup_rate=dup,
                                       scales=scales)
    ev, _ = port.make_uplink_stream(np.random.default_rng(seed + 1), pk,
                                    loss_rate=loss, dup_rate=dup,
                                    scales=scales)
    if wire == "mixed":
        ev_ref, ev = _mixed(ev_ref), _mixed(ev)
    return dict(flats=flats, prev=prev, weights=weights, down=down,
                ev_ref=ev_ref, ev=ev)


def _kw(agg, **extra):
    kw = dict(n_clients=K, n_params=P, payload=W, ring_capacity=7,
              agg_mode=agg, trim_beta=0.2, clip_tau=5.0)
    kw.update(extra)
    return kw


def _port_round(s, **kw):
    return port.run_engine_round(port.EngineConfig(**kw), s["flats"],
                                 s["prev"], s["ev"], down_mask=s["down"],
                                 weights=s["weights"], device="cpu")


def _ref_round(s, **kw):
    return ref.run_engine_round(ref.EngineConfig(**kw), s["flats"],
                                s["prev"], s["ev_ref"], down_mask=s["down"],
                                weights=s["weights"])


def _assert_same(a, b):
    """Port round == port round, bit for bit."""
    for name in ("new_global", "counts", "up_mask", "new_client_flats"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None and y is None) or torch.equal(x, y), name
    assert a.stats == b.stats


def _assert_matches_ref(got, want, *, exact=True):
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    np.testing.assert_array_equal(got.up_mask.numpy(),
                                  np.asarray(want.up_mask))
    pairs = [(got.counts, want.counts), (got.new_global, want.new_global),
             (got.new_client_flats, want.new_client_flats)]
    for g, w in pairs:
        if exact:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("agg", MODES)
@pytest.mark.parametrize("assign", ["rr", "slot"])
@pytest.mark.parametrize("wire", ["f32", "q8", "mixed"])
@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_robust_round_eager_compiled_and_reference(agg, assign, wire, mode):
    s = _streams(42, wire)
    kw = _kw(agg, ring_assign=assign, mode=mode)
    eager = _port_round(s, **kw)
    comp = _port_round(s, compile=True, **kw)
    _assert_same(eager, comp)
    want = _ref_round(s, compile=True, **kw)
    _assert_matches_ref(comp, want, exact=(agg != "norm_clip"))
    assert comp.stats.duplicates_dropped > 0


@pytest.mark.parametrize("agg", ["trimmed_mean", "median"])
def test_table_modes_eager_equals_compiled_on_gaussian(agg):
    """Each (slot, client) row is written once, and both engines run one
    finalize: bitwise on any payload, not only integer ones."""
    rng, flats, prev, pk = _inputs(9, integer=False)
    events, _ = port.make_uplink_stream(rng, pk, loss_rate=0.25,
                                        dup_rate=0.2)
    res = [port.run_engine_round(port.EngineConfig(compile=c, **_kw(agg)),
                                 flats, prev, events, device="cpu")
           for c in (False, True)]
    _assert_same(res[0], res[1])


def test_norm_clip_eager_equals_compiled_on_gaussian():
    """The per-packet norm is summed in one fixed order, so the eager
    drains and the compiled schedule clip to the same bits."""
    rng, flats, prev, pk = _inputs(10, integer=False)
    events, _ = port.make_uplink_stream(rng, pk, loss_rate=0.2, dup_rate=0.2)
    kw = _kw("norm_clip", clip_tau=2.0, ring_capacity=5)
    a, b = (port.run_engine_round(port.EngineConfig(compile=c, **kw), flats,
                                  prev, events, device="cpu")
            for c in (False, True))
    assert torch.equal(a.new_global, b.new_global)
    assert torch.equal(a.counts, b.counts)


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 2**16), loss=st.floats(0.0, 0.6),
       dup=st.floats(0.0, 0.5), agg=st.sampled_from(ROBUST))
def test_robust_matches_eager_any_pattern(seed, loss, dup, agg):
    """Property: ANY loss/dup pattern, the robust modes stay bitwise
    between the port's engines, and with the JAX package."""
    s = _streams(seed, "f32", loss=loss, dup=dup)
    kw = _kw(agg)
    eager = _port_round(s, **kw)
    comp = _port_round(s, compile=True, **kw)
    _assert_same(eager, comp)
    _assert_matches_ref(comp, _ref_round(s, **kw),
                        exact=(agg != "norm_clip"))


@pytest.mark.parametrize("agg", ROBUST)
def test_per_packet_compile_api_matches_bulk(agg):
    """ServerEngine(compile=True) records the client of each pending
    packet; its robust round equals the bulk demux and the eager one."""
    rng, flats, prev, pk = _inputs(23)
    events, _ = port.make_uplink_stream(rng, pk, loss_rate=0.2, dup_rate=0.2)
    eager_e = port.ServerEngine(port.EngineConfig(**_kw(agg)), device="cpu")
    comp_e = port.ServerEngine(port.EngineConfig(compile=True, **_kw(agg)),
                               device="cpu")
    ref_e = ref.ServerEngine(ref.EngineConfig(**_kw(agg)))
    for (packet, payload), (ref_packet, _) in zip(events, _to_ref(events)):
        eager_e.rx(packet, payload)
        comp_e.rx(packet, payload)
        ref_e.rx(ref_packet, payload)
    ge, ce = eager_e.finalize_round(prev)
    gc, cc = comp_e.finalize_round(prev)
    gr, cr = ref_e.finalize_round(jnp.asarray(prev))
    assert torch.equal(ge, gc) and torch.equal(ce, cc)
    bulk = port.run_engine_round(port.EngineConfig(compile=True, **_kw(agg)),
                                 flats, prev, events, device="cpu")
    assert torch.equal(ge, bulk.new_global)
    if agg == "norm_clip":
        np.testing.assert_allclose(ge.numpy(), np.asarray(gr), rtol=1e-5,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(ge.numpy(), np.asarray(gr))
    np.testing.assert_array_equal(ce.numpy(), np.asarray(cr))
    # the eager table is cleared for the next round
    assert eager_e._tab is None or not eager_e._tab.any()


@pytest.mark.parametrize("agg", ["trimmed_mean", "median"])
def test_eager_table_modes_fold_nothing_into_the_mean_accumulator(agg):
    """The eager table modes drain their rings only for the stats: the
    finalize reads the client table, so no batch is folded into the
    mean accumulator (on the card: no scatter launch that the result
    would discard), and the drains still count as the compiled ones."""
    rng, flats, prev, pk = _inputs(31)
    events, _ = port.make_uplink_stream(rng, pk, loss_rate=0.2, dup_rate=0.2)
    eng = port.ServerEngine(port.EngineConfig(**_kw(agg)), device="cpu")
    for packet, payload in events:
        eng.rx(packet, payload)
    eng.finalize_round(prev)
    comp = port.run_engine_round(port.EngineConfig(compile=True, **_kw(agg)),
                                 flats, prev, events, device="cpu")
    assert eng.stats.batches_drained == comp.stats.batches_drained > 0
    assert not eng.agg.total.any() and not eng.agg.counts.any()


def test_schedule_carries_the_clients_column_like_reference():
    s = _streams(24, "q8")
    kw = _kw("median")
    sched, _, _ = ec.demux_events(port.EngineConfig(**kw), s["ev"],
                                  s["weights"])
    from repro.core import engine_compiled as ref_ec
    sched_r, _, _ = ref_ec.demux_events(ref.EngineConfig(**kw), s["ev_ref"],
                                        s["weights"])
    np.testing.assert_array_equal(sched.clients, sched_r.clients)
    a = ec._combined_table_sched(sched, K)
    b = ref_ec._combined_table_sched(sched_r, K)
    np.testing.assert_array_equal(a.idx, b.idx)
    np.testing.assert_array_equal(a.weights, b.weights)
    with pytest.raises(ValueError, match="client-tracked"):
        ec._combined_table_sched(dataclasses.replace(sched, clients=None), K)


# ---------------------------------------------------------------------------
# Oracles: the finalize is numpy's median / trimmed mean on a full round
# ---------------------------------------------------------------------------

def test_median_equals_numpy_on_full_round():
    k = 5
    rng = np.random.default_rng(0)
    flats = rng.normal(size=(k, P)).astype(np.float32)
    pk = packetize(torch.from_numpy(flats), W)
    events, _ = port.make_uplink_stream(rng, pk)
    cfg = port.EngineConfig(n_clients=k, n_params=P, payload=W,
                            ring_capacity=7, agg_mode="median")
    res = port.run_engine_round(cfg, flats, np.zeros(P, np.float32), events,
                                device="cpu")
    np.testing.assert_allclose(res.new_global.numpy(),
                               np.median(flats, axis=0), rtol=0, atol=0)


def test_trimmed_mean_equals_numpy_on_full_round():
    rng = np.random.default_rng(1)
    flats = rng.normal(size=(K, P)).astype(np.float32)
    pk = packetize(torch.from_numpy(flats), W)
    events, _ = port.make_uplink_stream(rng, pk)
    cfg = port.EngineConfig(n_clients=K, n_params=P, payload=W,
                            ring_capacity=7, agg_mode="trimmed_mean",
                            trim_beta=0.2)            # t = floor(1.2) = 1
    res = port.run_engine_round(cfg, flats, np.zeros(P, np.float32), events,
                                device="cpu")
    want = np.sort(flats, axis=0)[1:-1].mean(axis=0)
    np.testing.assert_allclose(res.new_global.numpy(), want, rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# Config validation
# ---------------------------------------------------------------------------

def _cfg(agg, **kw):
    return port.EngineConfig(**_kw(agg, **kw))


def test_agg_mode_validation():
    with pytest.raises(ValueError, match="agg_mode"):
        _cfg("krum")
    with pytest.raises(ValueError, match="trim_beta"):
        _cfg("trimmed_mean", trim_beta=0.5)
    with pytest.raises(ValueError, match="trim_beta"):
        _cfg("trimmed_mean", trim_beta=-0.1)
    with pytest.raises(ValueError, match="clip_tau"):
        _cfg("norm_clip", clip_tau=0.0)
    with pytest.raises(ValueError, match="async"):
        _cfg("trimmed_mean", buffer_size=3)
    with pytest.raises(ValueError, match="async"):
        _cfg("median", buffer_size=3)
    # norm_clip composes with the async mode, which is not ported yet
    with pytest.raises(NotImplementedError, match="not yet ported"):
        _cfg("norm_clip", buffer_size=3)
    for agg in MODES:
        assert _cfg(agg).agg_mode == agg


# ---------------------------------------------------------------------------
# Byzantine bounds: f attackers below breakdown cannot escape; mean breaks
# ---------------------------------------------------------------------------

BIG = 1.0e6


def _attacked_round(seed, agg, *, f, boost=BIG, beta=0.3, tau=5.0,
                    loss=0.25, dup=0.15):
    """One lossy/dup round with f boosted attackers through the port ->
    (finalized (N, W) grid, presence (K, N), honest packets, attackers);
    the same round through the JAX package must agree."""
    rng = np.random.default_rng(seed)
    flats = rng.integers(-8, 9, (K, P)).astype(np.float32)
    pk = packetize(torch.from_numpy(flats), W).numpy()
    att = rounds.AttackConfig(model="scale", n_attackers=f, boost=boost)
    pk_att = rounds.apply_attack(rng, pk, att)
    events, _ = port.make_uplink_stream(rng, pk_att, loss_rate=loss,
                                        dup_rate=dup)
    kw = dict(n_clients=K, n_params=P, payload=W, ring_capacity=7,
              agg_mode=agg, trim_beta=beta, clip_tau=tau, compile=True)
    zeros = np.zeros(P, np.float32)
    res = port.run_engine_round(port.EngineConfig(**kw), flats, zeros,
                                events, device="cpu")
    want = ref.run_engine_round(ref.EngineConfig(**kw), flats, zeros,
                                _to_ref(events))
    if agg == "norm_clip":
        np.testing.assert_allclose(res.new_global.numpy(),
                                   np.asarray(want.new_global), rtol=1e-5,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(res.new_global.numpy(),
                                      np.asarray(want.new_global))
    grid = packetize(res.new_global, W).numpy()
    return grid, res.up_mask.numpy(), pk, att.mask(K)


@pytest.mark.parametrize("agg", ["trimmed_mean", "median"])
def test_rank_modes_stay_in_honest_envelope(agg):
    f = 2 if agg == "median" else 1
    beta = 0.3
    checked = 0
    for seed in range(3):
        grid, up, pk, att_mask = _attacked_round(seed, agg, f=f, beta=beta)
        for s in range(N):
            present = up[:, s] > 0
            m = int(present.sum())
            if m == 0:
                continue
            f_s = int((present & att_mask).sum())
            t_s = ((m - 1) // 2 if agg == "median"
                   else int(np.floor(np.float32(beta) * np.float32(m))))
            honest = pk[present & ~att_mask, s]
            if f_s > t_s or honest.shape[0] == 0:
                continue                  # above breakdown: no guarantee
            checked += 1
            lo, hi = honest.min(axis=0), honest.max(axis=0)
            assert (grid[s] >= lo - 1e-4).all(), (agg, seed, s)
            assert (grid[s] <= hi + 1e-4).all(), (agg, seed, s)
    assert checked > 10


def test_norm_clip_bounds_attacker_influence():
    tau = 5.0
    checked = 0
    for seed in range(3):
        grid, up, pk, att_mask = _attacked_round(seed, "norm_clip", f=2,
                                                 tau=tau)
        for s in range(N):
            present = up[:, s] > 0
            m = int(present.sum())
            honest = pk[present & ~att_mask, s]
            if m == 0 or honest.shape[0] == 0:
                continue
            checked += 1
            hn = np.linalg.norm(honest, axis=1)
            denom = np.minimum(1.0, tau / np.maximum(hn, 1e-30)).sum()
            bound = tau * m / denom + 1e-3
            assert np.linalg.norm(grid[s]) <= bound, (seed, s)
            assert bound < BIG
    assert checked > 10


def test_mean_demonstrably_breaks():
    grid, up, pk, att_mask = _attacked_round(0, "mean", f=2)
    att_hit = (up[att_mask] > 0).any(axis=0)
    assert att_hit.any()
    assert np.abs(grid[att_hit]).max() > 1000 * np.abs(pk).max()


def test_mean_mode_default_unchanged():
    """agg_mode defaults to mean, and the robust fields do not perturb
    the mean path."""
    s = _streams(13, "f32", loss=0.2, dup=0.2)
    assert port.EngineConfig(n_clients=K, n_params=P, payload=W).agg_mode \
        == "mean"
    a = _port_round(s, **_kw("mean", trim_beta=0.1, clip_tau=1.0))
    b = _port_round(s, **_kw("mean", trim_beta=0.4, clip_tau=99.0))
    _assert_same(a, b)


def test_churn_driver_attack_sweep_end_to_end():
    """run_churn_rounds(attack=...) with the trimmed mean keeps the served
    global bounded under churn and stragglers; the mean blows up; both
    equal the JAX package's driver on the same seeds."""
    rng_ = np.random.default_rng(7)
    flats = rng_.integers(-4, 5, (K, P)).astype(np.float32)
    prev = np.zeros(P, np.float32)
    churn = rounds.ChurnConfig(participation=0.9, straggle_rate=0.15,
                               loss_rate=0.1, dup_rate=0.05)
    ref_churn = ref_rounds.ChurnConfig(**dataclasses.asdict(churn))

    def run(agg):
        kw = dict(n_clients=K, n_params=P, payload=W, ring_capacity=7,
                  compile=True, agg_mode=agg, trim_beta=0.25, min_clients=1)
        hist = rounds.run_churn_rounds(
            port.EngineConfig(**kw), churn, flats, prev, 3,
            rng=np.random.default_rng(11),
            attack=rounds.AttackConfig("scale", n_attackers=1, boost=1e4),
            device="cpu")
        want = ref_rounds.run_churn_rounds(
            ref.EngineConfig(**kw), ref_churn, jnp.asarray(flats),
            jnp.asarray(prev), 3, rng=np.random.default_rng(11),
            attack=ref_rounds.AttackConfig("scale", n_attackers=1,
                                           boost=1e4))
        np.testing.assert_array_equal(hist.final_global.numpy(),
                                      np.asarray(want.final_global))
        return hist.final_global.numpy()

    honest_mean = flats.mean(axis=0)
    err_robust = np.abs(run("trimmed_mean") - honest_mean).max()
    err_mean = np.abs(run("mean") - honest_mean).max()
    assert err_mean > 100.0
    assert err_robust < 20.0
    assert err_robust < err_mean
