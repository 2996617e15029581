"""The port's scatter-accumulate (plain versions and CPU wrappers), its
sequential oracle, the ``ops`` wrapper and the streaming aggregator,
held against the JAX package's Pallas kernels (interpret mode), their
jnp twins and ``packet_scatter_accum_ref``.

Bitwise on integer-valued payloads and power-of-two q8 scales, where
every f32 sum is exact; rtol 1e-5 / atol 1e-6 on Gaussian payloads,
where the one-hot matmul may sum in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as ref_pipeline
from repro.core.aggregation import expand_packet_mask as ref_expand
from repro.kernels import ops as ref_ops
from repro.kernels import packet_scatter as ref_ps
from repro.kernels.ref import packet_scatter_accum_ref as ref_oracle
from repro_torch.core import pipeline
from repro_torch.core.aggregation import expand_packet_mask
from repro_torch.kernels import ops
from repro_torch.kernels import packet_scatter as ps
from repro_torch.kernels.ref import packet_scatter_accum_ref

S, W, N = 24, 16, 32       # slots (a multiple of 8), width, batch


def _batch(seed, *, integer=True, q8=False, idx_kind="mixed"):
    """One batch with every edge the contract names: idx=-1 padding,
    idx >= S, w=0 arrivals, duplicated slots (or all padding)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, S, N).astype(np.int32)
    idx[3] = idx[7] = idx[11] = idx[0]           # a slot hit four times
    idx[-4:] = -1                                # ring padding
    idx[-6] = S + 3                              # out of range: inert
    if idx_kind == "padding":
        idx[:] = -1
    w = rng.integers(1, 4, N).astype(np.float32)
    w[7] = 0.0                                   # weight-0 duplicate
    w[-4:] = 0.0
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
    return pk, sc, idx, w, acc, cnt


def _check(got, want, integer):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want).reshape(got.shape)
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _t(a):
    return None if a is None else torch.from_numpy(a.copy())


def _port_plain(pk, sc, idx, w, acc, cnt, exact):
    if sc is None:
        return ps.packet_scatter_accum_plain(_t(pk), _t(idx), _t(w), _t(acc),
                                             _t(cnt), exact=exact)
    return ps.packet_scatter_accum_q8_plain(_t(pk), _t(sc), _t(idx), _t(w),
                                            _t(acc), _t(cnt), exact=exact)


def _ref_pallas(pk, sc, idx, w, acc, cnt, exact):
    # the Pallas grid takes idx in [0, S) or negative; the kernel's
    # slot-block iota never matches idx >= S either
    kw = dict(exact=exact, block_pkts=N, interpret=True)
    if sc is None:
        return ref_ps.packet_scatter_accum_pallas(
            jnp.asarray(pk), jnp.asarray(idx), jnp.asarray(w),
            jnp.asarray(acc), jnp.asarray(cnt[:, None]), **kw)
    return ref_ps.packet_scatter_accum_q8_pallas(
        jnp.asarray(pk), jnp.asarray(sc), jnp.asarray(idx), jnp.asarray(w),
        jnp.asarray(acc), jnp.asarray(cnt[:, None]), **kw)


def _ref_twin(pk, sc, idx, w, acc, cnt, exact):
    if sc is None:
        return ref_ps.packet_scatter_accum_batch_jnp(
            jnp.asarray(pk), jnp.asarray(idx), jnp.asarray(w),
            jnp.asarray(acc), jnp.asarray(cnt[:, None]), exact=exact)
    return ref_ps.packet_scatter_accum_batch_q8_jnp(
        jnp.asarray(pk), jnp.asarray(sc), jnp.asarray(idx), jnp.asarray(w),
        jnp.asarray(acc), jnp.asarray(cnt[:, None]), exact=exact)


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "approx"])
@pytest.mark.parametrize("integer", [True, False], ids=["int", "gauss"])
@pytest.mark.parametrize("idx_kind", ["mixed", "padding"])
@pytest.mark.parametrize("reference", [_ref_pallas, _ref_twin],
                         ids=["pallas", "jnp"])
def test_plain_matches_reference_kernel(q8, exact, integer, idx_kind,
                                        reference):
    b = _batch(1, integer=integer, q8=q8, idx_kind=idx_kind)
    acc, cnt = _port_plain(*b, exact)
    acc_ref, cnt_ref = reference(*b, exact)
    _check(acc, acc_ref, integer)
    _check(cnt, cnt_ref, True)        # integer weights: exact either way


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_plain_and_oracle_match_reference_oracle(q8, mode):
    pk, sc, idx, w, acc, cnt = _batch(2, q8=q8)
    idx[idx >= S] = -1        # the reference oracle indexes idx >= S
    rows = pk if sc is None else pk.astype(np.float32) * sc[:, None]
    acc_ref, cnt_ref = ref_oracle(rows, idx, acc, cnt, weights=w, mode=mode)
    got = _port_plain(pk, sc, idx, w, acc, cnt, mode == "exact")
    oracle = packet_scatter_accum_ref(rows, idx, acc, cnt, weights=w,
                                      mode=mode)
    for a, c in (got, oracle):
        _check(a, acc_ref, True)
        _check(c, cnt_ref, True)


def test_oracle_treats_out_of_range_slots_as_inert():
    pk, _, idx, w, acc, cnt = _batch(3)
    a, c = packet_scatter_accum_ref(pk, idx, acc, cnt, weights=w)
    keep = idx < S
    a2, c2 = packet_scatter_accum_ref(pk[keep], idx[keep], acc, cnt,
                                      weights=w[keep])
    assert torch.equal(a, a2) and torch.equal(c, c2)
    with pytest.raises(ValueError):
        packet_scatter_accum_ref(pk, idx, acc, cnt, mode="fast")


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
def test_cpu_wrapper_updates_in_place_without_launching(q8):
    pk, sc, idx, w, acc, cnt = _batch(4, q8=q8)
    want = _port_plain(pk, sc, idx, w, acc, cnt, True)
    a, c = _t(acc), _t(cnt)
    before = (ps.packet_scatter_accum.launches,
              ps.packet_scatter_accum_q8.launches)
    if q8:
        out = ps.packet_scatter_accum_q8(_t(pk), _t(sc), _t(idx), _t(w), a, c)
    else:
        out = ps.packet_scatter_accum(_t(pk), _t(idx), _t(w), a, c)
    assert out[0] is a and out[1] is c
    assert torch.equal(a, want[0]) and torch.equal(c, want[1])
    assert (ps.packet_scatter_accum.launches,
            ps.packet_scatter_accum_q8.launches) == before


@pytest.mark.parametrize("bad", ["idx_dtype", "pk_dtype", "shape", "counts",
                                 "strided", "batch", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    pk, _, idx, w, acc, cnt = _batch(5)
    args = dict(packets=_t(pk), idx=_t(idx), weights=_t(w), acc=_t(acc),
                counts=_t(cnt))
    if bad == "idx_dtype":
        args["idx"] = args["idx"].long()
    elif bad == "pk_dtype":
        args["packets"] = args["packets"].double()
    elif bad == "shape":
        args["packets"] = args["packets"][:, :-1].contiguous()
    elif bad == "counts":
        args["counts"] = args["counts"][:, None]
    elif bad == "strided":
        args["acc"] = torch.zeros((W, S)).t()
    elif bad == "batch":
        n = ps.MAX_BATCH + 1
        args.update(packets=torch.zeros((n, W)),
                    idx=torch.full((n,), -1, dtype=torch.int32),
                    weights=torch.zeros(n))
    else:
        args["idx"] = args["idx"].to("meta")
    with pytest.raises((TypeError, ValueError)):
        ps.packet_scatter_accum(args["packets"], args["idx"], args["weights"],
                                args["acc"], args["counts"])


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "approx"])
def test_rounds_match_reference_scan(q8, exact):
    rng = np.random.default_rng(6)
    batches = [_batch(10 + r, q8=q8) for r in range(5)]
    sidx = np.stack([b[2] for b in batches])
    sidx[sidx >= S] = -1
    sw = np.stack([b[3] for b in batches])
    spk = np.stack([b[0] for b in batches])
    ssc = None if not q8 else np.stack([b[1] for b in batches])
    acc = rng.integers(-8, 9, (S, W)).astype(np.float32)
    cnt = np.zeros(S, np.float32)
    a_ref, c_ref = ref_ps.packet_scatter_accum_scan(
        jnp.asarray(sidx), jnp.asarray(sw), jnp.asarray(spk),
        jnp.asarray(acc), jnp.asarray(cnt[:, None]),
        sched_scales=None if ssc is None else jnp.asarray(ssc), exact=exact)
    a, c = _t(acc), _t(cnt)
    ps.packet_scatter_accum_rounds(_t(sidx), _t(sw), _t(spk), a, c,
                                   sched_scales=_t(ssc), exact=exact)
    _check(a, a_ref, True)
    _check(c, c_ref, True)


@pytest.mark.parametrize("mode", ["exact", "approx"])
@pytest.mark.parametrize("donate", [False, True])
def test_ops_wrapper_matches_reference_ops(mode, donate):
    """The wrapper updates (acc, counts) in place, where the reference
    donates them.  ``donate=False``: the caller keeps its buffers by
    handing the wrapper clones."""
    pk, _, idx, w, acc, cnt = _batch(7)
    a_ref, c_ref = ref_ops.packet_scatter_accum(
        jnp.asarray(pk), jnp.asarray(idx), jnp.asarray(acc),
        jnp.asarray(cnt), weights=jnp.asarray(w), mode=mode)
    a, c = _t(acc), _t(cnt)
    a_in, c_in = (a, c) if donate else (a.clone(), c.clone())
    a2, c2 = ops.packet_scatter_accum(_t(pk), _t(idx), a_in, c_in, _t(w),
                                      mode=mode)
    _check(a2, a_ref, True)
    _check(c2, c_ref, True)
    assert a2 is a_in and c2 is c_in
    if not donate:
        assert torch.equal(a, _t(acc)) and torch.equal(c, _t(cnt))


def test_ops_wrapper_defaults_and_mode_check():
    """Unit weights (the reference's default) and the default exact mode;
    an unknown mode raises."""
    pk, _, _, _, acc, cnt = _batch(8)
    idx = np.arange(N, dtype=np.int32) % S
    a_ref, c_ref = ref_ops.packet_scatter_accum(
        jnp.asarray(pk), jnp.asarray(idx), jnp.asarray(acc),
        jnp.asarray(cnt))
    a, c = ops.packet_scatter_accum(_t(pk), _t(idx), _t(acc), _t(cnt),
                                    torch.ones(N))
    _check(a, a_ref, True)
    _check(c, c_ref, True)
    with pytest.raises(ValueError):
        ops.packet_scatter_accum(_t(pk), _t(idx), _t(acc), _t(cnt),
                                 torch.ones(N), mode="fast")


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_streaming_aggregator_matches_reference(use_kernel, mode):
    agg_ref = ref_pipeline.StreamingAggregator(S, W, use_kernel=use_kernel)
    agg = pipeline.StreamingAggregator(S, W, use_kernel=use_kernel,
                                       device="cpu")
    for r in range(3):
        pk, _, idx, w, _, _ = _batch(20 + r)
        idx[idx >= S] = -1
        agg_ref.scatter_add(jnp.asarray(pk), jnp.asarray(idx),
                            weights=jnp.asarray(w), mode=mode)
        agg.scatter_add(pk, idx, weights=w, mode=mode)
    _check(agg.total, agg_ref.total, True)
    _check(agg.counts, agg_ref.counts, True)
    _check(agg.finalize(), agg_ref.finalize(), True)
    agg.reset()
    assert not agg.total.any() and not agg.counts.any()
    assert agg._finalized is None


def test_streaming_aggregator_scalar_weight_and_oracle_on_cpu_only():
    agg_ref = ref_pipeline.StreamingAggregator(S, W)
    agg = pipeline.StreamingAggregator(S, W, device="cpu")
    pk, _, idx, _, _, _ = _batch(30)
    idx[idx >= S] = -1
    agg_ref.scatter_add(jnp.asarray(pk), jnp.asarray(idx), weights=2.0)
    agg.scatter_add(pk, idx, weights=2.0)
    _check(agg.counts, agg_ref.counts, True)
    _check(agg.total, agg_ref.total, True)
    with pytest.raises(ValueError):
        pipeline.StreamingAggregator(S, W, use_kernel=False, device="meta")


@pytest.mark.parametrize("shape", [(7,), (3, 7)])
def test_expand_packet_mask_matches_reference(shape):
    m = (np.random.default_rng(9).random(shape) > 0.5).astype(np.float32)
    _check(expand_packet_mask(torch.from_numpy(m), 5, 33),
           ref_expand(jnp.asarray(m), 5, 33), True)
