"""The round fold of the port (``packet_scatter_accum_rounds`` and its
slot-major plain version) against the per-row fold it replaces and
against the JAX package's ``packet_scatter_accum_scan``.

The plain version walks each slot's hits row after row, as the round
kernel does, so it must equal folding the schedule's rows one by one in
the per-batch kernel's order bit for bit, on Gaussian payloads too
(tolerance 0).  Against the JAX scan, whose one-hot matmul sums in
another order, the comparison is on integer payloads and power-of-two
q8 scales, where every f32 sum is exact (tolerance 0 as well).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import packet_scatter as ref_ps
from repro_torch.kernels import packet_scatter as ps

S, W, K = 24, 16, 3        # slots, width, clients of the robust table


def _schedule(seed, kind, *, q8, integer):
    """A drain schedule (R, B) with the edges the contract names.

    mixed : duplicates within a row and across rows, weight-0 arrivals,
            ``idx = -1`` padding and ``idx >= S``;
    hot   : one slot hit 50 times in each of 40 rows (2,000 hits);
    clip  : fractional norm-clip weights (``norm_clip_weights``);
    table : the robust table's combined ``slot*K + client`` indices, each
            row of the (S*K, W) table hit at most once, weight 1.0.
    -> idx, w, pk, scales (None on the f32 wire), acc, counts (numpy).
    """
    rng = np.random.default_rng(seed)
    R, B, n_rows = (40, 64, S) if kind == "hot" else (12, 32, S)
    if kind == "table":
        n_rows = S * K
        flat = np.full(R * B, -1, np.int32)
        real = rng.permutation(R * B)[:n_rows - 5]
        flat[real] = rng.permutation(n_rows)[:n_rows - 5]
        idx = flat.reshape(R, B)
        w = (idx >= 0).astype(np.float32)
    else:
        idx = rng.integers(0, S, (R, B)).astype(np.int32)
        idx[:, 3] = idx[:, 0]                     # duplicates in a row
        idx[1:, 1] = idx[:-1, 1]                  # and across rows
        idx[:, -4:] = -1                          # ring padding
        idx[::3, -5] = S + 2                      # out of range: inert
        idx[2, -6] = -7
        if kind == "hot":
            for r in range(R):
                idx[r, rng.choice(B - 6, 50, replace=False)] = 5
        w = rng.integers(1, 4, (R, B)).astype(np.float32)
        w[:, 3] = 0.0                             # a weight-0 duplicate
        w[::2, 7] = 0.0
        w[:, -4:] = 0.0
    if q8:
        pk = rng.integers(-127, 128, (R, B, W)).astype(np.int8)
        sc = ((2.0 ** rng.integers(-5, 1, (R, B))) if integer
              else rng.uniform(1e-3, 1e-1, (R, B))).astype(np.float32)
    else:
        pk = (rng.integers(-8, 9, (R, B, W)) if integer
              else rng.normal(size=(R, B, W))).astype(np.float32)
        sc = None
    if kind == "clip":
        tau = 8.0 if integer else 2.0
        w = ps.norm_clip_weights(torch.from_numpy(w), torch.from_numpy(pk),
                                 tau=tau, scales=None if sc is None
                                 else torch.from_numpy(sc)).numpy()
        assert (w % 1 != 0).any()                 # the clip is active
    acc = (rng.integers(-8, 9, (n_rows, W)) if integer
           else rng.normal(size=(n_rows, W))).astype(np.float32)
    if kind == "table":
        acc[:] = 0.0
    cnt = rng.integers(0, 3, n_rows).astype(np.float32)
    return idx, w, pk, sc, acc, cnt


def _row_by_row(idx, w, pk, sc, acc, cnt, exact):
    """numpy, one schedule row after another in the per-batch kernel's
    order: per slot of the row, its weights and its ``w * x`` terms
    summed from 0 in packet order (approx: the last hit with a positive
    weight), then added."""
    acc, cnt = acc.copy(), cnt.copy()
    n_slots = acc.shape[0]
    for r in range(idx.shape[0]):
        x = pk[r].astype(np.float32)
        if sc is not None:
            x = x * sc[r][:, None]
        for s in dict.fromkeys(int(i) for i in idx[r]
                               if 0 <= i < n_slots):
            hits = [n for n in range(idx.shape[1]) if idx[r, n] == s]
            c = np.float32(0.0)
            for n in hits:
                c = np.float32(c + w[r, n])
            cnt[s] = np.float32(cnt[s] + c)
            if exact:
                bs = np.zeros(acc.shape[1], np.float32)
                for n in hits:
                    bs = bs + w[r, n] * x[n]
                acc[s] = acc[s] + bs
                continue
            live = [n for n in hits if w[r, n] > 0]
            if live:
                acc[s] = acc[s] + w[r, live[-1]] * x[live[-1]]
    return acc, cnt


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _plain(idx, w, pk, sc, acc, cnt, exact):
    return ps.packet_scatter_accum_rounds_plain(
        _t(idx), _t(w), _t(pk), _t(acc), _t(cnt), sched_scales=_t(sc),
        exact=exact)


def _per_row_plain(idx, w, pk, sc, acc, cnt, exact):
    a, c = _t(acc), _t(cnt)
    for r in range(idx.shape[0]):
        if sc is None:
            a, c = ps.packet_scatter_accum_plain(
                _t(pk[r]), _t(idx[r]), _t(w[r]), a, c, exact=exact)
        else:
            a, c = ps.packet_scatter_accum_q8_plain(
                _t(pk[r]), _t(sc[r]), _t(idx[r]), _t(w[r]), a, c,
                exact=exact)
    return a, c


KINDS = ["mixed", "hot", "clip", "table"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "approx"])
def test_slot_major_equals_the_row_by_row_fold(kind, q8, exact):
    """Gaussian payloads and scales: bit for bit (tolerance 0) against a
    numpy fold row after row and the port's per-batch plain version run
    row by row."""
    b = _schedule(10 + 2 * KINDS.index(kind) + q8, kind, q8=q8,
                  integer=False)
    got = _plain(*b, exact)
    want = _row_by_row(*b, exact)
    rows = _per_row_plain(*b, exact)
    for g, o, r in zip(got, want, rows):
        np.testing.assert_array_equal(g.numpy(), o)
        assert torch.equal(g, r)


@pytest.mark.parametrize("kind", ["mixed", "hot", "table"])
@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "approx"])
def test_slot_major_matches_reference_scan(kind, q8, exact):
    """Integer payloads, power-of-two scales: bit for bit against the
    JAX package's row-by-row scan."""
    idx, w, pk, sc, acc, cnt = _schedule(7, kind, q8=q8, integer=True)
    idx = np.where(idx >= acc.shape[0], -1, idx).astype(np.int32)
    a_ref, c_ref = ref_ps.packet_scatter_accum_scan(
        jnp.asarray(idx), jnp.asarray(w), jnp.asarray(pk), jnp.asarray(acc),
        jnp.asarray(cnt[:, None]),
        sched_scales=None if sc is None else jnp.asarray(sc), exact=exact)
    a, c = _plain(idx, w, pk, sc, acc, cnt, exact)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref)[:, 0])


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
def test_cpu_wrapper_folds_in_place_without_launching(q8):
    idx, w, pk, sc, acc, cnt = _schedule(3, "mixed", q8=q8, integer=False)
    want = _plain(idx, w, pk, sc, acc, cnt, True)
    a, c = _t(acc), _t(cnt)
    counters = (ps.packet_scatter_accum_rounds, ps.packet_scatter_accum,
                ps.packet_scatter_accum_q8)
    before = [f.launches for f in counters]
    out = ps.packet_scatter_accum_rounds(_t(idx), _t(w), _t(pk), a, c,
                                         sched_scales=_t(sc))
    assert out[0] is a and out[1] is c
    assert torch.equal(a, want[0]) and torch.equal(c, want[1])
    assert [f.launches for f in counters] == before


def test_plain_leaves_its_inputs_alone_and_an_empty_schedule_is_inert():
    idx, w, pk, sc, acc, cnt = _schedule(4, "mixed", q8=False, integer=True)
    args = [_t(a) for a in (idx, w, pk, acc, cnt)]
    ps.packet_scatter_accum_rounds_plain(*args)
    assert torch.equal(args[3], _t(acc)) and torch.equal(args[4], _t(cnt))
    a, c = ps.packet_scatter_accum_rounds_plain(
        torch.full((2, 4), -1, dtype=torch.int32), torch.zeros(2, 4),
        torch.ones(2, 4, W), _t(acc), _t(cnt))
    assert torch.equal(a, _t(acc)) and torch.equal(c, _t(cnt))


@pytest.mark.parametrize("bad", ["idx_1d", "idx_dtype", "w_shape",
                                 "pk_dtype", "pk_width", "scales_shape",
                                 "strided", "device"])
def test_rounds_wrapper_rejects_what_the_kernel_does_not_take(bad):
    idx, w, pk, sc, acc, cnt = _schedule(5, "mixed", q8=True, integer=True)
    args = dict(sched_idx=_t(idx), sched_w=_t(w), sched_pk=_t(pk),
                acc=_t(acc), counts=_t(cnt), sched_scales=_t(sc))
    if bad == "idx_1d":
        args["sched_idx"] = args["sched_idx"].reshape(-1)
    elif bad == "idx_dtype":
        args["sched_idx"] = args["sched_idx"].long()
    elif bad == "w_shape":
        args["sched_w"] = args["sched_w"][:, :-1].contiguous()
    elif bad == "pk_dtype":
        args["sched_pk"] = args["sched_pk"].float()
    elif bad == "pk_width":
        args["sched_pk"] = args["sched_pk"][..., :-1].contiguous()
    elif bad == "scales_shape":
        args["sched_scales"] = args["sched_scales"][:-1].contiguous()
    elif bad == "strided":
        args["sched_w"] = torch.zeros(w.shape[::-1]).t()
    else:
        args["sched_w"] = args["sched_w"].to("meta")
    with pytest.raises((TypeError, ValueError)):
        ps.packet_scatter_accum_rounds(**args)
