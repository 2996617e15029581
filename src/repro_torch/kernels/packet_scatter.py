"""Scatter-accumulate kernels of the packet path (paper §3.2.2).

The worker loop: a drained ring batch of packets is *added* into a live
``(S, W)`` accumulator with per-slot arrival counts (the DESIGN.md §3
contract).  Two modes:

- ``exact`` : every arrival adds (duplicates add twice) — the paper's
  server *with* exclusive access control.
- ``approx``: the lock-free race, made deterministic: every writer reads
  the accumulator at call entry, and when several packets of the batch
  hit one slot only the last write with a positive weight survives;
  counts still see every arrival.

Each function comes in three forms:

- ``packet_scatter_accum`` / ``packet_scatter_accum_q8``: the wrappers.
  On CUDA tensors they launch the hand-written kernels of
  ``csrc/packet_scatter.cu`` (built with ``nvcc`` for ``sm_90a`` at first
  use, loaded with ``ctypes``) and count each launch in their
  ``launches`` attribute; on CPU tensors they run the plain version.
  They update ``acc`` and ``counts`` in place, where the JAX package
  aliases (donates) them.
- ``packet_scatter_accum_plain`` / ``packet_scatter_accum_q8_plain``:
  plain PyTorch with the kernel's arithmetic in the kernel's order
  (a slot's hits summed in packet order, then added once), so the two
  agree bit for bit on any payload.  The reference's jnp twin
  (``packet_scatter_accum_batch_jnp``) routes through a one-hot (S x N)
  matmul instead; the sums agree wherever they are exact.
- ``packet_scatter_accum_rounds`` / ``packet_scatter_accum_rounds_plain``:
  a whole round's drain schedule, folded slot-major (one warp per slot
  for the whole round) in a fixed set of launches on the current
  stream, no host sync; bit for bit the rows folded one by one.

The Byzantine-robust modes (DESIGN.md §11) add, in the same forms:

- ``robust_finalize`` / ``robust_finalize_plain``: the trimmed-mean and
  coordinate-wise-median finalize over the per-slot client table
  (kernel ``csrc/robust_finalize.cu``); ``norm_clip_weights``, the
  per-packet influence bound; ``packet_table_scatter``, the CPU fold of
  a robust round's unique-index table schedule.
- ``packet_scatter`` / ``packet_scatter_plain``: placement of packets at
  their index rows, last writer wins (kernel ``csrc/packet_place.cu``).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

# the largest drained batch the per-drain kernel takes: each of its CTAs
# scans the batch's earlier positions for an owner, O(N) a CTA.
# EngineConfig refuses a ring capacity above it.
MAX_BATCH = 2048


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the yardstick on the card)
# ---------------------------------------------------------------------------

def packet_scatter_accum_plain(packets: torch.Tensor, idx: torch.Tensor,
                               weights: torch.Tensor, acc: torch.Tensor,
                               counts: torch.Tensor, *, exact: bool = True):
    """One drained batch: packets (N, W), idx (N,) slot rows (outside
    ``[0, S)`` = inert), weights (N,), acc (S, W), counts (S,) ->
    new (acc', counts').  Functional: the inputs are not modified.

    The kernel's arithmetic in the kernel's order: a slot's hits are
    summed in packet order from 0 (``w * x`` each, then added), and the
    sum is added to the slot's row once; the counts likewise.  Approx
    mode adds only the last hit with a positive weight.  So the kernel
    and this version agree bit for bit on any payload and weights.  It
    is the round of one row.
    """
    return packet_scatter_accum_rounds_plain(
        idx[None], weights[None], packets[None], acc, counts, exact=exact)


def packet_scatter_accum_q8_plain(packets: torch.Tensor, scales: torch.Tensor,
                                  idx: torch.Tensor, weights: torch.Tensor,
                                  acc: torch.Tensor, counts: torch.Tensor, *,
                                  exact: bool = True):
    """q8 twin: decode rows first (``q * scale``), then the f32 batch."""
    pkt = packets.to(torch.float32) * scales.to(torch.float32)[:, None]
    return packet_scatter_accum_plain(pkt, idx, weights, acc, counts,
                                      exact=exact)


# ---------------------------------------------------------------------------
# The CUDA kernels: build, load, launch
# ---------------------------------------------------------------------------

@functools.cache
def load_library() -> _build.KernelLibrary:
    """Build ``csrc/packet_scatter.cu`` (once per source hash) and load it."""
    built = _build.load("packet_scatter")
    _build.declare(built.lib, "packet_scatter_accum_f32", 5, 4)
    _build.declare(built.lib, "packet_scatter_accum_q8", 6, 4)
    _build.declare(built.lib, "packet_scatter_rounds_f32", 9, 5)
    _build.declare(built.lib, "packet_scatter_rounds_q8", 10, 5)
    return built


def _launch_f32(pkt: int, idx: int, w: int, acc: int, cnt: int, n: int,
                width: int, n_slots: int, exact: bool, stream: int) -> None:
    lib = load_library()
    lib.check(lib.lib.packet_scatter_accum_f32(
        pkt, idx, w, acc, cnt, n, width, n_slots, int(exact), stream),
        "packet_scatter_accum")
    packet_scatter_accum.launches += 1


def _launch_q8(pkt: int, scales: int, idx: int, w: int, acc: int, cnt: int,
               n: int, width: int, n_slots: int, exact: bool,
               stream: int) -> None:
    lib = load_library()
    lib.check(lib.lib.packet_scatter_accum_q8(
        pkt, scales, idx, w, acc, cnt, n, width, n_slots, int(exact),
        stream), "packet_scatter_accum_q8")
    packet_scatter_accum_q8.launches += 1


def _check_accum(acc: torch.Tensor, counts: torch.Tensor) -> None:
    if not isinstance(acc, torch.Tensor) or acc.dim() != 2:
        raise ValueError("acc must be an (S, W) tensor")
    _build.check_tensor("acc", acc, torch.float32, tuple(acc.shape),
                        acc.device)
    _build.check_tensor("counts", counts, torch.float32, (acc.shape[0],),
                        acc.device)
    if acc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no packet_scatter kernel for {acc.device}")


def _check_batch_len(n: int) -> None:
    if n > MAX_BATCH:
        raise ValueError(f"batch of {n} packets exceeds MAX_BATCH="
                         f"{MAX_BATCH}")


def _check_batch(packets, scales, idx, weights, acc, counts, pk_dtype):
    _check_accum(acc, counts)
    dev = acc.device
    if not isinstance(idx, torch.Tensor) or idx.dim() != 1:
        raise ValueError("idx must be an (N,) tensor")
    N = idx.shape[0]
    _check_batch_len(N)
    _build.check_tensor("idx", idx, torch.int32, (N,), dev)
    _build.check_tensor("weights", weights, torch.float32, (N,), dev)
    _build.check_tensor("packets", packets, pk_dtype, (N, acc.shape[1]),
                        dev)
    if scales is not None:
        _build.check_tensor("scales", scales, torch.float32, (N,), dev)


def packet_scatter_accum(packets: torch.Tensor, idx: torch.Tensor,
                         weights: torch.Tensor, acc: torch.Tensor,
                         counts: torch.Tensor, *, exact: bool = True):
    """Scatter-accumulate one drained f32 batch into ``(acc, counts)``.

    packets (N, W) f32; idx (N,) int32 slot rows (outside ``[0, S)`` =
    inert padding); weights (N,) f32 per-arrival FedAvg weights; acc
    (S, W) f32 and counts (S,) f32, updated in place (the reference
    donates them) and returned.  CUDA tensors launch the kernel; CPU
    tensors run ``packet_scatter_accum_plain``.
    """
    _check_batch(packets, None, idx, weights, acc, counts, torch.float32)
    if acc.device.type == "cpu":
        a, c = packet_scatter_accum_plain(packets, idx, weights, acc, counts,
                                          exact=exact)
        acc.copy_(a)
        counts.copy_(c)
        return acc, counts
    _launch_f32(packets.data_ptr(), idx.data_ptr(), weights.data_ptr(),
                acc.data_ptr(), counts.data_ptr(), idx.shape[0],
                acc.shape[1], acc.shape[0], exact,
                _build.stream(acc.device))
    return acc, counts


packet_scatter_accum.launches = 0


def packet_scatter_accum_q8(packets: torch.Tensor, scales: torch.Tensor,
                            idx: torch.Tensor, weights: torch.Tensor,
                            acc: torch.Tensor, counts: torch.Tensor, *,
                            exact: bool = True):
    """q8 twin of ``packet_scatter_accum``: packets (N, W) **int8** wire
    payloads and scales (N,) f32 per-packet dequant scales (0 for
    padding).  Each row is decoded in the kernel (``q * scale``), then
    weighted and added: the same numbers as decoding on the host and
    running the f32 kernel."""
    _check_batch(packets, scales, idx, weights, acc, counts, torch.int8)
    if acc.device.type == "cpu":
        a, c = packet_scatter_accum_q8_plain(packets, scales, idx, weights,
                                             acc, counts, exact=exact)
        acc.copy_(a)
        counts.copy_(c)
        return acc, counts
    _launch_q8(packets.data_ptr(), scales.data_ptr(), idx.data_ptr(),
               weights.data_ptr(), acc.data_ptr(), counts.data_ptr(),
               idx.shape[0], acc.shape[1], acc.shape[0], exact,
               _build.stream(acc.device))
    return acc, counts


packet_scatter_accum_q8.launches = 0


def _group_starts(new: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run, given a mask of run starts."""
    at = torch.arange(new.numel(), device=new.device)
    return at - torch.cummax(torch.where(new, at, 0), dim=0).values


def packet_scatter_accum_rounds_plain(sched_idx: torch.Tensor,
                                      sched_w: torch.Tensor,
                                      sched_pk: torch.Tensor,
                                      acc: torch.Tensor, counts: torch.Tensor,
                                      *,
                                      sched_scales: Optional[torch.Tensor] = None,
                                      exact: bool = True):
    """A round's drain schedule folded slot-major, in the round kernel's
    order -> new (acc', counts').  Functional: the inputs are not modified.

    Each hit slot takes its hits in schedule order, row after row: per
    row the batch sum from 0 in packet order (approx: the row's last hit
    with a positive weight) and the row's weights from 0, each then added
    to the slot's running value.  Those are the operations, in the order,
    of folding the rows one by one with ``packet_scatter_accum_plain``,
    so the two agree bit for bit on any payload.  The loops run over the
    most rows (and hits in a row) any one slot has, every slot at once.
    """
    S, W = acc.shape
    B = sched_idx.shape[1]
    slot = sched_idx.reshape(-1).to(torch.int64)
    pos = torch.nonzero((slot >= 0) & (slot < S)).flatten()
    s, perm = torch.sort(slot[pos], stable=True)     # slot-major, in order
    pos = pos[perm]
    row = torch.div(pos, B, rounding_mode="floor")
    w = sched_w.reshape(-1).to(torch.float32)[pos]
    x = sched_pk.reshape(-1, W)[pos].to(torch.float32)
    if sched_scales is not None:
        x = x * sched_scales.reshape(-1).to(torch.float32)[pos, None]
    new_grp = torch.ones_like(s, dtype=torch.bool)   # (slot, row) groups
    new_grp[1:] = (s[1:] != s[:-1]) | (row[1:] != row[:-1])
    grp = torch.cumsum(new_grp, 0) - 1
    k = _group_starts(new_grp)                       # hit rank in its row
    g_slot = s[new_grp]
    new_slot = torch.ones_like(g_slot, dtype=torch.bool)
    new_slot[1:] = g_slot[1:] != g_slot[:-1]
    j = _group_starts(new_slot)                      # row rank in its slot
    g_sid = torch.cumsum(new_slot, 0) - 1
    slots = g_slot[new_slot]
    G = g_slot.numel()
    n_k = int(k.max()) + 1 if k.numel() else 0
    n_j = int(j.max()) + 1 if j.numel() else 0
    c_row = torch.zeros(G, dtype=torch.float32, device=acc.device)
    for kk in range(n_k):               # the kk-th hit of every row group
        sel = k == kk
        c_row[grp[sel]] = c_row[grp[sel]] + w[sel]
    c = counts[slots]
    for jj in range(n_j):               # the jj-th row of every slot
        sel = j == jj
        c[g_sid[sel]] = c[g_sid[sel]] + c_row[sel]
    v = acc[slots]
    if exact:
        bs = torch.zeros((G, W), dtype=torch.float32, device=acc.device)
        for kk in range(n_k):
            sel = k == kk
            bs[grp[sel]] = bs[grp[sel]] + w[sel, None] * x[sel]
        for jj in range(n_j):
            sel = j == jj
            v[g_sid[sel]] = v[g_sid[sel]] + bs[sel]
    else:
        # the row's last hit with a positive weight wins its race
        live = w > 0
        last = torch.full((G,), -1, dtype=torch.int64, device=acc.device)
        at = torch.arange(pos.numel(), device=acc.device)
        last.scatter_reduce_(0, grp[live], at[live], reduce="amax")
        for jj in range(n_j):
            sel = (j == jj) & (last >= 0)
            lw = last[sel]
            v[g_sid[sel]] = v[g_sid[sel]] + w[lw, None] * x[lw]
    acc, counts = acc.clone(), counts.clone()
    acc[slots] = v
    counts[slots] = c
    return acc, counts


def packet_scatter_accum_rounds(sched_idx: torch.Tensor,
                                sched_w: torch.Tensor,
                                sched_pk: torch.Tensor, acc: torch.Tensor,
                                counts: torch.Tensor, *,
                                sched_scales: Optional[torch.Tensor] = None,
                                exact: bool = True):
    """Fold a round's drain schedule into ``(acc, counts)`` in place.

    sched_idx/sched_w (R, B) and sched_pk (R, B, W) hold one drained
    ring batch per row (``core/engine_compiled.py``), padded with inert
    ``idx = -1`` / ``weight = 0`` entries; with ``sched_scales`` (R, B)
    the payloads are the int8 wire rows.  The result is the rows folded
    in order, each by the batch contract (the reference's
    ``packet_scatter_accum_scan``).  CUDA tensors run the round kernel
    of ``csrc/packet_scatter.cu``: one memset and four launches on the
    current stream whatever R is, no host sync, counted once in
    ``packet_scatter_accum_rounds.launches``; scratch (two (S+1,) and
    two (R*B,) int32 buffers) comes from ``torch.empty``.  CPU tensors
    run ``packet_scatter_accum_rounds_plain``.
    """
    _check_accum(acc, counts)
    dev = acc.device
    if not isinstance(sched_idx, torch.Tensor) or sched_idx.dim() != 2:
        raise ValueError("sched_idx must be an (R, B) tensor")
    R, B = sched_idx.shape
    S, W = acc.shape
    q8 = sched_scales is not None
    _build.check_tensor("sched_idx", sched_idx, torch.int32, (R, B), dev)
    _build.check_tensor("sched_w", sched_w, torch.float32, (R, B), dev)
    _build.check_tensor("sched_pk", sched_pk,
                        torch.int8 if q8 else torch.float32, (R, B, W), dev)
    if q8:
        _build.check_tensor("sched_scales", sched_scales, torch.float32,
                            (R, B), dev)
    if dev.type == "cpu":
        a, c = packet_scatter_accum_rounds_plain(
            sched_idx, sched_w, sched_pk, acc, counts,
            sched_scales=sched_scales, exact=exact)
        acc.copy_(a)
        counts.copy_(c)
        return acc, counts
    if R * B == 0 or S == 0:
        return acc, counts
    if R * B >= 2 ** 31:
        raise ValueError(f"a schedule of {R} x {B} entries exceeds int32")
    i32 = dict(dtype=torch.int32, device=dev)
    count, offsets = torch.empty(S + 1, **i32), torch.empty(S + 1, **i32)
    hits, tmp = torch.empty(R * B, **i32), torch.empty(R * B, **i32)
    lib = load_library()
    tail = (acc.data_ptr(), counts.data_ptr(), count.data_ptr(),
            offsets.data_ptr(), hits.data_ptr(), tmp.data_ptr(), R, B, W, S,
            int(exact), _build.stream(dev))
    if q8:
        err = lib.lib.packet_scatter_rounds_q8(
            sched_pk.data_ptr(), sched_scales.data_ptr(),
            sched_idx.data_ptr(), sched_w.data_ptr(), *tail)
    else:
        err = lib.lib.packet_scatter_rounds_f32(
            sched_pk.data_ptr(), sched_idx.data_ptr(), sched_w.data_ptr(),
            *tail)
    lib.check(err, "packet_scatter_accum_rounds")
    packet_scatter_accum_rounds.launches += 1
    return acc, counts


packet_scatter_accum_rounds.launches = 0


# ---------------------------------------------------------------------------
# Byzantine-robust modes (DESIGN.md §11): norm clip, table fold, finalize
# ---------------------------------------------------------------------------

_F32_MAX = torch.finfo(torch.float32).max


def _row_sumsq(r: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis in one fixed order: the squares
    are zero-padded to a power-of-two width and halved pairwise.  Every
    step is elementwise, so a row gives the same bits whatever the
    leading shape and on either device; a library reduction may change
    its order with the tensor's shape (the eager engine folds (B, W)
    batches, the compiled one (R, B, W) schedules)."""
    sq = r * r
    n = sq.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width > n:
        sq = torch.nn.functional.pad(sq, (0, width - n))
    while sq.shape[-1] > 1:
        half = sq.shape[-1] // 2
        sq = sq[..., :half] + sq[..., half:]
    return sq[..., 0]


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root of ``x >= 0`` on either
    device.  ``torch.sqrt`` on f32 CPU tensors may run through a vector
    math library accurate to about an ulp (sqrt(15698.1875) came out one
    ulp below the IEEE root that the card and numpy return).  The root
    taken in f64 and rounded to f32 is correctly rounded: 53 >= 2*24 + 2
    bits, so the double rounding cannot move it."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def norm_clip_weights(weights: torch.Tensor, rows: torch.Tensor, *,
                      tau: float,
                      scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-packet norm-clipped FedAvg weight (DESIGN.md §11).

    weights (...,) base per-arrival weights; rows (..., W) payload rows;
    on the q8 wire ``scales`` (...,) so the norm is taken over the
    dequantized rows.  Returns ``w * tau / max(tau, ||row||_2)`` in f32:
    a row inside the ball keeps its weight exactly, a longer one is
    shrunk to norm ``tau``.  Elementwise per packet, with the norm
    summed in ``_row_sumsq``'s fixed order and its root correctly
    rounded, so the eager and the compiled engine, on the CPU or the
    card, get the same bits; inert padding (weight 0) stays inert.
    """
    w = weights.to(torch.float32)
    r = rows.to(torch.float32)
    if scales is not None:
        r = r * scales.to(torch.float32)[..., None]
    nrm = _sqrt_rn(_row_sumsq(r))
    t = torch.tensor(tau, dtype=torch.float32, device=w.device)
    return w * (t / torch.maximum(t, nrm))


def packet_table_scatter(sched_idx: torch.Tensor, sched_w: torch.Tensor,
                         sched_pk: torch.Tensor, acc: torch.Tensor,
                         cnt: torch.Tensor, *,
                         sched_scales: Optional[torch.Tensor] = None):
    """Fold a *unique-index* drain schedule into ``(acc, cnt)`` in place
    with one ``index_add_`` (the robust table fold on the CPU).

    A robust round's combined ``slot*K + client`` indices hit each row of
    the ``(S*K, W)`` table at most once (dedup upstream), so the add
    order cannot matter: every real row lands as ``0 + w*payload``, the
    same bits as folding the schedule row by row.  Entries with
    ``idx < 0`` (padding) or ``idx >= len(acc)`` are inert.
    """
    W = acc.shape[1]
    idx = sched_idx.reshape(-1).to(torch.int64)
    w = sched_w.reshape(-1).to(torch.float32)
    pk = sched_pk.reshape(-1, W).to(torch.float32)
    if sched_scales is not None:
        pk = pk * sched_scales.reshape(-1).to(torch.float32)[:, None]
    real = (idx >= 0) & (idx < acc.shape[0])
    acc.index_add_(0, idx[real], w[real, None] * pk[real])
    cnt.index_add_(0, idx[real], w[real])
    return acc, cnt


def _robust_trim(m: torch.Tensor, *, median: bool, beta: float
                 ) -> torch.Tensor:
    """Per-slot trim depth from the contributor count m, in f32: the
    trimmed mean drops ``floor(f32(m) * f32(beta))`` ranks from each end,
    the median keeps the middle rank or pair, ``floor((m - 1) / 2)``."""
    m = m.to(torch.float32)
    if median:
        t = torch.floor((m - 1.0) * 0.5)
    else:
        t = torch.floor(m * torch.tensor(beta, dtype=torch.float32,
                                         device=m.device))
    return torch.clamp_min(t, 0.0)


def robust_finalize_plain(table: torch.Tensor, pres: torch.Tensor, *,
                          median: bool = False, beta: float = 0.1):
    """Plain PyTorch version of the robust finalize kernel: the same
    rank-select in the same order.

    table (S, K, W) f32 per-slot client table; pres (S, K) f32 (> 0 =
    present).  Each present value is ranked by the present values below
    it (absent entries sit at a FLT_MAX sentinel; ties go by client
    order), ranks in ``[t, m - t)`` are kept and summed in client order
    from 0, and the sum is divided by the kept count.  -> ``(agg (S, W),
    m (S,))``, agg 0 where no value was kept.  The reference's jnp twin
    sums in sorted order instead, so the two agree bit for bit only where
    the sums are exact (integer payloads).
    """
    S, K, W = table.shape
    p = pres > 0
    m = p.to(torch.float32).sum(dim=1)
    t = _robust_trim(m, median=median, beta=beta)[:, None]
    hi = m[:, None] - t
    vm = torch.where(p[:, :, None], table.to(torch.float32), _F32_MAX)
    kiota = torch.arange(K, device=table.device)[None, :, None]
    ssum = torch.zeros((S, W), dtype=torch.float32, device=table.device)
    kept = torch.zeros((S, W), dtype=torch.float32, device=table.device)
    for k in range(K):
        vk = vm[:, k:k + 1, :]
        below = (vm < vk) | ((vm == vk) & (kiota < k))
        rank = below.sum(dim=1).to(torch.float32)
        keep = p[:, k, None] & (rank >= t) & (rank < hi)
        ssum = ssum + torch.where(keep, vm[:, k], 0.0)
        kept = kept + keep.to(torch.float32)
    agg = torch.where(kept > 0, ssum / torch.clamp_min(kept, 1e-12), 0.0)
    return agg, m


@functools.cache
def load_robust_library() -> _build.KernelLibrary:
    """Build ``csrc/robust_finalize.cu`` (once per source hash), load it."""
    built = _build.load("robust_finalize")
    _build.declare(built.lib, "robust_finalize_f32", 4, 4, 1)
    return built


def robust_finalize(table: torch.Tensor, pres: torch.Tensor, *,
                    median: bool = False, beta: float = 0.1):
    """Trimmed-mean (``beta`` per side) or median finalize of a per-slot
    client table: table (S, K, W) f32, pres (S, K) f32 -> ``(agg (S, W),
    m (S,))``.  CUDA tensors launch ``csrc/robust_finalize.cu`` and count
    the launch in ``robust_finalize.launches``; CPU tensors run
    ``robust_finalize_plain``."""
    if not isinstance(table, torch.Tensor) or table.dim() != 3:
        raise ValueError("table must be an (S, K, W) tensor")
    S, K, W = table.shape
    dev = table.device
    _build.check_tensor("table", table, torch.float32, (S, K, W), dev)
    _build.check_tensor("pres", pres, torch.float32, (S, K), dev)
    if dev.type == "cpu":
        return robust_finalize_plain(table, pres, median=median, beta=beta)
    if dev.type != "cuda":
        raise ValueError(f"no robust_finalize kernel for {dev}")
    agg = torch.empty((S, W), dtype=torch.float32, device=dev)
    m = torch.empty((S,), dtype=torch.float32, device=dev)
    lib = load_robust_library()
    lib.check(lib.lib.robust_finalize_f32(
        table.data_ptr(), pres.data_ptr(), agg.data_ptr(), m.data_ptr(), S, K,
        W, int(median), float(beta), _build.stream(dev)), "robust_finalize")
    robust_finalize.launches += 1
    return agg, m


robust_finalize.launches = 0


# ---------------------------------------------------------------------------
# Placement: out[idx[n]] = packets[n], last writer wins
# ---------------------------------------------------------------------------

def packet_scatter_plain(packets: torch.Tensor, idx: torch.Tensor,
                         n_slots: int, init: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain PyTorch version of the placement kernel: the same two steps.
    The last packet naming a row is found with an integer max, then each
    such packet writes its row.  Rows no packet covers keep ``init``
    (zeros without it); idx outside ``[0, n_slots)`` is inert.
    Functional: ``init`` is not modified."""
    N, W = packets.shape
    dev = packets.device
    out = (torch.zeros((n_slots, W), dtype=packets.dtype, device=dev)
           if init is None else init.clone())
    idx = idx.to(torch.int64)
    valid = (idx >= 0) & (idx < n_slots)
    pos = torch.arange(N, device=dev)
    last = torch.full((n_slots,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, idx[valid], pos[valid], reduce="amax")
    win = valid.clone()
    win[valid] = last[idx[valid]] == pos[valid]
    out[idx[win]] = packets[win]
    return out


@functools.cache
def load_place_library() -> _build.KernelLibrary:
    """Build ``csrc/packet_place.cu`` (once per source hash), load it."""
    built = _build.load("packet_place")
    _build.declare(built.lib, "packet_place", 4, 4)
    return built


def packet_scatter(packets: torch.Tensor, idx: torch.Tensor, n_slots: int,
                   init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Place packets (N, W) at rows idx (N,) int32 of an (n_slots, W)
    buffer -> the buffer.

    ``init`` (n_slots, W) of the packets' type is the destination and is
    updated in place (the reference aliases it onto the output); without
    it the buffer starts at zeros.  Uncovered rows keep their contents,
    duplicates resolve last-writer-wins in packet order, and idx outside
    ``[0, n_slots)`` is inert.  CUDA tensors launch
    ``csrc/packet_place.cu`` and count the launch in
    ``packet_scatter.launches``; CPU tensors run
    ``packet_scatter_plain``.
    """
    if not isinstance(packets, torch.Tensor) or packets.dim() != 2:
        raise ValueError("packets must be an (N, W) tensor")
    N, W = packets.shape
    dev = packets.device
    _build.check_tensor("packets", packets, packets.dtype, (N, W), dev)
    _build.check_tensor("idx", idx, torch.int32, (N,), dev)
    if init is not None:
        _build.check_tensor("init", init, packets.dtype, (n_slots, W), dev)
    if dev.type == "cpu":
        out = packet_scatter_plain(packets, idx, n_slots, init)
        if init is None:
            return out
        return init.copy_(out)
    if dev.type != "cuda":
        raise ValueError(f"no packet_scatter kernel for {dev}")
    out = (torch.zeros((n_slots, W), dtype=packets.dtype, device=dev)
           if init is None else init)
    last = torch.full((n_slots,), -1, dtype=torch.int32, device=dev)
    lib = load_place_library()
    lib.check(lib.lib.packet_place(
        packets.data_ptr(), idx.data_ptr(), last.data_ptr(), out.data_ptr(),
        N, W, n_slots, packets.element_size(), _build.stream(dev)),
        "packet_scatter")
    packet_scatter.launches += 1
    return out


packet_scatter.launches = 0
