"""Compiled round engine: bulk demux, then the whole round on the device.

The eager ``ServerEngine`` (core/server.py) pays one Python-driven device
call per drained ring, interleaved with the per-packet RX loop.  This
module keeps the *semantics* of that pipeline and restructures the
*execution* (DESIGN.md §3):

1. **Demux pass** (host, vectorized numpy — the reference's code): the
   event stream is turned into a dense *drain schedule*: ``(n_batches,
   B)`` slot/weight arrays and a ``(n_batches, B, W)`` payload tensor,
   one row per drained ring batch, padded with inert ``idx = -1`` /
   ``weight = 0`` entries.  The schedule reproduces the eager engine's
   batching exactly, so approx mode's per-batch race — and with it the
   result — is bitwise the eager engine's.

2. **The round on the device** (``_round_device``): the schedule's real
   rows are copied to the device once and folded into the
   ``(total, counts)`` accumulators, in place, by one round fold: a
   fixed set of launches whatever the number of rows, on one stream with
   no host sync (``kernels.packet_scatter.packet_scatter_accum_rounds``).  The END
   divide, the per-slot fallback to the previous global and the TX
   downlink fallback follow as torch ops on the device.

3. **Round overlap** (``run_compiled_rounds``): round r is queued on the
   device and, while it runs, round r+1 is demuxed on the host; each
   round's ``prev_global`` chains from the previous round's device
   tensor with no host round-trip.

4. **Robust rounds** (DESIGN.md §11): ``agg_mode="norm_clip"`` scales
   each packet's weight by ``tau / max(tau, ||row||)`` before the fold;
   ``trimmed_mean`` and ``median`` rewrite the schedule to the combined
   index ``slot*K + client`` with presence weight 1.0, fold it into an
   ``(S*K, W)`` table (the round fold on the card, one ``index_add_`` on
   the CPU) and finalize with the rank-select kernel
   (``kernels.packet_scatter.robust_finalize``).

Torch port of ``repro.core.engine_compiled`` for ``shards=1`` and
``hosts=1``.  The reference runs a round as one ``lax.scan`` dispatch;
here the fold is one slot-major round kernel (four launches).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.device import as_tensor, resolve_device
from repro_torch.core.pipeline import finalize_mean
from repro_torch.core.protocol import Kind
# QuorumError is re-exported so callers of the bulk path can catch it
# from either module
from repro_torch.core.server import (EngineConfig, EngineStats,  # noqa: F401
                                     QuorumError, RoundResult, check_quorum,
                                     downlink, fallback_global)
from repro_torch.kernels.packet_scatter import (norm_clip_weights,
                                                packet_scatter_accum_rounds,
                                                packet_table_scatter,
                                                robust_finalize)

# schedule rows are padded to a multiple of this, as in the reference
# (where it is the TPU kernel's packet block), so both packages build
# the same schedule arrays
BLOCK_PKTS = 128


# ---------------------------------------------------------------------------
# Demux: arrivals -> dense drain schedule
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DrainSchedule:
    """Dense per-round drain schedule (host arrays, ready to dispatch).

    One row per drain batch; rows beyond ``n_batches`` (row counts are
    bucketed to a multiple of ``pad_batches``) and unused columns are
    inert: ``idx = -1`` matches no slot, weight 0 is inert in sums and
    counts.
    """
    idx: np.ndarray         # (n_rows, B) int32 slot rows
    weights: np.ndarray     # (n_rows, B) f32 per-arrival FedAvg weights
    payloads: np.ndarray    # (n_rows, B, W) payload rows: f32 wire, or
                            # int8 when ``scales`` is present (q8 wire)
    n_batches: int          # real drain batches (rest is padding)
    n_packets: int          # accepted arrivals scheduled
    workers: Optional[np.ndarray] = None   # (n_rows,) owning worker ring
                                           # per batch (-1 for padding)
    scales: Optional[np.ndarray] = None    # (n_rows, B) f32 per-packet
                                           # q8 dequant scales (0 inert);
                                           # None on the f32 wire path
    clients: Optional[np.ndarray] = None   # (n_rows, B) int32 sender per
                                           # packet (-1 inert): the robust
                                           # table's combined index needs
                                           # it; None when untracked


def build_drain_schedule(slots: np.ndarray, weights: np.ndarray,
                         payloads: np.ndarray, *, n_workers: int,
                         ring_capacity: int, ring_assign: str = "rr",
                         block_pkts: int = BLOCK_PKTS,
                         pad_batches: int = 8,
                         scales: Optional[np.ndarray] = None,
                         clients: Optional[np.ndarray] = None
                         ) -> DrainSchedule:
    """Vectorized replay of the eager engine's ring demux.

    slots (n,) int32 / weights (n,) f32 / payloads (n, W) f32 are the
    *accepted* (post-FSM, post-dedup) arrivals in arrival order.  The
    batching reproduces ``ServerEngine`` exactly: arrival i goes to
    worker ``i % n_workers`` (rr) or ``slot % n_workers`` (slot demux);
    a ring drains — in arrival order of its capacity-th packet — when
    full, and partial rings flush at END in worker order.  Batch rows
    are padded to ``B = ceil(capacity / block_pkts) * block_pkts``.

    ``scales`` (n,) f32 marks a q8 round: payloads are then the int8
    wire rows and the schedule carries the per-packet scale column next
    to the weights (DESIGN.md §9); padding entries get scale 0.
    ``clients`` (n,) int32 is carried the same way (padding -1).
    """
    n = int(slots.shape[0])
    W = int(payloads.shape[1])
    B = ring_capacity + (-ring_capacity) % block_pkts
    pk_dtype = np.float32 if scales is None else np.int8
    if n == 0:
        return DrainSchedule(np.full((1, B), -1, np.int32),
                             np.zeros((1, B), np.float32),
                             np.zeros((1, B, W), pk_dtype), 0, 0,
                             np.full((1,), -1, np.int64),
                             None if scales is None
                             else np.zeros((1, B), np.float32),
                             None if clients is None
                             else np.full((1, B), -1, np.int32))
    if ring_assign == "slot":
        worker = slots.astype(np.int64) % n_workers
    else:
        worker = np.arange(n, dtype=np.int64) % n_workers
    pos = np.zeros(n, np.int64)
    for wk in range(n_workers):           # n_workers is tiny (paper: 5)
        m = worker == wk
        pos[m] = np.arange(int(m.sum()))
    b_in_w = pos // ring_capacity
    col = pos % ring_capacity
    key = worker * (n + 1) + b_in_w       # unique per (worker, batch)
    uniq, inv, sizes = np.unique(key, return_inverse=True,
                                 return_counts=True)
    last = np.zeros(len(uniq), np.int64)
    np.maximum.at(last, inv, np.arange(n, dtype=np.int64))
    full = sizes == ring_capacity
    # full batches drained at the arrival of their capacity-th packet
    # (chronological); partial rings flush after every arrival, in
    # worker order — uniq is sorted by (worker, batch) already, and a
    # worker has at most one partial ring
    order_key = np.where(full, last, n + uniq)
    order = np.argsort(order_key, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    row = rank[inv]
    nb = len(uniq)
    n_rows = (nb + (-nb) % pad_batches) if pad_batches > 1 else nb
    idx = np.full((n_rows, B), -1, np.int32)
    w = np.zeros((n_rows, B), np.float32)
    pk = np.zeros((n_rows, B, W), pk_dtype)
    idx[row, col] = slots
    w[row, col] = weights
    pk[row, col] = payloads
    sc = None
    if scales is not None:
        sc = np.zeros((n_rows, B), np.float32)
        sc[row, col] = scales
    cl = None
    if clients is not None:
        cl = np.full((n_rows, B), -1, np.int32)
        cl[row, col] = clients
    row_worker = np.full(n_rows, -1, np.int64)
    row_worker[rank] = uniq // (n + 1)            # batch key -> its worker
    return DrainSchedule(idx, w, pk, int(nb), n, row_worker, sc, cl)


def approx_lost_updates(sched: DrainSchedule, n_shards: int = 1
                        ) -> np.ndarray:
    """Per-shard count of approx-mode lost updates (race accounting).

    Within one drained batch every same-slot arrival beyond the last
    writer is lost in approx mode, so the loss of a batch is (weighted
    arrivals) − (distinct slots hit).  Batches go to shards by ring
    ownership (worker ``w`` -> shard ``w % n_shards``).
    """
    assert sched.workers is not None
    lost = np.zeros(n_shards, np.int64)
    live = sched.workers[:sched.n_batches]
    for r in range(sched.n_batches):
        valid = (sched.idx[r] >= 0) & (sched.weights[r] > 0)
        hits = int(valid.sum())
        distinct = len(np.unique(sched.idx[r][valid]))
        lost[int(live[r]) % n_shards] += hits - distinct
    return lost


def demux_events(cfg: EngineConfig, events: Iterable,
                 weights: Optional[np.ndarray] = None
                 ) -> Tuple[DrainSchedule, EngineStats, np.ndarray]:
    """Bulk RX: one pass over ``(Packet, payload)`` events, vectorized
    FSM gating + dedup, -> (schedule, stats, up_mask (K, N) numpy).

    Replicates ``ServerEngine.rx`` acceptance for client→server uplink
    streams: DATA is accepted iff it lands strictly between the client's
    first START and the first END after it, and only the first copy of
    each (client, slot) counts.  Control replies are *counted* (stats
    parity with the FSM) but not materialized.

    ``cfg.round_deadline`` closes the uplink barrier at that event
    position, exactly as the eager engine's rx does (DESIGN.md §8), and
    the ``min_clients`` quorum guard raises before any device work.
    """
    K, n_slots = cfg.n_clients, cfg.n_slots
    wts = (np.ones(K, np.float32) if weights is None
           else np.asarray(weights, np.float32))
    d_c: List[int] = []
    d_s: List[int] = []
    d_pay: List = []
    d_pos: List[int] = []
    d_q8: List[bool] = []
    d_sc: List[float] = []
    s_c: List[int] = []
    s_pos: List[int] = []
    e_c: List[int] = []
    e_pos: List[int] = []
    # local bindings keep the one unavoidable per-event pass cheap —
    # this loop and the payload stack are the whole host RX cost
    data_k, start_k, end_k = Kind.DATA, Kind.START, Kind.END
    dc_ap, ds_ap = d_c.append, d_s.append
    dpay_ap, dpos_ap = d_pay.append, d_pos.append
    dq_ap, dsc_ap = d_q8.append, d_sc.append
    pos = 0
    for packet, payload in events:
        kind = packet.kind
        if kind is data_k:
            dc_ap(packet.client)
            ds_ap(packet.index)
            dpay_ap(payload)
            dpos_ap(pos)
            dq_ap(packet.wire_dtype != "f32")
            dsc_ap(packet.scale)
        elif kind is start_k:
            s_c.append(packet.client)
            s_pos.append(pos)
        elif kind is end_k:
            e_c.append(packet.client)
            e_pos.append(pos)
        pos += 1
    inf = pos + 1
    # the uplink barrier closes at the deadline: events at pos >= cut are
    # past the close (cut = inf replays the no-deadline behavior)
    deadline_set = cfg.round_deadline is not None
    cut = cfg.round_deadline if deadline_set else inf
    first_start = np.full(K, inf, np.int64)
    if s_c:
        sc, sp = np.asarray(s_c), np.asarray(s_pos, np.int64)
        pre = sp < cut
        np.minimum.at(first_start, sc[pre], sp[pre])
    first_end = np.full(K, inf, np.int64)
    if e_c:
        ec, ep = np.asarray(e_c), np.asarray(e_pos, np.int64)
        after = (ep > first_start[ec]) & (ep < cut)
        np.minimum.at(first_end, ec[after], ep[after])
    stats = EngineStats()
    # clients short of their END at the close are this round's stragglers
    timed = (first_end >= inf) if deadline_set else np.zeros(K, bool)
    stats.stragglers_timed_out = int(np.sum(timed))
    check_quorum(int(np.sum(first_end < inf)), cfg.min_clients,
                 stats.stragglers_timed_out)
    if s_c:       # STARTs in any post-START phase are (re-)acked; a
                  # TIMED_OUT client's round is closed — no ack past cut
        stats.control_replies += int(np.sum(
            (sp >= first_start[sc]) & ~(timed[sc] & (sp >= cut))))
    if e_c:       # ENDs at/after the accepted END are (re-)acked, and a
                  # timed-out straggler's late END is grace-acked too
        stats.control_replies += int(np.sum(
            (ep >= first_end[ec]) | (timed[ec] & (ep >= cut))))
    up = np.zeros((K, n_slots), np.float32)
    if not d_c:
        sched = build_drain_schedule(
            np.zeros(0, np.int32), np.zeros(0, np.float32),
            np.zeros((0, cfg.payload), np.float32),
            n_workers=cfg.n_workers, ring_capacity=cfg.ring_capacity,
            ring_assign=cfg.ring_assign, clients=np.zeros(0, np.int32))
        return sched, stats, up
    dc = np.asarray(d_c, np.int64)
    ds = np.asarray(d_s, np.int64)
    dp = np.asarray(d_pos, np.int64)
    # every DATA packet past the deadline is late (the eager rx drops it
    # before the FSM gate); pre-deadline DATA outside its client's
    # START..END frame is phase-dropped
    pre = dp < cut
    stats.late_dropped = int(np.sum(~pre))
    # wire hardening (DESIGN.md §11): non-finite f32 payloads and
    # zero/negative/non-finite q8 scales are dropped between the
    # deadline gate and the FSM gate, before the dedup set — same
    # bucket order as the eager rx
    nd = len(d_c)
    bad = np.zeros(nd, bool)
    q8_arr = np.asarray(d_q8, bool)
    sc_arr = np.asarray(d_sc, np.float32)
    if q8_arr.any():
        qi = np.nonzero(q8_arr)[0]
        bad[qi] = ~(np.isfinite(sc_arr[qi]) & (sc_arr[qi] > 0))
    pos_in_f32 = np.full(nd, -1, np.int64)
    f32_stack = None
    fi = np.nonzero(~q8_arr & np.asarray(
        [p is not None for p in d_pay], bool))[0]
    if len(fi):
        f32_stack = np.asarray([d_pay[i] for i in fi], np.float32)
        bad[fi] = ~np.isfinite(f32_stack).all(axis=1)
        pos_in_f32[fi] = np.arange(len(fi))
    stats.malformed_dropped = int(np.sum(pre & bad))
    gate = pre & ~bad
    frame_ok = (dp > first_start[dc]) & (dp < first_end[dc])
    phase_ok = gate & frame_ok
    stats.phase_dropped = int(np.sum(gate & ~frame_ok))
    ok_rows = np.nonzero(phase_ok)[0]
    keys = dc[ok_rows] * n_slots + ds[ok_rows]
    _, first_idx = np.unique(keys, return_index=True)
    acc_rows = ok_rows[np.sort(first_idx)]        # arrival order preserved
    stats.duplicates_dropped = int(len(ok_rows) - len(first_idx))
    stats.data_enqueued = int(len(acc_rows))
    up[dc[acc_rows], ds[acc_rows]] = 1.0
    # stack only the *accepted* payload rows: dropped DATA may legally
    # carry no payload (the eager rx phase-drops before its assert)
    n_q8 = sum(d_q8[i] for i in acc_rows)
    scales_col = None
    if n_q8 == 0:
        pay = (f32_stack[pos_in_f32[acc_rows]]
               if len(acc_rows) else np.zeros((0, cfg.payload), np.float32))
    elif n_q8 == len(acc_rows):
        # homogeneous q8 round: the schedule stays int8 end to end and
        # the per-packet scale column rides beside the weights
        pay = np.asarray([d_pay[i] for i in acc_rows], np.int8)
        scales_col = np.asarray([d_sc[i] for i in acc_rows], np.float32)
    else:
        # mixed f32/q8 round: decode the q8 rows on the host into one f32
        # schedule (the same elementwise q * scale the q8 kernel applies)
        pay = np.stack([
            np.asarray(d_pay[i], np.int8).astype(np.float32)
            * np.float32(d_sc[i]) if d_q8[i]
            else np.asarray(d_pay[i], np.float32)
            for i in acc_rows])
    sched = build_drain_schedule(
        ds[acc_rows].astype(np.int32), wts[dc[acc_rows]],
        pay, n_workers=cfg.n_workers,
        ring_capacity=cfg.ring_capacity, ring_assign=cfg.ring_assign,
        scales=scales_col, clients=dc[acc_rows].astype(np.int32))
    stats.batches_drained = sched.n_batches
    return sched, stats, up


# ---------------------------------------------------------------------------
# Device: the whole round, no host sync inside
# ---------------------------------------------------------------------------

def _round_device(total: torch.Tensor, counts: torch.Tensor,
                  sched_idx: torch.Tensor, sched_w: torch.Tensor,
                  sched_pk: torch.Tensor,
                  sched_scales: Optional[torch.Tensor], prev_global,
                  client_flats, down_mask, *, mode: str, payload: int,
                  n_params: int, mix_alpha: float, agg_clip: bool = False,
                  clip_tau: float = 1.0):
    """One round on the device -> (total, counts, new_global,
    new_flats|None).

    total (S, W) / counts (S,) are updated in place (the reference
    donates them) by the drain fold, one round fold for all the rows;
    then the END divide with per-slot fallback and, when
    ``down_mask`` is given, the TX downlink fallback.  On the q8 wire
    ``sched_pk`` is int8 and each row is decoded inside the kernel.
    ``agg_clip`` (norm_clip mode) bounds each packet's weight first,
    elementwise per packet, so the numbers match the eager drains.
    """
    if agg_clip:
        sched_w = norm_clip_weights(sched_w, sched_pk, tau=clip_tau,
                                    scales=sched_scales)
    packet_scatter_accum_rounds(sched_idx, sched_w, sched_pk, total, counts,
                                sched_scales=sched_scales,
                                exact=(mode == "exact"))
    new_global = fallback_global(finalize_mean(total, counts), counts,
                                 prev_global, payload, n_params)
    new_flats = None
    if down_mask is not None:
        new_flats = downlink(new_global, client_flats, down_mask, payload,
                             n_params, mix_alpha)
    return total, counts, new_global, new_flats


def _robust_round_device(sched_idx: torch.Tensor, sched_w: torch.Tensor,
                         sched_pk: torch.Tensor,
                         sched_scales: Optional[torch.Tensor], prev_global,
                         client_flats, down_mask, *, payload: int,
                         n_params: int, n_slots: int, n_clients: int,
                         median: bool, beta: float, mix_alpha: float):
    """Robust table round (trimmed mean / median, DESIGN.md §11) ->
    (total, m, new_global, new_flats|None).

    The schedule carries the combined index ``slot*K + client`` and
    presence weight 1.0, so the fold writes each (slot, client) row of a
    freshly zeroed ``(S*K, W)`` table exactly once, as ``0 + 1.0*row``:
    on the card through the round fold (always exact: rows that never
    collide cannot race), on the CPU with
    one ``index_add_``; the bits are the same.  The table and its
    presence feed the rank-select finalize; its per-slot contributor
    count ``m`` takes the place of the mean path's counts (the same
    fallback), and ``total`` is the table's per-slot sum.
    """
    S, K = n_slots, n_clients
    dev = sched_idx.device
    acc = torch.zeros((S * K, payload), dtype=torch.float32, device=dev)
    cnt = torch.zeros((S * K,), dtype=torch.float32, device=dev)
    if dev.type == "cpu":
        packet_table_scatter(sched_idx, sched_w, sched_pk, acc, cnt,
                             sched_scales=sched_scales)
    else:
        packet_scatter_accum_rounds(sched_idx, sched_w, sched_pk, acc, cnt,
                                    sched_scales=sched_scales, exact=True)
    table = acc.view(S, K, payload)
    agg, m = robust_finalize(table, cnt.view(S, K), median=median,
                             beta=beta)
    new_global = fallback_global(agg, m, prev_global, payload, n_params)
    new_flats = None
    if down_mask is not None:
        new_flats = downlink(new_global, client_flats, down_mask, payload,
                             n_params, mix_alpha)
    return table.sum(dim=1), m, new_global, new_flats


def _combined_table_sched(sched: DrainSchedule,
                          n_clients: int) -> DrainSchedule:
    """Rewrite a drain schedule for the robust table fold (§11): slot
    index -> combined ``slot*K + client`` index, per-arrival FedAvg
    weight -> presence weight 1.0 (rank statistics are unweighted).
    Batch composition is untouched."""
    if sched.clients is None:
        raise ValueError("robust table modes need a client-tracked "
                         "schedule")
    valid = sched.idx >= 0
    idx2 = np.where(valid,
                    sched.idx.astype(np.int64) * n_clients
                    + sched.clients.astype(np.int64),
                    -1).astype(np.int32)
    return dataclasses.replace(sched, idx=idx2,
                               weights=valid.astype(np.float32))


def dispatch_round(cfg: EngineConfig, sched: DrainSchedule, total, counts,
                   prev_global, client_flats=None, down_mask=None,
                   mix_alpha: float = 0.0):
    """Queue one round on ``total``'s device -> (total', counts',
    new_global, new_flats|None).  ``total``/``counts`` are updated in
    place (the reference donates them).

    Only the schedule's real rows are copied to the device: the padding
    rows are inert.  ``agg_mode`` trimmed_mean / median route through
    the robust table round, which returns fresh ``(total, m)`` instead.
    """
    if cfg.mode not in ("exact", "approx"):
        raise ValueError(cfg.mode)
    dev = total.device
    if not cfg.use_kernel and dev.type != "cpu":
        raise ValueError("use_kernel=False (the sequential oracle) runs on "
                         "the CPU only")
    robust_table = cfg.agg_mode in ("trimmed_mean", "median")
    if robust_table:
        sched = _combined_table_sched(sched, cfg.n_clients)
    nb = sched.n_batches
    rows = lambda a: torch.from_numpy(a[:nb]).to(dev)
    idx, w, pk = rows(sched.idx), rows(sched.weights), rows(sched.payloads)
    sc = None if sched.scales is None else rows(sched.scales)
    if robust_table:
        return _robust_round_device(
            idx, w, pk, sc, prev_global, client_flats, down_mask,
            payload=cfg.payload, n_params=cfg.n_params,
            n_slots=cfg.n_slots, n_clients=cfg.n_clients,
            median=(cfg.agg_mode == "median"), beta=float(cfg.trim_beta),
            mix_alpha=float(mix_alpha))
    return _round_device(
        total, counts, idx, w, pk, sc, prev_global, client_flats, down_mask,
        mode=cfg.mode, payload=cfg.payload, n_params=cfg.n_params,
        mix_alpha=float(mix_alpha),
        agg_clip=(cfg.agg_mode == "norm_clip"),
        clip_tau=float(cfg.clip_tau))


# ---------------------------------------------------------------------------
# Drivers: single round, and double-buffered multi-round overlap
# ---------------------------------------------------------------------------

def _zero_state(cfg: EngineConfig, dev: torch.device):
    return (torch.zeros((cfg.n_slots, cfg.payload), dtype=torch.float32,
                        device=dev),
            torch.zeros((cfg.n_slots,), dtype=torch.float32, device=dev))


def run_compiled_round(cfg: EngineConfig, client_flats, prev_global,
                       events: Iterable, down_mask=None, weights=None,
                       mix_alpha: float = 0.0, device=None) -> RoundResult:
    """Compiled counterpart of ``server.run_engine_round``: bulk demux,
    then the whole round — drains, END, TX — queued on the device.
    ``device=None`` is the CUDA device."""
    dev = resolve_device(device)
    # named spans, so a profiled round splits into host demux and enqueue
    with record_function("demux_events"):
        sched, stats, up = demux_events(cfg, events, weights)
    with record_function("dispatch_round"):
        total, counts = _zero_state(cfg, dev)
        _, counts, new_global, new_flats = dispatch_round(
            cfg, sched, total, counts, prev_global,
            client_flats=None if down_mask is None else client_flats,
            down_mask=down_mask, mix_alpha=mix_alpha)
    return RoundResult(new_global, counts, torch.from_numpy(up).to(dev),
                       new_flats, stats)


def _wait(done: Optional[torch.cuda.Event]) -> None:
    if done is not None:
        done.synchronize()


def run_compiled_rounds(cfg: EngineConfig, rounds: Iterable,
                        prev_global, *, weights=None,
                        mix_alpha: float = 0.0,
                        device=None) -> List[RoundResult]:
    """Double-buffered multi-round driver (the paper's pipelined cores).

    ``rounds`` yields ``(events, client_flats, down_mask)`` per round
    (``client_flats``/``down_mask`` may be None).  Round r is queued on
    the device and, while the device runs it, round r+1's demux runs on
    the host; each round's ``prev_global`` chains from the previous
    round's device-resident ``new_global``.  Results are collected one
    round behind dispatch.  A round that misses quorum raises
    ``QuorumError`` carrying the completed rounds as ``e.results``.
    """
    dev = resolve_device(device)
    results: List[RoundResult] = []
    prev = as_tensor(prev_global, dev)
    pending: Optional[RoundResult] = None
    done: Optional[torch.cuda.Event] = None
    for events, client_flats, down_mask in rounds:
        try:
            sched, stats, up = demux_events(cfg, events, weights)
        except QuorumError as e:
            if pending is not None:
                _wait(done)
                results.append(pending)
            e.results = results
            raise
        if pending is not None:       # round r-1 ran while we demuxed
            _wait(done)
            results.append(pending)
        total, counts = _zero_state(cfg, dev)
        _, counts, new_global, new_flats = dispatch_round(
            cfg, sched, total, counts, prev,
            client_flats=None if down_mask is None else client_flats,
            down_mask=down_mask, mix_alpha=mix_alpha)
        pending = RoundResult(new_global, counts,
                              torch.from_numpy(up).to(dev), new_flats, stats)
        done = None
        if dev.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
        prev = new_global
    if pending is not None:
        _wait(done)
        results.append(pending)
    return results
