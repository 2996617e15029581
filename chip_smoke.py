#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit, torch's device
   name and count) and turns TF32 off, so the plain versions' matmuls
   and the CNN's convolutions run in full f32.
2. Builds every kernel library of ``src/repro_torch/csrc`` with ``nvcc``
   into ``build/``, one ``nvcc`` per source, all started together, and
   prints each build's time and ptxas report.
3. The scatter-accumulate kernels at the packet path's shapes (f32:
   S=12,495 slots x W=367, q8: S=3,133 x W=1,464).  The per-drain
   kernel on drained rings of 64 packets (the eager engine's), exact and
   approx, against its plain version: bitwise on integer and Gaussian
   payloads; timed beside its plain version and ``index_add_``.  The
   round fold on the real drain schedules of phase 4's f32 and q8
   streams (their index and weight columns, Gaussian payloads and
   scales), exact and approx: kernel == plain slot-major version == the
   per-batch kernel run row by row, bit for bit, and two runs alike;
   timed beside the row-by-row loop it replaced, its plain version,
   one ``index_add_`` of the round's weighted decoded real rows, and its
   bound.  Device time per call (``torch.profiler``) and back-to-back
   call time (CUDA events).
4. The packet path at the paper model's width (K=10 clients,
   P=4,585,546 parameters, 5 workers, ring capacity 64, 1% loss, 2%
   duplicates, shuffled): ``run_engine_round`` eager and compiled, f32
   and q8, exact and approx, then ``run_compiled_rounds`` over 3
   chained rounds.  Checks eager == compiled bitwise (integer
   payloads), the stats' conservation, that each compiled round made
   one round fold and no per-batch launch and each eager round one
   per-drain launch per drained ring, that the compiled round equals
   the same schedule folded by the plain versions, and that every
   output is finite.  Prints round time, packets/s and peak device
   memory.
5. Where a packet-path round's time goes: ``run_engine_round`` under the
   profiler; the compiled round's host demux and enqueue from the
   port's named spans, and the device's busy time.
6. The robust finalize and placement kernels: ``robust_finalize``
   against its plain version on the robust round's client tables (f32:
   12,495 x 10 x 367, q8: 3,133 x 10 x 1,464; trimmed mean, beta 0.2,
   and median; ~1% of the rows absent): bitwise on integer tables, max
   abs error on Gaussian ones; ``packet_scatter`` against its plain
   version on one client's downlink (12,495 slots, 5% lost, 2%
   duplicates) and on 124,950 rows (a permutation of the table's rows,
   2% duplicates), f32 and int8, with and without ``init``: bitwise.
   Times each at its path's shape beside its bound, its plain version,
   and ``index_copy_`` or, for the finalize, the sort-based twin
   (several calls) and, for the median, ``torch.nanquantile`` (one
   call; checked against the kernel to rtol 1e-6).
7. The robust round at paper width: ``trimmed_mean``, ``median`` and
   ``norm_clip`` (tau at half the median row norm, so the clip is
   active), f32 and q8, eager and compiled, on the packet path's
   streams.  Checks eager == compiled and compiled == the same round
   with every kernel replaced by its plain version, bit for bit; the
   stats' conservation and counts; that each compiled round made one
   round fold, eager norm clip one per-drain launch per drained ring
   (the eager trimmed mean and median fill their client table on the
   host), and ``robust_finalize`` ran once per trimmed-mean or median
   round.  Prints round time and peak device memory, then each compiled
   round under the profiler (device busy, kernel times, idle share).
   The clients' side of the f32 rounds' downlink goes through
   ``ops.packet_scatter`` and must reproduce the engine's client state.
8. The attack driver: ``run_churn_rounds`` at paper width, 3 rounds
   with churn, stragglers, loss and duplicates and one 1e4x scale
   attacker; the trimmed mean must stay within 20 of the honest mean and
   the mean must leave it by over 100.
9. Holds the FedAvg accumulation kernels (``fedavg_accum`` on f32 and
   bf16 payloads, ``quantized_accum`` on int8; finalize on and off; the
   ``into`` fold) against their plain versions at the training loop's
   shapes (K=10, C=12,495, W=367), at the same tolerances, and times
   them beside their plain versions, ``torch.einsum`` and the bound.
10. The FedAvg training loop: ``run_fedavg`` trains the paper CNN at
   full width (K=10, batch 64, one local epoch, synthetic data): exact
   at 5,000 samples per client, int8 and approx (conflict rate 0.005,
   4.68% downlink loss) at 1,000, 3 rounds each.  Checks finite losses,
   a falling exact test loss, and one launch of ``fedavg_accum`` per
   exact round and of ``quantized_accum`` per int8 round.  Prints each
   round's local-training and aggregation seconds and peak device
   memory from ``run_fedavg``'s history.  Then two one-round exact runs
   at 5,000 samples per client under the profiler, each read inside its
   ``local_training`` span (the device's busy time and idle share, the
   top kernels), and one paper-width ``fused_round_step`` on integer
   flats through the kernels equals the same step through the plain
   versions, bitwise.
11. Prints the card's ``nvidia-smi`` line, the ``{"kernels": [...]}``
   line and, last, the ``{"ok": true, ...}`` line.  Any failed check
   raises before them.

Exits non-zero without a CUDA device, and outside a checkout of the
repository.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet; at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

K_CLIENTS = 10
N_WORKERS = 5
RING_CAPACITY = 64
LOSS, DUP = 0.01, 0.02
DOWN_LOSS = 0.05
SEED = 0


def device_info() -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return {"nvidia_smi": smi[0], "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


# ---------------------------------------------------------------------------
# Kernel vs plain version at the main path's shapes
# ---------------------------------------------------------------------------

def make_batch(rng, dev, n_slots, width, q8, integer, n_real=64, n=64):
    """One drained ring as the eager engine folds it: ``n_real`` packets
    (a few slots hit twice, one with weight 0), padded to ``n`` with
    inert rows, plus a live accumulator."""
    slots = rng.choice(n_slots, n_real, replace=False)
    slots[1::9] = slots[0::9][:len(slots[1::9])]     # same-slot collisions
    idx = np.full(n, -1, np.int32)
    idx[:n_real] = slots
    w = np.zeros(n, np.float32)
    w[:n_real] = rng.integers(1, 4, n_real)
    w[5] = 0.0                                       # inert arrival
    if q8:
        pk = np.zeros((n, width), np.int8)
        pk[:n_real] = rng.integers(-127, 128, (n_real, width))
        sc = np.zeros(n, np.float32)
        sc[:n_real] = (2.0 ** rng.integers(-6, 0, n_real) if integer
                       else rng.uniform(1e-3, 1e-1, n_real))
    else:
        pk = np.zeros((n, width), np.float32)
        pk[:n_real] = (rng.integers(-8, 9, (n_real, width)) if integer
                       else rng.normal(size=(n_real, width)))
        sc = None
    acc = (rng.integers(-8, 9, (n_slots, width)) if integer
           else rng.normal(size=(n_slots, width))).astype(np.float32)
    cnt = rng.integers(0, 3, n_slots).astype(np.float32)
    t = lambda a: None if a is None else torch.from_numpy(a).to(dev)
    return dict(packets=t(pk), scales=t(sc), idx=t(idx), weights=t(w),
                acc=t(acc), counts=t(cnt))


def kernel_call(b, exact, plain=False):
    """Run the kernel (in place on b's acc/counts) or the plain version
    (functional) on batch ``b``."""
    from repro_torch.kernels import packet_scatter as ps
    if b["scales"] is None:
        fn = ps.packet_scatter_accum_plain if plain else ps.packet_scatter_accum
        return fn(b["packets"], b["idx"], b["weights"], b["acc"],
                  b["counts"], exact=exact)
    fn = (ps.packet_scatter_accum_q8_plain if plain
          else ps.packet_scatter_accum_q8)
    return fn(b["packets"], b["scales"], b["idx"], b["weights"], b["acc"],
              b["counts"], exact=exact)


def compare_kernel(rng, dev, n_slots, width, q8, exact, integer) -> float:
    """Kernel vs plain on one batch -> max |kernel - plain| (raises on a
    mismatch: bitwise for integer data, rtol 1e-5 / atol 1e-6 else)."""
    b = make_batch(rng, dev, n_slots, width, q8, integer)
    a_ref, c_ref = kernel_call(b, exact, plain=True)
    a, c = kernel_call({**b, "acc": b["acc"].clone(),
                        "counts": b["counts"].clone()}, exact)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    for got, want, name in ((a, a_ref, "acc"), (c, c_ref, "counts")):
        if integer:
            torch.testing.assert_close(got, want, rtol=0, atol=0,
                                       msg=lambda m: f"{name}: {m}")
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6,
                                       msg=lambda m: f"{name}: {m}")
    return float((a - a_ref).abs().max())


def time_ms(fn, iters=200, warmup=20) -> float:
    """Mean time of ``fn()`` in ms over ``iters`` back-to-back calls,
    CUDA events around the run, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def fold_bound(n_rows, n_acc_rows, width, q8) -> tuple:
    """Least time (ms) the card could take to fold ``n_rows`` payload
    rows into ``n_acc_rows`` accumulator rows, and what bounds it: each
    payload row, its idx and weight (and q8 scale) read once, each hit
    accumulator row and count read and written once; 2 operations
    (multiply, add) per payload element, 3 on the q8 wire (decode)."""
    elem = 1 if q8 else 4
    nbytes = (n_rows * (width * elem + 8 + (4 if q8 else 0))
              + n_acc_rows * (width + 1) * 4 * 2)
    ops = n_rows * width * (3 if q8 else 2)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def batch_bound(b) -> tuple:
    """``fold_bound`` of one batch: its real rows and the slots they hit."""
    real = b["idx"] >= 0
    return fold_bound(int(real.sum()),
                      int(torch.unique(b["idx"][real]).numel()),
                      b["acc"].shape[1], b["scales"] is not None)


def device_ms(fn, calls=50) -> float:
    """Device time of one ``fn()`` in ms: the sum of the device times
    ``torch.profiler`` records for ``calls`` calls, over ``calls``.
    None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    return total_us / 1e3 / calls if total_us > 0 else None


def device_split(fn, calls=20) -> dict:
    """Device time (us) per call of each kernel or memset ``fn`` runs, by
    name (the kernels of csrc/packet_scatter.cu by their short name)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.self_device_time_total <= 0:
            continue
        name = next((k for k in FOLD_KERNELS if k + "<" in e.key
                     or k + "(" in e.key), e.key[:40])
        out[name] = out.get(name, 0.0) + e.self_device_time_total / calls
    return out


def timed(fns: dict, iters=200, warmup=20, calls=50) -> dict:
    """``key + call_ms`` (CUDA events, ``iters`` calls back to back),
    ``key + device_ms`` (profiler, ``calls`` calls) and ``key + ms``
    (device time, else call time) for each ``key: fn``."""
    out = {}
    for key, fn in fns.items():
        out[key + "call_ms"] = time_ms(fn, iters=iters, warmup=warmup)
        out[key + "device_ms"] = device_ms(fn, calls=calls)
        out[key + "ms"] = (out[key + "device_ms"]
                           if out[key + "device_ms"] is not None
                           else out[key + "call_ms"])
    return out


def time_kernel(rng, dev, n_slots, width, q8) -> dict:
    """The per-drain kernel (exact and approx), its plain version and
    ``index_add_`` on one drained ring of 64 packets: device time per
    call (profiler) and the time of a call back to back with the next
    (CUDA events; the host's launch cost when it exceeds the device's)."""
    b = make_batch(rng, dev, n_slots, width, q8, integer=False)
    real = b["idx"] >= 0
    ridx = b["idx"][real].long()
    w = b["weights"][real][:, None]
    rows = b["packets"][real].float()
    if q8:
        rows = rows * b["scales"][real][:, None]
    src = (w * rows).contiguous()
    acc = b["acc"]
    fns = {
        "": lambda: kernel_call(b, True),
        "approx_": lambda: kernel_call(b, False),
        "plain_": lambda: kernel_call(b, True, plain=True),
        # the library yardstick, exact mode: one index_add_ of the
        # weighted (decoded) rows, built outside the timed call
        "library_": lambda: acc.index_add_(0, ridx, src),
    }
    out = timed(fns)
    out["bound_ms"], out["bound_by"] = batch_bound(b)
    return out


# ---------------------------------------------------------------------------
# The round fold on a real drain schedule
# ---------------------------------------------------------------------------

def round_schedule(rng, dev, cfg, events, weights, q8) -> dict:
    """The real rows of the compiled round's drain schedule of ``events``
    on the card: its index and weight columns as demuxed, Gaussian f32
    payloads (q8: random int8 rows and scales in [1e-3, 1e-1]) in place of
    the stream's integer ones, and a Gaussian accumulator."""
    from repro_torch.core.engine_compiled import demux_events
    sched, _, _ = demux_events(cfg, events, weights)
    nb = sched.n_batches
    R, B = nb, sched.idx.shape[1]
    W = cfg.payload
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if q8:
        pk = t(rng.integers(-127, 128, (R, B, W)).astype(np.int8))
        sc = t(rng.uniform(1e-3, 1e-1, (R, B)).astype(np.float32)
               * (sched.scales[:nb] > 0))
    else:
        pk = t(rng.normal(size=(R, B, W)).astype(np.float32))
        sc = None
    return {"idx": t(sched.idx[:nb]), "weights": t(sched.weights[:nb]),
            "packets": pk, "scales": sc,
            "acc": t(rng.normal(size=(cfg.n_slots, W)).astype(np.float32)),
            "counts": torch.zeros(cfg.n_slots, device=dev)}


def fold_round(r, acc, counts, exact=True, how="kernel"):
    """Fold schedule ``r`` into (acc, counts): the round kernel (in
    place), the plain slot-major version (functional), or the per-batch
    kernel launched once per schedule row (in place) -- the loop the
    round kernel replaced, kept here as its yardstick."""
    from repro_torch.kernels import packet_scatter as ps
    idx, w, pk, sc = r["idx"], r["weights"], r["packets"], r["scales"]
    if how == "kernel":
        return ps.packet_scatter_accum_rounds(idx, w, pk, acc, counts,
                                              sched_scales=sc, exact=exact)
    if how == "plain":
        return ps.packet_scatter_accum_rounds_plain(
            idx, w, pk, acc, counts, sched_scales=sc, exact=exact)
    for row in range(idx.shape[0]):
        if sc is None:
            ps.packet_scatter_accum(pk[row], idx[row], w[row], acc, counts,
                                    exact=exact)
        else:
            ps.packet_scatter_accum_q8(pk[row], sc[row], idx[row], w[row],
                                       acc, counts, exact=exact)
    return acc, counts


def compare_round_fold(r) -> float:
    """Round kernel == plain slot-major == per-batch kernel row by row,
    and two kernel runs alike, bit for bit, exact and approx (raises
    otherwise).  -> 0.0, the max abs error."""
    for exact in (True, False):
        want = fold_round(r, r["acc"], r["counts"], exact, "plain")
        got = [fold_round(r, r["acc"].clone(), r["counts"].clone(), exact,
                          how) for how in ("kernel", "kernel", "rows")]
        sync(r["acc"].device)
        for (a, c), how in zip(got, ("kernel", "kernel again", "rows")):
            assert torch.equal(a, want[0]) and torch.equal(c, want[1]), (
                f"round fold exact={exact}: {how} != plain")
    return 0.0


def time_round_fold(r) -> dict:
    """The round kernel (exact and approx), the per-row loop it replaced,
    its plain version and one ``index_add_`` of the round's weighted,
    decoded real rows (built outside the timed call), each on schedule
    ``r``; its bound over the schedule's real rows and hit slots."""
    idx, w, pk, sc = r["idx"], r["weights"], r["packets"], r["scales"]
    acc, cnt = r["acc"].clone(), r["counts"].clone()
    real = idx >= 0
    ridx = idx[real].long()
    rows = pk[real].float()
    if sc is not None:
        rows = rows * sc[real][:, None]
    src = (w[real][:, None] * rows).contiguous()
    del rows
    out = timed({
        "": lambda: fold_round(r, acc, cnt),
        "approx_": lambda: fold_round(r, acc, cnt, exact=False),
        "library_": lambda: acc.index_add_(0, ridx, src),
    }, iters=50, warmup=5, calls=20)
    out.update(timed({
        "plain_": lambda: fold_round(r, r["acc"], r["counts"], how="plain"),
        "rows_": lambda: fold_round(r, acc, cnt, how="rows"),
    }, iters=3, warmup=1, calls=2))
    out["split_us"] = device_split(lambda: fold_round(r, acc, cnt))
    out["bound_ms"], out["bound_by"] = fold_bound(
        int(real.sum()), int(torch.unique(ridx).numel()), acc.shape[1],
        sc is not None)
    out.update(rows=idx.shape[0], batch=idx.shape[1],
               real_packets=int(real.sum()))
    return out


# ---------------------------------------------------------------------------
# The main path at paper width
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Workload:
    """One paper-width round's inputs, host side (numpy)."""
    flats: np.ndarray        # (K, P) client state, integer-valued f32
    prev: np.ndarray         # (P,) previous global
    weights: np.ndarray      # (K,) FedAvg weights
    down: np.ndarray         # (K, N) downlink arrival mask
    pk: np.ndarray           # (K, N, W) wire payloads (f32 or int8)
    scales: np.ndarray       # (K, N) q8 scales, or None


def make_workload(rng, n_clients, n_params, q8) -> Workload:
    from repro_torch.core.packets import (PAYLOAD_F32, PAYLOAD_Q8,
                                          PacketizedShape)
    W = PAYLOAD_Q8 if q8 else PAYLOAD_F32
    N = PacketizedShape(n_params, W).n_packets
    flats = rng.integers(-8, 9, (n_clients, n_params)).astype(np.float32)
    prev = rng.integers(-8, 9, n_params).astype(np.float32)
    weights = rng.integers(1, 4, n_clients).astype(np.float32)
    down = (rng.random((n_clients, N)) >= DOWN_LOSS).astype(np.float32)
    if q8:
        # power-of-two scales keep every sum exact: bitwise checks hold
        pk = rng.integers(-127, 128, (n_clients, N, W)).astype(np.int8)
        scales = (2.0 ** rng.integers(-6, 0, (n_clients, N))).astype(
            np.float32)
    else:
        pk = np.zeros((n_clients, N * W), np.float32)
        pk[:, :n_params] = flats
        pk = pk.reshape(n_clients, N, W)
        scales = None
    return Workload(flats, prev, weights, down, pk, scales)


def count_data(events) -> int:
    from repro_torch.core.protocol import Kind
    return sum(p.kind is Kind.DATA for p, _ in events)


def check_round(res, events, wl: Workload, cfg) -> None:
    """Conservation and finiteness of one round's result."""
    s = res.stats
    n_data = count_data(events)
    buckets = (s.data_enqueued + s.duplicates_dropped + s.phase_dropped
               + s.late_dropped + s.malformed_dropped)
    assert buckets == n_data, (buckets, n_data)
    up = res.up_mask.cpu().numpy()
    assert s.data_enqueued == int(up.sum()), (s.data_enqueued, up.sum())
    want = (up * wl.weights[:, None]).sum(axis=0)
    np.testing.assert_array_equal(res.counts.cpu().numpy(), want)
    for name in ("new_global", "new_client_flats"):
        t = getattr(res, name)
        assert t is not None and bool(torch.isfinite(t).all()), name
    assert tuple(res.new_global.shape) == (cfg.n_params,)
    assert tuple(res.new_client_flats.shape) == (cfg.n_clients,
                                                 cfg.n_params)


def assert_same(a, b, what) -> None:
    for name in ("new_global", "counts", "up_mask", "new_client_flats"):
        x, y = getattr(a, name), getattr(b, name)
        assert torch.equal(x, y), f"{what}: {name} differs"
    assert a.stats == b.stats, (what, a.stats, b.stats)


def plain_round(cfg, events, wl: Workload, dev):
    """The compiled round's schedule folded by the plain versions on
    ``dev`` (no kernel launch), then the port's END and TX."""
    from repro_torch.core import engine_compiled as ec
    from repro_torch.core.server import RoundResult, downlink, \
        fallback_global
    from repro_torch.core.pipeline import finalize_mean
    from repro_torch.kernels import packet_scatter as ps
    sched, stats, up = ec.demux_events(cfg, events, wl.weights)
    acc = torch.zeros((cfg.n_slots, cfg.payload), device=dev)
    cnt = torch.zeros((cfg.n_slots,), device=dev)
    t = lambda a: torch.from_numpy(a).to(dev)
    for r in range(sched.n_batches):
        if sched.scales is None:
            acc, cnt = ps.packet_scatter_accum_plain(
                t(sched.payloads[r]), t(sched.idx[r]), t(sched.weights[r]),
                acc, cnt, exact=(cfg.mode == "exact"))
        else:
            acc, cnt = ps.packet_scatter_accum_q8_plain(
                t(sched.payloads[r]), t(sched.scales[r]), t(sched.idx[r]),
                t(sched.weights[r]), acc, cnt, exact=(cfg.mode == "exact"))
    g = fallback_global(finalize_mean(acc, cnt), cnt, wl.prev, cfg.payload,
                        cfg.n_params)
    flats = downlink(g, wl.flats, wl.down, cfg.payload, cfg.n_params)
    return RoundResult(g, cnt, t(up), flats, stats)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def path_streams(n_clients, n_params):
    """The main path's f32 and q8 rounds: per wire a workload and its
    uplink stream, from ``SEED`` -> ([(wire, workload, events)], the
    generator, to go on drawing from)."""
    from repro_torch.core.server import make_uplink_stream
    rng = np.random.default_rng(SEED)
    out = []
    for wire in ("f32", "q8"):
        wl = make_workload(rng, n_clients, n_params, q8=(wire == "q8"))
        events, _ = make_uplink_stream(rng, wl.pk, loss_rate=LOSS,
                                       dup_rate=DUP, scales=wl.scales)
        out.append((wire, wl, events))
    return out, rng


def path_config(wl: Workload, mode="exact", compiled=True):
    from repro_torch.core.server import EngineConfig
    return EngineConfig(n_clients=wl.flats.shape[0],
                        n_params=wl.flats.shape[1], payload=wl.pk.shape[2],
                        n_workers=N_WORKERS, ring_capacity=RING_CAPACITY,
                        mode=mode, compile=compiled)


FOLD_COUNTERS = ("packet_scatter_accum", "packet_scatter_accum_q8",
                 "packet_scatter_accum_rounds")


def fold_counts() -> dict:
    from repro_torch.kernels import packet_scatter as ps
    return {name: getattr(ps, name).launches for name in FOLD_COUNTERS}


def fold_rise(before: dict) -> tuple:
    """(per-drain f32, per-batch q8, round fold) launches since
    ``before``."""
    now = fold_counts()
    return tuple(now[k] - before[k] for k in FOLD_COUNTERS)


def main_path(dev, streams, rng, log=print) -> dict:
    """Drive the port's entry points on ``path_streams``' rounds; every
    check raises on failure.  -> per-round rows and the launch counts:
    the per-drain kernel's, and the round folds per wire."""
    from repro_torch.core.server import make_uplink_stream, run_engine_round
    from repro_torch.core.engine_compiled import run_compiled_rounds
    from repro_torch.kernels import packet_scatter as ps
    rows = []
    for name in FOLD_COUNTERS:
        getattr(ps, name).launches = 0
    rounds_by_wire = {"f32": 0, "q8": 0}
    for wire, wl, events in streams:
        n_data = count_data(events)
        for mode in ("exact", "approx"):
            results = {}
            for compiled in (False, True):
                cfg = path_config(wl, mode, compiled)
                before = fold_counts()
                if dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(dev)
                sync(dev)
                t0 = time.perf_counter()
                res = run_engine_round(cfg, wl.flats, wl.prev, events,
                                       down_mask=wl.down,
                                       weights=wl.weights, device=dev)
                sync(dev)
                dt = time.perf_counter() - t0
                rise = fold_rise(before)
                check_round(res, events, wl, cfg)
                # compiled: one round fold; eager: the per-drain kernel
                # once per ring (the q8 rows are decoded at RX)
                want = ((0, 0, 1) if compiled
                        else (res.stats.batches_drained, 0, 0))
                if dev.type == "cuda":
                    assert rise == want, (wire, mode, compiled, rise, want)
                rounds_by_wire[wire] += rise[2]
                launches = sum(rise)
                results[compiled] = res
                row = {"wire": wire, "mode": mode,
                       "engine": "compiled" if compiled else "eager",
                       "round_s": dt, "data_packets": n_data,
                       "packets_per_s": n_data / dt,
                       "batches": res.stats.batches_drained,
                       "launches": launches,
                       "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                                          if dev.type == "cuda" else None)}
                rows.append(row)
                log(json.dumps(row))
            assert_same(results[False], results[True],
                        f"eager vs compiled {wire} {mode}")
            plain = plain_round(cfg, events, wl, dev)
            assert_same(results[True], plain, f"plain vs compiled {wire} {mode}")
    # three chained compiled rounds through the double-buffered driver
    n_clients, n_params = streams[0][1].flats.shape
    wl = make_workload(rng, n_clients, n_params, q8=False)
    cfg = path_config(wl)
    streams = [make_uplink_stream(rng, wl.pk, loss_rate=LOSS,
                                  dup_rate=DUP)[0] for _ in range(3)]
    before = fold_counts()
    sync(dev)
    t0 = time.perf_counter()
    chained = run_compiled_rounds(
        cfg, [(ev, wl.flats, wl.down) for ev in streams], wl.prev,
        weights=wl.weights, device=dev)
    sync(dev)
    dt = time.perf_counter() - t0
    rise = fold_rise(before)
    prev = wl.prev
    for ev, res in zip(streams, chained):
        check_round(res, ev, dataclasses.replace(wl, prev=prev), cfg)
        one = run_engine_round(cfg, wl.flats, prev, ev, down_mask=wl.down,
                               weights=wl.weights, device=dev)
        assert_same(res, one, "chained vs single compiled round")
        prev = res.new_global
    n_data = sum(count_data(ev) for ev in streams)
    if dev.type == "cuda":
        assert rise == (0, 0, 3), rise
    rounds_by_wire["f32"] += rise[2]
    row = {"wire": "f32", "mode": "exact", "engine": "compiled_rounds x3",
           "round_s": dt / 3, "data_packets": n_data,
           "packets_per_s": n_data / dt, "launches": sum(rise)}
    rows.append(row)
    log(json.dumps(row))
    return {"rows": rows,
            "launches": {"packet_scatter_accum":
                         ps.packet_scatter_accum.launches,
                         "packet_scatter_accum_rounds": rounds_by_wire["f32"],
                         "packet_scatter_accum_rounds_q8":
                         rounds_by_wire["q8"]}}


# the kernels of csrc/packet_scatter.cu: the per-drain kernel and the
# round fold's four passes
FOLD_KERNELS = ("batch_kernel", "count_hits", "scan_offsets", "fill_hits",
                "fold_kernel")


def is_fold_kernel(key: str) -> bool:
    return any(k + "<" in key or k + "(" in key for k in FOLD_KERNELS)


def round_breakdown(dev, n_clients, n_params, log=print) -> list:
    """Where one paper-width round's time goes: ``run_engine_round``
    under the profiler.  Compiled rounds split into host demux and
    enqueue (H2D copies + launches) by the port's named spans; both
    engines get the device's busy time, kernel and H2D shares."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.server import EngineConfig, make_uplink_stream, \
        run_engine_round
    rng = np.random.default_rng(SEED + 1)
    rows = []
    for wire in ("f32", "q8"):
        wl = make_workload(rng, n_clients, n_params, q8=(wire == "q8"))
        events, _ = make_uplink_stream(rng, wl.pk, loss_rate=LOSS,
                                       dup_rate=DUP, scales=wl.scales)
        for compiled in (True, False):
            cfg = EngineConfig(n_clients=n_clients, n_params=n_params,
                               payload=wl.pk.shape[2], n_workers=N_WORKERS,
                               ring_capacity=RING_CAPACITY, compile=compiled)
            # host spans only for the compiled round: the eager round's
            # per-packet torch ops would each become a profiler event
            acts = ([ProfilerActivity.CPU] if compiled or dev.type == "cpu"
                    else [])
            if dev.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            sync(dev)
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                res = run_engine_round(cfg, wl.flats, wl.prev, events,
                                       down_mask=wl.down, weights=wl.weights,
                                       device=dev)
                t2 = time.perf_counter()
                sync(dev)
                t3 = time.perf_counter()
            evs = prof.events()
            # device work: kernels, copies, fills; not the device-side
            # copies of the named host spans
            on_dev = [e for e in evs if e.device_type != DeviceType.CPU
                      and not getattr(e, "is_user_annotation", False)]
            busy = sum(e.self_device_time_total for e in on_dev) / 1e6
            kern = sum(e.self_device_time_total for e in on_dev
                       if is_fold_kernel(e.key)) / 1e6
            h2d = sum(e.self_device_time_total for e in on_dev
                      if "HtoD" in e.key) / 1e6
            row = {"wire": wire, "engine": "compiled" if compiled else "eager",
                   "round_s": t3 - t0, "wait_s": t3 - t2,
                   "device_busy_s": busy, "kernel_s": kern, "h2d_s": h2d,
                   "device_idle_share": 1 - busy / (t3 - t0)}
            if compiled:
                spans = {name: sum(e.cpu_time_total for e in evs
                                   if e.key == name
                                   and e.device_type == DeviceType.CPU) / 1e6
                         for name in ("demux_events", "dispatch_round")}
                bound_ms, _ = fold_bound(res.stats.data_enqueued,
                                         int((res.counts > 0).sum()),
                                         cfg.payload, wire == "q8")
                row.update(demux_s=spans["demux_events"],
                           enqueue_s=spans["dispatch_round"],
                           fold_bound_s=bound_ms / 1e3)
            rows.append(row)
            log(json.dumps(row))
    return rows


# ---------------------------------------------------------------------------
# FedAvg accumulation kernels (#3, #4) at the training loop's shapes
# ---------------------------------------------------------------------------

def accum_inputs(rng, dev, K, C, W, kind, integer) -> dict:
    """One server step's aggregation inputs: (K, C, W) payloads (f32,
    bf16 or int8 with (K, C) scales) and a (K, C) weighted mask with 5%
    uplink loss and n_k weights.  Integer payloads (q8: power-of-two
    scales) keep every f32 sum exact."""
    m = ((rng.random((K, C)) >= 0.05)
         * rng.integers(1, 4, (K, 1))).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)
    if kind == "int8":
        q = rng.integers(-127, 128, (K, C, W)).astype(np.int8)
        s = ((2.0 ** rng.integers(-6, 0, (K, C))) if integer
             else rng.random((K, C)) / 127).astype(np.float32)
        return {"q": t(q), "scales": t(s), "wmask": t(m)}
    x = (rng.integers(-8, 9, (K, C, W)) if integer
         else rng.normal(size=(K, C, W))).astype(np.float32)
    x = t(x)
    if kind == "bf16":
        x = x.to(torch.bfloat16)
    return {"packets": x, "wmask": t(m)}


def accum_call(inp, finalize=True, plain=False):
    """The kernel wrapper (or its plain version) on ``inp``."""
    from repro_torch.kernels import fedavg_accum as fa
    from repro_torch.kernels import quantized_accum as qa
    if "q" in inp:
        fn = qa.quantized_accum_plain if plain else qa.quantized_accum
        return fn(inp["q"], inp["scales"], inp["wmask"], finalize=finalize)
    fn = fa.fedavg_accum_plain if plain else fa.fedavg_accum
    return fn(inp["packets"], inp["wmask"], finalize=finalize)


def assert_close(got, want, integer, what) -> float:
    """Bitwise for integer data, rtol 1e-5 / atol 1e-6 else; -> max
    |got - want|."""
    tol = dict(rtol=0, atol=0) if integer else dict(rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got, want, **tol, msg=lambda m: f"{what}: {m}")
    return float((got - want).abs().max()) if got.numel() else 0.0


def compare_accum(rng, dev, K, C, W) -> dict:
    """Each accumulation kernel against its plain version on the card:
    f32, bf16 and int8 payloads, finalize on and off, and the ``into``
    fold.  -> max abs error per kernel."""
    from repro_torch.kernels import fedavg_accum as fa
    err = {"fedavg_accum": 0.0, "quantized_accum": 0.0}
    cases = [("fedavg_accum", kind, fin, integer)
             for kind in ("f32", "bf16") for fin in (True, False)
             for integer in (True, False)]
    cases += [("quantized_accum", "int8", fin, integer)
              for fin in (True, False) for integer in (True, False)]
    for name, kind, fin, integer in cases:
        inp = accum_inputs(rng, dev, K, C, W, kind, integer)
        want = accum_call(inp, fin, plain=True)
        got = accum_call(inp, fin)
        sync(dev)
        what = f"{name} {kind} finalize={fin} integer={integer}"
        e = max(assert_close(g, w, integer, what)
                for g, w in zip(got, want))
        err[name] = max(err[name], e)
    for integer in (True, False):
        inp = accum_inputs(rng, dev, K, C, W, "f32", integer)
        total = torch.from_numpy(rng.normal(size=(C, W)).astype(
            np.float32)).to(dev)
        if integer:
            total = total.round()
        counts = torch.ones(C, device=dev)
        sums, cnts = fa.fedavg_accum_plain(inp["packets"], inp["wmask"],
                                           finalize=False)
        want = (total + sums, counts + cnts)
        got = fa.fedavg_accum_into(total.clone(), counts.clone(),
                                   inp["packets"], inp["wmask"])
        sync(dev)
        e = max(assert_close(g, w, integer, f"fedavg_accum_into "
                             f"integer={integer}")
                for g, w in zip(got, want))
        err["fedavg_accum"] = max(err["fedavg_accum"], e)
    return err


def accum_bound(K, C, W, elem_bytes, scales, into=False) -> tuple:
    """Least time (ms) for one accumulation and what bounds it: each
    payload element read once, the (K, C) mask (and scales) read once,
    the (C, W) output and (C,) counts written once (into: also read);
    a multiply and an add per payload element, plus s*m per (k, c)."""
    out = (C * W + C) * 4
    nbytes = (K * C * W * elem_bytes + K * C * 4 * (2 if scales else 1)
              + out * (2 if into else 1))
    ops = 2 * K * C * W + (K * C if scales else 0) + C * W
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_accum(rng, dev, K, C, W) -> dict:
    """Kernel, plain version and ``torch.einsum`` (the library call that
    computes the same function; on rows dequantized outside the call
    for int8) at the training loop's shapes, on Gaussian payloads."""
    from repro_torch.kernels import fedavg_accum as fa
    f32 = accum_inputs(rng, dev, K, C, W, "f32", integer=False)
    bf16 = {**f32, "packets": f32["packets"].to(torch.bfloat16)}
    i8 = accum_inputs(rng, dev, K, C, W, "int8", integer=False)
    deq = (i8["q"].float() * i8["scales"][..., None]).contiguous()
    total, counts = torch.zeros((C, W), device=dev), torch.zeros(C,
                                                                  device=dev)
    x, m = f32["packets"], f32["wmask"]
    # fewer calls than the scatter kernels: each reads 46-183 MB
    few = dict(iters=50, warmup=5, calls=20)
    out = {"fedavg_accum": timed({
        "": lambda: accum_call(f32),
        "raw_": lambda: accum_call(f32, finalize=False),
        "bf16_": lambda: accum_call(bf16),
        "into_": lambda: fa.fedavg_accum_into(total, counts, x, m),
        "plain_": lambda: accum_call(f32, plain=True),
        "library_": lambda: torch.einsum("kcw,kc->cw", x, m),
    }, **few), "quantized_accum": timed({
        "": lambda: accum_call(i8),
        "plain_": lambda: accum_call(i8, plain=True),
        "library_": lambda: torch.einsum("kcw,kc->cw", deq, i8["wmask"]),
    }, **few)}
    fa_t, qa_t = out["fedavg_accum"], out["quantized_accum"]
    fa_t["bound_ms"], fa_t["bound_by"] = accum_bound(K, C, W, 4, False)
    fa_t["bf16_bound_ms"], _ = accum_bound(K, C, W, 2, False)
    fa_t["into_bound_ms"], _ = accum_bound(K, C, W, 4, False, into=True)
    qa_t["bound_ms"], qa_t["bound_by"] = accum_bound(K, C, W, 1, True)
    return out


# ---------------------------------------------------------------------------
# The FedAvg training loop at the paper CNN's full width
# ---------------------------------------------------------------------------

# (mode, samples per client, rounds, extra FedAvgConfig fields): exact at
# the paper's 5,000 samples per client; int8 and approx (the quickstart's
# conflict rate and downlink loss) on smaller shards
FEDAVG_RUNS = [("exact", 5000, 3, {}),
               ("int8", 1000, 3, {}),
               ("approx", 1000, 3, {"conflict_rate": 0.005,
                                    "downlink_loss": 0.0468})]
FEDAVG_TEST = 1000
# the quickstart's lr 0.05 is for 16x16 images; at 32x32 fc0 has 16,384
# inputs and lr 0.05 diverged to NaN in the first round on the card
FEDAVG_LR = 0.01


def fedavg_setup():
    """The paper CNN's model functions at full width, a synthetic test
    set, and one iid K-client partition per shard size of
    ``FEDAVG_RUNS``."""
    from repro_torch.configs.paper_cnn import CONFIG
    from repro_torch.core.fedavg import ModelFns
    from repro_torch.data.federated import partition_iid
    from repro_torch.data.synthetic import synthetic_image_classification
    from repro_torch.models import cnn
    fns = ModelFns(
        init=lambda g: cnn.init_cnn(g, CONFIG),
        loss=lambda p, b, g: cnn.cnn_loss(p, b, CONFIG, dropout_rng=g),
        test_metrics=lambda p, d: {
            "test_loss": cnn.cnn_loss(p, d, CONFIG, train=False),
            "test_acc": cnn.cnn_accuracy(p, d, CONFIG)})
    rng = np.random.default_rng(SEED)
    test = synthetic_image_classification(rng, FEDAVG_TEST)
    datasets = {n: partition_iid(synthetic_image_classification(
        rng, n * K_CLIENTS), K_CLIENTS, seed=SEED)
        for n in sorted({r[1] for r in FEDAVG_RUNS})}
    return fns, test, datasets


def fedavg_config(mode, rounds, extra):
    from repro_torch.core.fedavg import FedAvgConfig
    return FedAvgConfig(n_clients=K_CLIENTS, rounds=rounds, local_epochs=1,
                        batch_size=64, lr=FEDAVG_LR, agg_mode=mode,
                        seed=SEED, **extra)


def fedavg_path(dev, fns, test, datasets, log=print) -> dict:
    """``run_fedavg`` on the card: the paper CNN (4,585,546 parameters),
    K=10 clients, batch 64, one local epoch, synthetic data.  Checks
    finite losses, a falling exact test loss, and that each exact run
    launched #3 and each int8 run #4 once per round (approx aggregates
    with tensor ops).  -> per-round rows and the launch counts."""
    from repro_torch.core.fedavg import run_fedavg
    from repro_torch.kernels import fedavg_accum as fa
    from repro_torch.kernels import quantized_accum as qa
    rows = []
    counters = lambda: (fa.fedavg_accum.launches, qa.quantized_accum.launches)
    fa.fedavg_accum.launches = qa.quantized_accum.launches = 0
    for mode, per_client, rounds, extra in FEDAVG_RUNS:
        cfg = fedavg_config(mode, rounds, extra)
        before = counters()
        h = run_fedavg(fns, datasets[per_client], test, cfg, device=dev)
        rise = tuple(a - b for a, b in zip(counters(), before))
        want = {"exact": (1, 0), "int8": (0, 1), "approx": (0, 0)}[mode]
        assert rise == tuple(rounds * w for w in want), (mode, rise, want)
        for t in h["round"]:
            row = {"mode": mode, "per_client": per_client, "round": t,
                   **{key: h[key][t] for key in (
                       "train_s", "agg_s", "test_loss", "test_acc",
                       "peak_mem_bytes")}}
            rows.append(row)
            log(json.dumps(row))
        assert np.isfinite(h["test_loss"]).all(), (mode, h["test_loss"])
        if mode == "exact":
            assert h["test_loss"][-1] < h["test_loss"][0], h["test_loss"]
    launches = counters()
    return {"rows": rows, "launches": {"fedavg_accum": launches[0],
                                       "quantized_accum": launches[1]}}


def busy_within(intervals, start, end) -> float:
    """Length of the union of ``intervals`` (pairs, any order) clipped
    to ``[start, end]``."""
    busy, reach = 0.0, start
    for a, b in sorted(intervals):
        a, b = max(a, reach), min(b, end)
        if b > a:
            busy += b - a
            reach = b
    return busy


FEDAVG_PROFILED = 2


def fedavg_breakdown(dev, fns, test, data, log=print) -> list:
    """Where an exact FedAvg round's local training goes on the device:
    ``FEDAVG_PROFILED`` one-round runs on ``data`` under the profiler
    (host and device activity), each read inside ``run_fedavg``'s
    ``local_training`` span only.  -> per run: the span's wall time, the
    device's busy time and idle share within it, the accumulation
    kernel's time in the round, and the five kernels with the most
    device time in the span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.fedavg import run_fedavg
    cfg = fedavg_config("exact", 1, {})
    rows = []
    for run in range(FEDAVG_PROFILED):
        sync(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            h = run_fedavg(fns, data, test, cfg, device=dev)
        evs = prof.events()
        (span,) = [e for e in evs if e.device_type == DeviceType.CPU
                   and e.name == "local_training"]
        s, e = span.time_range.start, span.time_range.end
        on_dev = [ev for ev in evs if ev.device_type != DeviceType.CPU
                  and not getattr(ev, "is_user_annotation", False)]
        inside = [ev for ev in on_dev if s <= ev.time_range.start < e]
        per_kernel = {}
        for ev in inside:
            per_kernel[ev.key] = (per_kernel.get(ev.key, 0.0)
                                  + ev.time_range.elapsed_us() / 1e6)
        busy = busy_within([(ev.time_range.start, ev.time_range.end)
                            for ev in inside], s, e) / 1e6
        wall = (e - s) / 1e6
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:5]
        row = {"run": run, "per_client": next(iter(data.values())).shape[1],
               "span_s": wall, "train_s": h["train_s"][0],
               "agg_s": h["agg_s"][0], "device_busy_s": busy,
               "device_idle_share": 1 - busy / wall,
               "accum_kernel_s": sum(
                   ev.time_range.elapsed_us() for ev in on_dev
                   if "accum_kernel" in ev.key) / 1e6,
               "top_kernels": [[k[:80], v] for k, v in top]}
        rows.append(row)
        log(json.dumps(row))
    return rows


def round_step_parity(dev, n_params) -> None:
    """One ``fused_round_step`` at paper width on integer-valued flats,
    exact and int8: through the kernels on the card, and through their
    plain versions (the same step on CPU tensors); bitwise."""
    from repro_torch.core.aggregation import fused_round_step
    from repro_torch.core.packets import PAYLOAD_F32, PacketizedShape
    rng = np.random.default_rng(SEED + 2)
    N = PacketizedShape(n_params, PAYLOAD_F32).n_packets
    host = [rng.integers(-8, 9, (K_CLIENTS, n_params)).astype(np.float32),
            (rng.random((K_CLIENTS, N)) >= 0.05).astype(np.float32),
            (rng.random((K_CLIENTS, N)) >= 0.05).astype(np.float32),
            rng.integers(-8, 9, n_params).astype(np.float32),
            rng.integers(1, 4, K_CLIENTS).astype(np.float32)]
    for mode in ("exact", "int8"):
        outs = []
        for d in (dev, torch.device("cpu")):
            f, up, down, prev, w = (torch.from_numpy(a).to(d) for a in host)
            outs.append([t.cpu() for t in fused_round_step(
                f, up, down, prev, PAYLOAD_F32, mode=mode, weights=w,
                backend="kernel")])
        for name, a, b in zip(("flats", "global", "counts"), *outs):
            assert torch.equal(a, b), f"fused_round_step {mode}: {name}"


# ---------------------------------------------------------------------------
# The robust finalize (#5) and placement (#6) kernels at the main path's
# shapes
# ---------------------------------------------------------------------------

def robust_table(rng, dev, S, K, W, integer):
    """A per-slot client table as a paper-width robust round folds it:
    ~1% of the (slot, client) rows absent (zero), integer values in a
    narrow range (ties) or Gaussian ones, one slot with every client
    absent."""
    pres = (rng.random((S, K)) >= 0.01).astype(np.float32)
    pres[0] = 0.0
    tab = (rng.integers(-8, 9, (S, K, W)) if integer
           else rng.normal(size=(S, K, W))).astype(np.float32)
    tab *= pres[:, :, None]
    t = lambda a: torch.from_numpy(a).to(dev)
    return t(tab), t(pres)


def compare_robust(rng, dev, shapes) -> float:
    """``robust_finalize`` against its plain version at each (S, K, W) of
    ``shapes``, trimmed mean (beta 0.2) and median: bitwise on integer
    tables (raises otherwise), max |kernel - plain| on Gaussian ones
    (rtol 1e-5 / atol 1e-6).  -> the max abs error."""
    from repro_torch.kernels import packet_scatter as ps
    err = 0.0
    for S, K, W in shapes:
        for integer in (True, False):
            tab, pres = robust_table(rng, dev, S, K, W, integer)
            for median, beta in ((False, 0.2), (True, 0.0)):
                got = ps.robust_finalize(tab, pres, median=median, beta=beta)
                want = ps.robust_finalize_plain(tab, pres, median=median,
                                                beta=beta)
                sync(dev)
                what = f"robust_finalize {S}x{K}x{W} median={median}"
                assert torch.equal(got[1], want[1]), what
                e = assert_close(got[0], want[0], integer, what)
                assert not integer or e == 0.0, what
                err = max(err, e)
    return err


def robust_sort_twin(table, pres, median, beta):
    """The reference's sort-based formulation in several PyTorch calls
    (sort over the clients, then a masked mean of the kept ranks): no
    single library call computes a trimmed mean or an averaging median,
    so this is the yardstick, labelled as several calls."""
    K = table.shape[1]
    p = pres > 0
    m = p.to(torch.float32).sum(dim=1)
    vs = torch.sort(torch.where(p[:, :, None], table,
                                torch.finfo(torch.float32).max), dim=1).values
    t = (torch.floor((m - 1.0) * 0.5) if median
         else torch.floor(m * torch.tensor(beta, device=table.device)))
    t = torch.clamp_min(t, 0.0)[:, None, None]
    r = torch.arange(K, device=table.device, dtype=torch.float32)[None, :,
                                                                   None]
    keep = (r >= t) & (r < m[:, None, None] - t)
    kept = keep.to(torch.float32).sum(dim=1)
    agg = torch.where(keep, vs, 0.0).sum(dim=1) / torch.clamp_min(kept, 1e-12)
    return torch.where(kept > 0, agg, 0.0), m


def robust_bound(table, pres) -> tuple:
    """Least time (ms) of one finalize and what bounds it: the present
    rows of the table and the presence read once (absent rows are never
    loaded), agg and m written once; per present value K compares and
    an add, and a divide per coordinate."""
    S, K, W = table.shape
    present = float((pres > 0).sum())
    nbytes = (present * W + S * K + S * W + S) * 4
    ops = present * W * (K + 1) + S * W
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_robust(rng, dev, S, K, W, S_q8, W_q8) -> dict:
    """Kernel (trimmed mean and median), plain version and the sort-based
    twin on a Gaussian table at the f32 round's shape, and the kernel on
    the q8 round's table shape."""
    from repro_torch.kernels import packet_scatter as ps
    tab, pres = robust_table(rng, dev, S, K, W, integer=False)
    few = dict(iters=50, warmup=5, calls=20)
    out = timed({
        "": lambda: ps.robust_finalize(tab, pres, beta=0.2),
        "median_": lambda: ps.robust_finalize(tab, pres, median=True),
        "plain_": lambda: ps.robust_finalize_plain(tab, pres, beta=0.2),
        "sort_twin_": lambda: robust_sort_twin(tab, pres, False, 0.2),
    }, **few)
    out["bound_ms"], out["bound_by"] = robust_bound(tab, pres)
    out.update(median_library(tab, pres, few))
    del tab, pres
    tq, pq = robust_table(rng, dev, S_q8, K, W_q8, integer=False)
    out.update({"q8_table_" + k: v for k, v in timed(
        {"": lambda: ps.robust_finalize(tq, pq, beta=0.2)}, **few).items()})
    out["q8_table_bound_ms"], _ = robust_bound(tq, pq)
    return out


def median_library(tab, pres, few) -> dict:
    """The median mode's one-call counterpart: the absent entries set to
    NaN (outside the timed call), then ``torch.nanquantile`` over the
    clients with the midpoint of the middle pair.  Checked against the
    kernel's median where a slot has a contributor, rtol 1e-6 / atol 1e-6
    (the kernel divides the pair's sum by 2, torch interpolates between
    them: the two round apart where the pair nearly cancels).
    -> ``library_ms`` and the check's error."""
    from repro_torch.kernels import packet_scatter as ps
    nan_tab = torch.where(pres[:, :, None] > 0, tab, float("nan"))
    want, m = ps.robust_finalize(tab, pres, median=True)
    quantile = lambda: torch.nanquantile(nan_tab, 0.5, dim=1,
                                         interpolation="midpoint")
    got = quantile()
    out = {"library_fn": "torch.nanquantile(q=0.5, midpoint), median mode"}
    out.update({"library_" + k: v for k, v in timed(
        {"": quantile}, **few).items()})
    sync(tab.device)
    has = m > 0
    torch.testing.assert_close(got[has], want[has], rtol=1e-6, atol=1e-6)
    out["library_max_abs_err"] = float((got[has] - want[has]).abs().max())
    return out


def downlink_order(rng, down) -> np.ndarray:
    """The slots of one client's downlink in arrival order: the packets
    that reached it (``down > 0``), shuffled, ``DUP`` of them delivered
    twice."""
    order = rng.permutation(np.nonzero(down > 0)[0])
    again = order[rng.random(order.size) < DUP]
    return np.concatenate([order, again]).astype(np.int32)


def placement_inputs(rng, dev, n_slots, W, table=False,
                     dtype=torch.float32) -> dict:
    """Inputs of the placement kernel.  The placement path's shape: one
    client's downlink (``downlink_order`` over ``n_slots`` packets with
    ``DOWN_LOSS`` lost) placed into its ``n_slots`` packetized state,
    the ``init``.  With ``table``: as many packets as buffer rows, a
    seeded permutation with 2% of them replaced by an earlier packet's
    index (the robust table's S*K rows as packets)."""
    if table:
        idx = rng.permutation(n_slots).astype(np.int32)
        dup = np.nonzero(rng.random(n_slots) < 0.02)[0]
        dup = dup[dup > 0]
        idx[dup] = idx[rng.integers(0, dup)]
    else:
        idx = downlink_order(rng, rng.random(n_slots) >= DOWN_LOSS)
    t = lambda a: torch.from_numpy(a).to(dev)
    return {"packets": t(rng.normal(size=(idx.size, W)).astype(np.float32)
                         ).to(dtype),
            "idx": t(idx),
            "init": t(rng.normal(size=(n_slots, W)).astype(np.float32)
                      ).to(dtype)}


def compare_placement(rng, dev, n_slots, W, n_table_rows) -> float:
    """``packet_scatter`` against its plain version at the placement
    path's shape and the table shape, f32 and int8 rows, with and
    without ``init``: bitwise (raises otherwise)."""
    from repro_torch.kernels import packet_scatter as ps
    for n, table in ((n_slots, False), (n_table_rows, True)):
        for dtype in (torch.float32, torch.int8):
            inp = placement_inputs(rng, dev, n, W, table, dtype)
            for init in (None, inp["init"]):
                want = ps.packet_scatter_plain(inp["packets"], inp["idx"],
                                               n, init)
                got = ps.packet_scatter(inp["packets"], inp["idx"], n,
                                        None if init is None
                                        else init.clone())
                sync(dev)
                assert torch.equal(got, want), f"packet_scatter {n} {dtype}"
    return 0.0


def placement_bound(idx, W, elem_bytes=4) -> float:
    """Least time (ms) of one placement: ``idx`` read once, and only the
    winning packet of each placed row read and written once (the losing
    duplicates and the uncovered rows of ``init`` are never touched)."""
    placed = int(torch.unique(idx).numel())
    nbytes = idx.numel() * 4 + 2 * placed * W * elem_bytes
    return nbytes / HBM_BYTES_PER_S * 1e3, placed


def time_placement(rng, dev, n_slots, W, n_table_rows) -> dict:
    """Kernel, plain version and ``index_copy_`` (the library call that
    places rows; its order under duplicates is unspecified on CUDA, so
    it is timed and not checked) at the placement path's shape; the
    kernel alone at the table shape, under ``table_shape_`` keys."""
    from repro_torch.kernels import packet_scatter as ps
    inp = placement_inputs(rng, dev, n_slots, W)
    pk, idx, buf = inp["packets"], inp["idx"], inp["init"]
    idx64 = idx.long()
    few = dict(iters=50, warmup=5, calls=20)
    out = timed({
        "": lambda: ps.packet_scatter(pk, idx, n_slots, buf),
        "plain_": lambda: ps.packet_scatter_plain(pk, idx, n_slots, buf),
        "library_": lambda: buf.index_copy_(0, idx64, pk),
    }, **few)
    out["bound_ms"], out["placed_rows"] = placement_bound(idx, W)
    out["bound_by"] = "bytes"
    out["n_packets"] = idx.numel()
    tab = placement_inputs(rng, dev, n_table_rows, W, table=True)
    out.update({"table_shape_" + k: v for k, v in timed(
        {"": lambda: ps.packet_scatter(tab["packets"], tab["idx"],
                                       n_table_rows, tab["init"])},
        **few).items()})
    out["table_shape_bound_ms"], out["table_shape_placed_rows"] = \
        placement_bound(tab["idx"], W)
    return out


# ---------------------------------------------------------------------------
# The robust round (trimmed mean, median, norm clip) at paper width
# ---------------------------------------------------------------------------

ROBUST_MODES = ("trimmed_mean", "median", "norm_clip")
TRIM_BETA = 0.2


def clip_tau(wl: Workload) -> float:
    """Half the median (decoded) row norm of the workload's packets, so
    that the clip is active on most rows."""
    rows = wl.pk.astype(np.float32)
    if wl.scales is not None:
        rows = rows * wl.scales[..., None]
    return 0.5 * float(np.median(np.linalg.norm(rows, axis=-1)))


def robust_config(wl: Workload, agg: str, compiled: bool, tau: float):
    from repro_torch.core.server import EngineConfig
    return EngineConfig(n_clients=wl.flats.shape[0],
                        n_params=wl.flats.shape[1], payload=wl.pk.shape[2],
                        n_workers=N_WORKERS, ring_capacity=RING_CAPACITY,
                        compile=compiled, agg_mode=agg, trim_beta=TRIM_BETA,
                        clip_tau=tau)


def plain_robust_round(cfg, events, wl: Workload, dev):
    """The compiled robust round with every kernel replaced by its plain
    version on ``dev``: the schedule folded row by row by the plain
    scatter (into the (S*K, W) table for the table modes, after the norm
    clip for norm_clip), then the plain rank-select finalize or the END
    divide, the fallback and the downlink."""
    from repro_torch.core import engine_compiled as ec
    from repro_torch.core.server import RoundResult, downlink, \
        fallback_global
    from repro_torch.core.pipeline import finalize_mean
    from repro_torch.kernels import packet_scatter as ps
    sched, stats, up = ec.demux_events(cfg, events, wl.weights)
    table = cfg.agg_mode in ("trimmed_mean", "median")
    rows = cfg.n_slots * (cfg.n_clients if table else 1)
    if table:
        sched = ec._combined_table_sched(sched, cfg.n_clients)
    acc = torch.zeros((rows, cfg.payload), device=dev)
    cnt = torch.zeros((rows,), device=dev)
    t = lambda a: None if a is None else torch.from_numpy(a).to(dev)
    exact = table or cfg.mode == "exact"
    for r in range(sched.n_batches):
        sc = None if sched.scales is None else t(sched.scales[r])
        pk, idx, w = t(sched.payloads[r]), t(sched.idx[r]), t(
            sched.weights[r])
        if cfg.agg_mode == "norm_clip":
            w = ps.norm_clip_weights(w, pk, tau=cfg.clip_tau, scales=sc)
        if sc is None:
            acc, cnt = ps.packet_scatter_accum_plain(pk, idx, w, acc, cnt,
                                                     exact=exact)
        else:
            acc, cnt = ps.packet_scatter_accum_q8_plain(pk, sc, idx, w, acc,
                                                        cnt, exact=exact)
    if table:
        agg, counts = ps.robust_finalize_plain(
            acc.view(cfg.n_slots, cfg.n_clients, cfg.payload),
            cnt.view(cfg.n_slots, cfg.n_clients),
            median=(cfg.agg_mode == "median"), beta=cfg.trim_beta)
    else:
        agg, counts = finalize_mean(acc, cnt), cnt
    g = fallback_global(agg, counts, wl.prev, cfg.payload, cfg.n_params)
    flats = downlink(g, wl.flats, wl.down, cfg.payload, cfg.n_params)
    return RoundResult(g, counts, t(up), flats, stats)


def check_robust_round(res, events, wl: Workload, cfg) -> None:
    """Conservation, counts and finiteness of one robust round: the
    table modes count contributors per slot (unweighted); norm_clip's
    counts are the clipped weights, at most the weighted arrivals."""
    s = res.stats
    buckets = (s.data_enqueued + s.duplicates_dropped + s.phase_dropped
               + s.late_dropped + s.malformed_dropped)
    assert buckets == count_data(events), (buckets, count_data(events))
    up = res.up_mask.cpu().numpy()
    assert s.data_enqueued == int(up.sum())
    counts = res.counts.cpu().numpy()
    if cfg.agg_mode == "norm_clip":
        weighted = (up * wl.weights[:, None]).sum(axis=0)
        assert (counts <= weighted).all() and ((counts > 0)
                                               == (weighted > 0)).all()
        assert counts.sum() < weighted.sum(), "the clip was not active"
    else:
        np.testing.assert_array_equal(counts, up.sum(axis=0))
    for name in ("new_global", "new_client_flats"):
        x = getattr(res, name)
        assert bool(torch.isfinite(x).all()), name
    assert tuple(res.new_global.shape) == (cfg.n_params,)
    assert tuple(res.new_client_flats.shape) == (cfg.n_clients,
                                                 cfg.n_params)


def robust_path(dev, n_clients, n_params, log=print) -> dict:
    """The robust modes at paper width through ``run_engine_round``,
    eager and compiled, f32 and q8, with the counts of every kernel at 0
    just before and read just after.  Checks eager == compiled and
    compiled == plain bitwise, conservation, counts and finiteness, and
    that each compiled round made one round fold, each eager norm-clip
    round one per-drain launch per drained ring (the eager table modes
    fill their table on the host and fold nothing) and kernel 5 ran once
    per table-mode round.  -> per-round rows, the launch counts and one
    compiled f32 result per mode (for the placement path)."""
    from repro_torch.core.server import make_uplink_stream, run_engine_round
    from repro_torch.kernels import packet_scatter as ps
    rng = np.random.default_rng(SEED + 3)
    counters = (ps.packet_scatter_accum, ps.packet_scatter_accum_q8,
                ps.packet_scatter_accum_rounds, ps.robust_finalize,
                ps.packet_scatter)
    for c in counters:
        c.launches = 0
    rows, drains, compiled_rounds, table_rounds, kept = [], 0, 0, 0, {}
    for wire in ("f32", "q8"):
        wl = make_workload(rng, n_clients, n_params, q8=(wire == "q8"))
        events, _ = make_uplink_stream(rng, wl.pk, loss_rate=LOSS,
                                       dup_rate=DUP, scales=wl.scales)
        tau = clip_tau(wl)
        for agg in ROBUST_MODES:
            results = {}
            for compiled in (False, True):
                cfg = robust_config(wl, agg, compiled, tau)
                # the peak counts what the earlier rounds' kept results
                # hold: report it with the memory in use before the round
                held = None
                if dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(dev)
                    held = torch.cuda.memory_allocated(dev)
                sync(dev)
                t0 = time.perf_counter()
                res = run_engine_round(cfg, wl.flats, wl.prev, events,
                                       down_mask=wl.down, weights=wl.weights,
                                       device=dev)
                sync(dev)
                dt = time.perf_counter() - t0
                check_robust_round(res, events, wl, cfg)
                if compiled:
                    compiled_rounds += 1
                elif agg == "norm_clip":
                    # the eager table modes drain for the stats only
                    drains += res.stats.batches_drained
                table_rounds += agg != "norm_clip"
                results[compiled] = res
                row = {"wire": wire, "agg_mode": agg,
                       "engine": "compiled" if compiled else "eager",
                       "round_s": dt, "data_packets": count_data(events),
                       "batches": res.stats.batches_drained,
                       "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                                          if dev.type == "cuda" else None),
                       "held_before_bytes": held}
                if agg == "norm_clip":
                    row["clip_tau"] = tau
                rows.append(row)
                log(json.dumps(row))
            assert_same(results[False], results[True],
                        f"eager vs compiled {wire} {agg}")
            plain = plain_robust_round(cfg, events, wl, dev)
            assert_same(results[True], plain,
                        f"plain vs compiled {wire} {agg}")
            if wire == "f32":
                kept[agg] = (results[True], wl)
    launches = {c.__name__: c.launches for c in counters}
    if dev.type == "cuda":
        assert launches["packet_scatter_accum"] == drains, (launches, drains)
        assert launches["packet_scatter_accum_q8"] == 0, launches
        assert launches["packet_scatter_accum_rounds"] == compiled_rounds, (
            launches, compiled_rounds)
        assert launches["robust_finalize"] == table_rounds, launches
    return {"rows": rows, "launches": launches, "kept": kept}


def robust_breakdown(dev, n_clients, n_params, log=print) -> list:
    """Where a compiled robust round's time goes: each mode on each wire
    under the profiler (device activity only), the device's busy time,
    the scatter and finalize kernels' time and the idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.server import make_uplink_stream, run_engine_round
    rng = np.random.default_rng(SEED + 4)
    rows = []
    for wire in ("f32", "q8"):
        wl = make_workload(rng, n_clients, n_params, q8=(wire == "q8"))
        events, _ = make_uplink_stream(rng, wl.pk, loss_rate=LOSS,
                                       dup_rate=DUP, scales=wl.scales)
        tau = clip_tau(wl)
        for agg in ROBUST_MODES:
            cfg = robust_config(wl, agg, True, tau)
            torch.cuda.reset_peak_memory_stats(dev)
            sync(dev)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run_engine_round(cfg, wl.flats, wl.prev, events,
                                 down_mask=wl.down, weights=wl.weights,
                                 device=dev)
                sync(dev)
                dt = time.perf_counter() - t0
            on_dev = [e for e in prof.events()
                      if e.device_type != DeviceType.CPU]
            busy = sum(e.self_device_time_total for e in on_dev) / 1e6
            pick = lambda key: sum(e.self_device_time_total for e in on_dev
                                   if key in e.key) / 1e6
            row = {"wire": wire, "agg_mode": agg, "round_s": dt,
                   "device_busy_s": busy,
                   "scatter_kernel_s": sum(
                       e.self_device_time_total for e in on_dev
                       if is_fold_kernel(e.key)) / 1e6,
                   "finalize_kernel_s": pick("robust_finalize"),
                   "h2d_s": pick("HtoD"), "device_idle_share": 1 - busy / dt,
                   "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}
            rows.append(row)
            log(json.dumps(row))
    return rows


def placement_path(dev, kept, log=print) -> dict:
    """The clients' side of a robust round's downlink through the entry
    point ``ops.packet_scatter``: each client places the global's
    packets that reached it (shuffled, 2% delivered twice) into its own
    packetized state, so lost packets keep the local value.  Per mode
    the result must equal the engine's ``new_client_flats`` bit for bit.
    Counts at 0 just before, read just after."""
    from repro_torch.core.packets import depacketize, packetize
    from repro_torch.kernels import ops
    from repro_torch.kernels import packet_scatter as ps
    rng = np.random.default_rng(SEED + 5)
    ps.packet_scatter.launches = 0
    t0 = time.perf_counter()
    for agg, (res, wl) in kept.items():
        W = wl.pk.shape[2]
        gpk = packetize(res.new_global, W)
        for k in range(wl.flats.shape[0]):
            idx = torch.from_numpy(downlink_order(rng, wl.down[k])).to(dev)
            local = packetize(torch.from_numpy(wl.flats[k]).to(dev), W)
            placed = ops.packet_scatter(gpk[idx.long()], idx, gpk.shape[0],
                                        local.contiguous())
            flat = depacketize(placed, wl.flats.shape[1])
            assert torch.equal(flat, res.new_client_flats[k]), (agg, k)
    sync(dev)
    out = {"launches": ps.packet_scatter.launches,
           "seconds": time.perf_counter() - t0}
    log(json.dumps(out))
    return out


ATTACK_ROUNDS = 3


def attack_path(dev, n_clients, n_params, log=print) -> dict:
    """``run_churn_rounds`` at paper width with the settings of the churn
    attack sweep (tests/test_robust_agg.py): integer flats in [-4, 4],
    participation 0.9, 15% stragglers, 10% loss, 5% duplicates, one
    scale attacker boosting 1e4x, 3 rounds, the paper's 5 workers and
    ring capacity 64; ``trimmed_mean`` (beta 0.25) against ``mean``.
    Asserts the sweep's inequalities.  Counts at 0 just before each run,
    read just after."""
    from repro_torch.core.packets import PAYLOAD_F32
    from repro_torch.core.rounds import (AttackConfig, ChurnConfig,
                                         run_churn_rounds)
    from repro_torch.core.server import EngineConfig
    from repro_torch.kernels import packet_scatter as ps
    rng = np.random.default_rng(7)
    flats = rng.integers(-4, 5, (n_clients, n_params)).astype(np.float32)
    prev = np.zeros(n_params, np.float32)
    churn = ChurnConfig(participation=0.9, straggle_rate=0.15,
                        loss_rate=0.1, dup_rate=0.05)
    attack = AttackConfig("scale", n_attackers=1, boost=1e4)
    honest_mean = flats.mean(axis=0)
    out = {}
    for agg in ("trimmed_mean", "mean"):
        cfg = EngineConfig(n_clients=n_clients, n_params=n_params,
                           payload=PAYLOAD_F32, n_workers=N_WORKERS,
                           ring_capacity=RING_CAPACITY, compile=True,
                           agg_mode=agg, trim_beta=0.25, min_clients=1)
        counters = (ps.packet_scatter_accum, ps.packet_scatter_accum_rounds,
                    ps.robust_finalize)
        for c in counters:
            c.launches = 0
        sync(dev)
        t0 = time.perf_counter()
        hist = run_churn_rounds(cfg, churn, flats, prev, ATTACK_ROUNDS,
                                rng=np.random.default_rng(11), attack=attack,
                                device=dev)
        g = hist.final_global.cpu().numpy()
        dt = time.perf_counter() - t0
        folded = sum(r.stats.batches_drained > 0 for r in hist.results)
        if dev.type == "cuda":
            assert ps.packet_scatter_accum.launches == 0
            assert ps.packet_scatter_accum_rounds.launches == folded
            assert ps.robust_finalize.launches == (
                ATTACK_ROUNDS if agg == "trimmed_mean" else 0)
        assert np.isfinite(g).all()
        out[agg] = {"max_abs_err": float(np.abs(g - honest_mean).max()),
                    "seconds": dt,
                    "launches": {c.__name__: c.launches for c in counters}}
        log(json.dumps({"agg_mode": agg, **out[agg]}))
    err_robust = out["trimmed_mean"]["max_abs_err"]
    err_mean = out["mean"]["max_abs_err"]
    assert err_mean > 100.0, err_mean
    assert err_robust < 20.0, err_robust
    assert err_robust < err_mean
    return out


def build_all() -> list:
    """Build every kernel library of ``csrc/``, one ``nvcc`` each, all
    started together."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import fedavg_accum as fa
    from repro_torch.kernels import packet_scatter as ps
    loaders = (ps.load_library, fa.load_library, ps.load_robust_library,
               ps.load_place_library)
    with ThreadPoolExecutor(len(loaders)) as pool:
        return list(pool.map(lambda load: load(), loaders))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.configs.paper_cnn import CONFIG, n_params
    from repro_torch.core.packets import PAYLOAD_F32, PAYLOAD_Q8, \
        PacketizedShape
    from repro_torch.kernels import packet_scatter as ps

    info = device_info()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"# device: {info['kind']} x{info['count']}; nvidia-smi: "
          f"{info['nvidia_smi']}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    for built in build_all():
        print(f"# build: {built.path.name} in {built.build_seconds:.2f} s",
              flush=True)
        print(built.build_log.strip(), flush=True)
    print(f"# builds: {time.perf_counter() - t0:.2f} s wall", flush=True)

    dev = torch.device("cuda")
    P = n_params(CONFIG)
    shapes = {"packet_scatter_accum":
              (PacketizedShape(P, PAYLOAD_F32).n_packets, PAYLOAD_F32, False),
              "packet_scatter_accum_q8":
              (PacketizedShape(P, PAYLOAD_Q8).n_packets, PAYLOAD_Q8, True)}
    rng = np.random.default_rng(SEED)
    kernels, off_path = {}, {}
    for name, (S, W, q8) in shapes.items():
        err = 0.0
        for exact in (True, False):
            for integer in (True, False):
                e = compare_kernel(rng, dev, S, W, q8, exact, integer)
                assert e == 0.0, (name, exact, integer, e)
                err = max(err, e)
        timing = time_kernel(rng, dev, S, W, q8)
        # the per-batch q8 entry point is off the main path now: the
        # eager engine decodes q8 rows at RX, the compiled one folds rounds
        (off_path if q8 else kernels)[name] = {
            "S": S, "W": W, "batch": 64, "real": 64, "max_abs_err": err,
            **timing}
        print(f"# {name} (per drain) S={S} W={W}: max_abs_err {err:.3g}; "
              + json.dumps(timing), flush=True)

    # the round fold on the real drain schedules of the main path's f32
    # and q8 rounds
    streams, stream_rng = path_streams(K_CLIENTS, P)
    for wire, wl, events in streams:
        name = "packet_scatter_accum_rounds" + ("_q8" if wire == "q8" else "")
        r = round_schedule(rng, dev, path_config(wl), events, wl.weights,
                           wire == "q8")
        err = compare_round_fold(r)
        timing = time_round_fold(r)
        del r
        kernels[name] = {"S": path_config(wl).n_slots, "W": wl.pk.shape[2],
                         "max_abs_err": err, **timing}
        print(f"# {name}: round fold == plain == per-batch kernel row by "
              f"row, bitwise; " + json.dumps(timing), flush=True)

    # the main path: counts at 0 just before, read just after
    t0 = time.perf_counter()
    path = main_path(dev, streams, stream_rng,
                     log=lambda s: print("# round " + s, flush=True))
    del streams
    print(f"# main path: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, n in path["launches"].items():
        assert n > 0, f"{name} was not launched on the main path"
    round_breakdown(dev, K_CLIENTS, P,
                    log=lambda s: print("# breakdown " + s, flush=True))

    # the robust finalize and placement kernels at the robust round's
    # shapes: the (S, K, W) client tables of both wires; one client's
    # downlink placed into its S packets (and, checked too, the S*K rows
    # of the f32 table as packets to place)
    S, W = shapes["packet_scatter_accum"][:2]
    S8, W8 = shapes["packet_scatter_accum_q8"][:2]
    err = compare_robust(rng, dev, [(S, K_CLIENTS, W), (S8, K_CLIENTS, W8)])
    timing = time_robust(rng, dev, S, K_CLIENTS, W, S8, W8)
    kernels["robust_finalize"] = {"S": S, "K": K_CLIENTS, "W": W,
                                  "max_abs_err": err, **timing}
    print(f"# robust_finalize S={S} K={K_CLIENTS} W={W} (q8 table S={S8} "
          f"W={W8}): max_abs_err {err:.3g}; " + json.dumps(timing),
          flush=True)
    err = compare_placement(rng, dev, S, W, S * K_CLIENTS)
    timing = time_placement(rng, dev, S, W, S * K_CLIENTS)
    kernels["packet_scatter"] = {"n_slots": S, "W": W,
                                 "table_shape_n": S * K_CLIENTS,
                                 "max_abs_err": err, **timing}
    print(f"# packet_scatter N={timing['n_packets']} into S={S} W={W} "
          f"(table shape {S * K_CLIENTS} rows checked too): max_abs_err "
          f"{err:.3g}; " + json.dumps(timing), flush=True)

    # the robust path: counts at 0 just before, read just after
    t0 = time.perf_counter()
    robust = robust_path(dev, K_CLIENTS, P,
                         log=lambda s: print("# robust " + s, flush=True))
    print(f"# robust path: {time.perf_counter() - t0:.1f} s; launches "
          + json.dumps(robust["launches"]), flush=True)
    placement = placement_path(
        dev, robust.pop("kept"),
        log=lambda s: print("# placement " + s, flush=True))
    for name, n in (("robust_finalize",
                     robust["launches"]["robust_finalize"]),
                    ("packet_scatter", placement["launches"])):
        assert n > 0, f"{name} was not launched on the robust path"
        path["launches"][name] = n
    for name, key in (("packet_scatter_accum", "packet_scatter_accum"),
                      ("packet_scatter_accum_rounds",
                       "packet_scatter_accum_rounds")):
        assert robust["launches"][key] > 0, key
        kernels[name]["robust_path_launches"] = robust["launches"][key]
    robust_breakdown(dev, K_CLIENTS, P,
                     log=lambda s: print("# robust breakdown " + s,
                                         flush=True))
    attack = attack_path(dev, K_CLIENTS, P,
                         log=lambda s: print("# attack " + s, flush=True))
    print(f"# attack: trimmed_mean max |global - honest mean| "
          f"{attack['trimmed_mean']['max_abs_err']:.6g} < 20, mean "
          f"{attack['mean']['max_abs_err']:.6g} > 100", flush=True)

    # the FedAvg accumulation kernels at the training loop's shapes
    C = PacketizedShape(P, PAYLOAD_F32).n_packets
    accum_err = compare_accum(rng, dev, K_CLIENTS, C, PAYLOAD_F32)
    accum = time_accum(rng, dev, K_CLIENTS, C, PAYLOAD_F32)
    for name, timing in accum.items():
        kernels[name] = {"K": K_CLIENTS, "C": C, "W": PAYLOAD_F32,
                         "max_abs_err": accum_err[name], **timing}
        print(f"# {name} K={K_CLIENTS} C={C} W={PAYLOAD_F32}: max_abs_err "
              f"{accum_err[name]:.3g}; " + json.dumps(timing), flush=True)

    # the training loop: counts at 0 just before, read just after
    fns, test, datasets = fedavg_setup()
    t0 = time.perf_counter()
    fed = fedavg_path(dev, fns, test, datasets,
                      log=lambda s: print("# fedavg " + s, flush=True))
    print(f"# fedavg path: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, n in fed["launches"].items():
        assert n > 0, f"{name} was not launched on the training loop"
    path["launches"].update(fed["launches"])
    fedavg_breakdown(dev, fns, test, datasets[max(datasets)],
                     log=lambda s: print("# fedavg breakdown " + s,
                                         flush=True))
    round_step_parity(dev, P)
    print("# fused_round_step: kernels == plain versions, bitwise",
          flush=True)

    replaces = {
        "packet_scatter_accum": ("packet_scatter.cu", "packet_scatter.py:173",
                                 "packet_scatter_accum_pallas"),
        "packet_scatter_accum_rounds": ("packet_scatter.cu",
                                        "packet_scatter.py:173",
                                        "packet_scatter_accum_pallas"),
        "packet_scatter_accum_rounds_q8": ("packet_scatter.cu",
                                           "packet_scatter.py:227",
                                           "packet_scatter_accum_q8_pallas"),
        "fedavg_accum": ("fedavg_accum.cu", "fedavg_accum.py:59",
                         "fedavg_accum_pallas"),
        "quantized_accum": ("fedavg_accum.cu", "quantized_accum.py:48",
                            "quantized_accum_pallas"),
        "robust_finalize": ("robust_finalize.cu", "packet_scatter.py:440",
                            "robust_finalize_pallas"),
        "packet_scatter": ("packet_place.cu", "packet_scatter.py:65",
                           "packet_scatter_pallas")}
    line = []
    for name, k in kernels.items():
        source, where, fn = replaces[name]
        extra = {key: v for key, v in k.items()
                 if key not in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")}
        line.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{where}",
            "replaces_function":
                f"src/repro/kernels/{where.split(':')[0]}::{fn}",
            "launches": path["launches"][name],
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
            "kernel_us": k["ms"] * 1e3, "plain_us": k["plain_ms"] * 1e3,
            "library_us": (None if k["library_ms"] is None
                           else k["library_ms"] * 1e3),
            "bound_us": k["bound_ms"] * 1e3, **extra})
    for name, k in off_path.items():
        print(f"# off the main path: {name} (per batch) "
              f"{k['ms'] * 1e3:.3f} us, index_add_ "
              f"{k['library_ms'] * 1e3:.3f} us", flush=True)
    print(info["nvidia_smi"])
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
