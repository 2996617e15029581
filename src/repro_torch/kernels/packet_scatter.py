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
  plain PyTorch with the reference's dataflow
  (``repro.kernels.packet_scatter.packet_scatter_accum_batch_jnp`` and
  its q8 twin): a one-hot (S x N) routing matrix, a matmul, and a
  last-column select for approx mode.
- ``packet_scatter_accum_rounds``: a whole round's drain schedule, one
  launch per schedule row on the current stream, no host sync.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

# the kernel stages a batch's idx, weights and hit list in shared
# memory (12 B a packet); 2048 packets stay inside the default 48 KB.
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
    new (acc', counts').  Functional: the inputs are not modified."""
    S, N = acc.shape[0], idx.shape[0]
    rows = torch.arange(S, device=acc.device)[:, None]
    hits = idx.to(torch.int64)[None, :] == rows            # (S, N)
    w = weights.to(torch.float32)[None, :]                # (1, N)
    whot = hits.to(torch.float32) * w
    counts = counts + whot.sum(dim=1)
    pkt = packets.to(torch.float32)
    if exact:
        return acc + whot @ pkt, counts
    valid = hits & (w > 0)
    colpos = torch.arange(1, N + 1, device=acc.device)[None, :]
    lastcol = torch.where(valid, colpos, 0).amax(dim=1, keepdim=True)
    lasthot = (colpos == lastcol) & valid
    contrib = (lasthot.to(torch.float32) * w) @ pkt
    # ``acc`` is the call-entry snapshot: the deterministic race
    return torch.where(lastcol > 0, acc + contrib, acc), counts


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
    the payloads are the int8 wire rows.  Rows fold in order, one kernel
    launch each on the current stream with no host sync between them
    (the reference's ``packet_scatter_accum_scan``).  On CPU tensors
    each row runs the plain version.
    """
    _check_accum(acc, counts)
    R = sched_idx.shape[0]
    q8 = sched_scales is not None
    if acc.device.type == "cpu":
        for r in range(R):
            if q8:
                packet_scatter_accum_q8(sched_pk[r], sched_scales[r],
                                        sched_idx[r], sched_w[r], acc,
                                        counts, exact=exact)
            else:
                packet_scatter_accum(sched_pk[r], sched_idx[r], sched_w[r],
                                     acc, counts, exact=exact)
        return acc, counts
    dev = acc.device
    if sched_idx.dim() != 2:
        raise ValueError("sched_idx must be an (R, B) tensor")
    B = sched_idx.shape[1]
    W, S = acc.shape[1], acc.shape[0]
    _check_batch_len(B)
    _build.check_tensor("sched_idx", sched_idx, torch.int32, (R, B), dev)
    _build.check_tensor("sched_w", sched_w, torch.float32, (R, B), dev)
    _build.check_tensor("sched_pk", sched_pk,
                        torch.int8 if q8 else torch.float32, (R, B, W), dev)
    if q8:
        _build.check_tensor("sched_scales", sched_scales, torch.float32,
                            (R, B), dev)
    stream = _build.stream(dev)
    p_idx, p_w, p_pk = (sched_idx.data_ptr(), sched_w.data_ptr(),
                        sched_pk.data_ptr())
    p_acc, p_cnt = acc.data_ptr(), counts.data_ptr()
    row4, pk_row = 4 * B, B * W * sched_pk.element_size()
    if q8:
        p_sc = sched_scales.data_ptr()
        for r in range(R):
            _launch_q8(p_pk + r * pk_row, p_sc + r * row4, p_idx + r * row4,
                       p_w + r * row4, p_acc, p_cnt, B, W, S, exact, stream)
    else:
        for r in range(R):
            _launch_f32(p_pk + r * pk_row, p_idx + r * row4, p_w + r * row4,
                        p_acc, p_cnt, B, W, S, exact, stream)
    return acc, counts
