"""Public wrappers for the hand-written kernels.

Torch port of ``repro.kernels.ops``.  The reference pads the client and
packet axes up to the TPU grid's block multiples (and its callers pad
the payload width to 128 lanes); the CUDA kernels take any K, C, W and
batch length, so the port passes them as they are and copies nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fedavg_accum as _fa
from repro_torch.kernels import packet_scatter as _ps
from repro_torch.kernels.quantized_accum import \
    quantized_accum as _quantized_accum_kernel


def _payload(x: torch.Tensor) -> torch.Tensor:
    """f32 and bf16 payloads go to the kernel as they are; any other
    type is cast to f32, as the reference casts every payload."""
    if x.dtype not in _fa.PAYLOAD_DTYPES:
        x = x.to(torch.float32)
    return x.contiguous()


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def fedavg_accum(packets, wmask, finalize: bool = True):
    """(K, C, W) payloads + (K, C) weighted mask -> (avg (C, W), counts (C,)).

    With ``finalize=False`` the first output is the raw masked sum
    (streaming partial aggregation: the divide happens at END).
    """
    return _fa.fedavg_accum(_payload(packets), _f32(wmask),
                            finalize=finalize)


def quantized_accum(q, scales, wmask, finalize: bool = True):
    """int8 (K, C, W) + scales/mask (K, C) -> (avg (C, W), counts (C,))."""
    return _quantized_accum_kernel(q.contiguous(), _f32(scales), _f32(wmask),
                                   finalize=finalize)


def fedavg_accum_into(total, counts, packets, wmask):
    """Streaming fold: (total (C, W), counts (C,)) += raw masked sums.

    Updated in place, where the reference donates the pair; returns
    (total, counts).
    """
    return _fa.fedavg_accum_into(total, counts, _payload(packets),
                                 _f32(wmask))


def packet_scatter_accum(packets, idx, acc, counts, weights,
                         mode: str = "exact"):
    """Scatter-accumulate a drained ring batch into live (acc, counts).

    packets (N, W) f32 at slot rows idx (N,) int32; acc (S, W) f32;
    counts (S,) f32; weights (N,) per-arrival FedAvg weights.  Updates
    (acc, counts) in place, where the reference donates them, and
    returns them.  ``mode="exact"`` adds every arrival; ``"approx"`` is
    the deterministic lock-free race: within this batch the last writer
    to a slot wins against the call-entry snapshot, while counts still
    see every arrival (DESIGN.md §3).  Ring padding is idx=-1 / weight=0
    and is inert in both sums and counts.
    """
    if mode not in ("exact", "approx"):
        raise ValueError(mode)
    return _ps.packet_scatter_accum(packets, idx, weights, acc, counts,
                                   exact=(mode == "exact"))


def packet_scatter(packets, idx, n_slots: int, init=None):
    """Place packets (N, W) at rows idx (N,) of a (n_slots, W) buffer.

    ``init`` (default zeros) is the destination, updated in place where
    the reference aliases it onto the output: uncovered rows keep its
    contents; duplicated idx resolve last-writer-wins.
    """
    return _ps.packet_scatter(packets.contiguous(),
                              idx.to(torch.int32).contiguous(), n_slots,
                              init)


def robust_finalize(table, pres, median: bool = False, beta: float = 0.1):
    """Trimmed-mean / median finalize: table (S, K, W) + presence (S, K)
    -> (agg (S, W), m (S,)).  The reference pads S to its slot block; the
    CUDA kernel takes any S."""
    return _ps.robust_finalize(_f32(table), _f32(pres), median=median,
                               beta=beta)
