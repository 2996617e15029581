"""Public wrappers for the hand-written kernels.

Torch port of the part of ``repro.kernels.ops`` on the server round's
path.  The reference pads the batch and slot axes up to the TPU grid's
block multiples; the CUDA kernel takes any batch length and slot count,
so the port passes them as they are.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.packet_scatter import \
    packet_scatter_accum as _packet_scatter_accum_kernel


def packet_scatter_accum(packets, idx, acc, counts, weights=None,
                         mode: str = "exact", donate: bool = False):
    """Scatter-accumulate a drained ring batch into live (acc, counts).

    packets (N, W) f32 at slot rows idx (N,) int32; acc (S, W) f32;
    counts (S,) f32; weights (N,) optional per-arrival FedAvg weights.
    Returns (acc', counts').  ``mode="exact"`` adds every arrival;
    ``"approx"`` is the deterministic lock-free race: within this batch
    the last writer to a slot wins against the call-entry snapshot,
    while counts still see every arrival (DESIGN.md §3).  Ring padding
    is idx=-1 / weight=0 and is inert in both sums and counts.

    ``donate=True`` updates ``acc`` and ``counts`` in place, where the
    reference donates their buffers; otherwise the inputs are left as
    they were and new tensors are returned.
    """
    if mode not in ("exact", "approx"):
        raise ValueError(mode)
    if weights is None:
        weights = torch.ones(packets.shape[0], dtype=torch.float32,
                             device=packets.device)
    if not donate:
        acc, counts = acc.clone(), counts.clone()
    return _packet_scatter_accum_kernel(packets, idx, weights, acc, counts,
                                        exact=(mode == "exact"))
