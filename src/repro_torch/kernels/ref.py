"""Oracles for the hand-written kernels (the allclose targets).

Torch port of ``repro.kernels.ref``: the FedAvg accumulation oracles (one
einsum, in the reference's order of operations) and the sequential
scatter-accumulate oracle.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import host_array


def fedavg_accum_ref(packets: torch.Tensor, wmask: torch.Tensor,
                     finalize: bool = True):
    """packets (K, C, W); wmask (K, C) -> (avg (C, W) f32, counts (C, 1)).

    ``finalize=False`` returns the raw weighted sums instead of the
    count-normalized average (the shard-partial form).
    """
    x = packets.to(torch.float32)
    m = wmask.to(torch.float32)
    total = torch.einsum("kcw,kc->cw", x, m)
    counts = m.sum(dim=0)
    if not finalize:
        return total, counts[:, None]
    avg = total / torch.clamp_min(counts, 1e-12)[:, None]
    avg = torch.where(counts[:, None] > 0, avg, 0.0)
    return avg, counts[:, None]


def quantized_accum_ref(q: torch.Tensor, scales: torch.Tensor,
                        wmask: torch.Tensor, finalize: bool = True):
    """Dequantize-then-accumulate oracle (``q * s`` first, then the mask);
    ``finalize=False`` gives the raw sums."""
    deq = q.to(torch.float32) * scales.to(torch.float32)[..., None]
    return fedavg_accum_ref(deq, wmask, finalize=finalize)


def packet_scatter_accum_ref(packets, idx, acc, counts, weights=None,
                             mode: str = "exact"):
    """Sequential oracle for the scatter-accumulate contract.

    exact: every weighted arrival adds; approx: every writer reads the
    call-entry snapshot and the last write to a slot wins, while counts
    see every weighted arrival.  Indices outside ``[0, S)`` are inert.
    Runs in numpy on the host; returns f32 CPU tensors (acc', counts').
    """
    if mode not in ("exact", "approx"):
        raise ValueError(mode)
    pk = host_array(packets, np.float32)
    ix = host_array(idx)
    out = host_array(acc, np.float32).copy()
    cnt = host_array(counts, np.float32).copy()
    w = (np.ones(len(ix), np.float32) if weights is None
         else host_array(weights, np.float32))
    snap = out.copy()
    for i, s in enumerate(ix):
        if s < 0 or s >= out.shape[0]:
            continue
        cnt[s] += w[i]
        if mode == "exact":
            out[s] += w[i] * pk[i]
        elif w[i] > 0:
            out[s] = snap[s] + w[i] * pk[i]
    return torch.from_numpy(out), torch.from_numpy(cnt)
