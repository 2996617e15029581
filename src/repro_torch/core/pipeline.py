"""Streaming aggregation state of the packet-path server (§3.2.2).

``StreamingAggregator`` keeps the running ``(total, counts)`` pair of a
round on the device: each drained ring batch of out-of-order packets is
scatter-accumulated into it (``scatter_add``), and END divides the sum
by the counts (``finalize``) — the paper's "reception and addition in
parallel until END" semantics.

Torch port of ``repro.core.pipeline``.  The reference donates
``(total, counts)`` to every fold; here the fold updates them in place.
The client-batch folds (``add``/``add_batch``) belong to the FedAvg
training loop and are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core.device import as_tensor, resolve_device
from repro_torch.kernels import ops as _ops
from repro_torch.kernels import ref as _ref


def finalize_mean(total: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """END divide: total / max(counts, 1e-12), 0 where nobody delivered."""
    avg = total / torch.clamp_min(counts, 1e-12)[:, None]
    return torch.where(counts[:, None] > 0, avg, 0.0)


class StreamingAggregator:
    """Count-normalized streaming FedAvg server state on ``device``.

    ``use_kernel=False`` selects the sequential host oracle
    (``kernels.ref``), which exists only on the CPU.
    """

    def __init__(self, n_packets: int, payload_width: int, *,
                 use_kernel: bool = True, device=None):
        self.device = resolve_device(device)
        if not use_kernel and self.device.type != "cpu":
            raise ValueError("use_kernel=False (the sequential oracle) "
                             "runs on the CPU only")
        self.total = torch.zeros((n_packets, payload_width),
                                 dtype=torch.float32, device=self.device)
        self.counts = torch.zeros((n_packets,), dtype=torch.float32,
                                  device=self.device)
        self.use_kernel = use_kernel
        self._finalized: Optional[torch.Tensor] = None

    def scatter_add(self, packets, idx, weights: Union[float, object] = 1.0,
                    mode: str = "exact") -> None:
        """Fold a drained ring batch of *out-of-order* packets into the
        state through the scatter-accumulate kernel, in place.

        packets (B, W) f32 at slot rows idx (B,) — the packet-path server
        engine (core/server.py) calls this once per drained ring.
        ``mode="approx"`` is the deterministic lock-free race: within the
        batch the last writer to a slot wins, counts see every arrival
        (DESIGN.md §3).
        """
        assert self._finalized is None, "aggregator already finalized"
        packets = as_tensor(packets, self.device)
        idx = as_tensor(idx, self.device, torch.int32)
        w = as_tensor(weights, self.device).expand(packets.shape[0])
        w = w.contiguous()
        if self.use_kernel:
            _ops.packet_scatter_accum(packets, idx, self.total, self.counts,
                                      weights=w, mode=mode, donate=True)
        else:
            self.total, self.counts = _ref.packet_scatter_accum_ref(
                packets, idx, self.total, self.counts, weights=w, mode=mode)

    def finalize(self) -> torch.Tensor:
        if self._finalized is None:
            self._finalized = finalize_mean(self.total, self.counts)
        return self._finalized

    def reset(self) -> None:
        self.total.zero_()
        self.counts.zero_()
        self._finalized = None
