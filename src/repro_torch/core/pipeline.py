"""Streaming aggregation state of the FedAvg server (§3.2.2).

``StreamingAggregator`` keeps the running ``(total, counts)`` pair of a
round on the device, the paper's "reception and addition in parallel
until END" semantics:

- ``add`` folds one client upload (N, W) with its arrival mask, or a
  client batch (B, N, W), into the state;
- ``add_batch`` folds a client batch through the FedAvg accumulation
  kernel (``kernels/ops.py::fedavg_accum_into``, raw sums), in place;
- ``scatter_add`` folds a drained ring batch of *out-of-order* packets
  through the scatter-accumulate kernel (the packet-path server engine);
- ``finalize`` is the END divide of the sum by the counts.

Torch port of ``repro.core.pipeline``.  The reference donates
``(total, counts)`` to every fold; here the folds update them in place.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple, Union

import torch

from repro_torch.core.device import as_tensor, resolve_device
from repro_torch.kernels import ops as _ops
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.fedavg_accum import finalize_mean


class StreamingAggregator:
    """Count-normalized streaming FedAvg server state on ``device``.

    ``use_kernel=False`` selects the plain folds: an einsum for client
    batches and the sequential host oracle (``kernels.ref``) for ring
    batches, which exists only on the CPU.
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

    def add(self, packets, mask, weight: Union[float, object] = 1.0
            ) -> None:
        """Fold one upload (N, W) or a batch (B, N, W) into the state.

        ``weight`` is the FedAvg n_k weight: a scalar for a single
        upload, a scalar or a (B,) vector for a batch.
        """
        assert self._finalized is None, "aggregator already finalized"
        packets = as_tensor(packets, self.device)
        if packets.dim() == 3:
            self.add_batch(packets, mask, weight)
            return
        m = as_tensor(mask, self.device) * as_tensor(weight, self.device)
        self.total.add_(packets * m[:, None])
        self.counts.add_(m)

    def add_batch(self, packets, mask,
                  weights: Union[float, object] = 1.0) -> None:
        """Fold a client batch (B, N, W) + mask (B, N) into the state,
        in place."""
        assert self._finalized is None, "aggregator already finalized"
        packets = as_tensor(packets, self.device)
        mask = as_tensor(mask, self.device)
        w = as_tensor(weights, self.device).expand(mask.shape[:1])
        wmask = mask * w[:, None]
        if self.use_kernel:
            self.total, self.counts = _ops.fedavg_accum_into(
                self.total, self.counts, packets, wmask)
        else:
            self.total.add_(torch.einsum("knw,kn->nw", packets, wmask))
            self.counts.add_(wmask.sum(dim=0))

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
                                      w, mode=mode)
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


def streaming_rounds(uploads: Iterable[Tuple[object, object]],
                     n_packets: int, payload_width: int, *,
                     device=None) -> torch.Tensor:
    """Drain an iterable of (packets, mask) uploads through the pipeline
    on ``device``.  Each item may be a single upload (N, W) or a client
    batch (B, N, W)."""
    server = StreamingAggregator(n_packets, payload_width, device=device)
    for packets, mask in uploads:
        server.add(packets, mask)
    return server.finalize()
