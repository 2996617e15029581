"""Int8 dequantizing FedAvg accumulation (beyond paper).

The twin of ``kernels/fedavg_accum.py`` on the int8 wire: per-packet
absmax-scaled int8 payloads ``q (K, C, W)`` with scales ``(K, C)``.  The
dequantization fuses into the add as ``q * (s * m)``, the product of
scale and weighted mask first; that order is part of the bitwise
contract with the reference's Pallas kernel
(``repro.kernels.quantized_accum``).  The f32 copies of the client
payloads never reach device memory, so the kernel reads a quarter of
the f32 kernel's bytes.

- ``quantized_accum``: the wrapper.  On CUDA tensors it launches the
  int8 kernel of ``csrc/fedavg_accum.cu`` and counts each launch in
  ``quantized_accum.launches``; on CPU tensors it runs the plain version.
- ``quantized_accum_plain``: plain PyTorch with the kernel's arithmetic
  and client order (``fedavg_accum.blocked_sums``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fedavg_accum import (FINALIZE, RAW, blocked_sums,
                                              check_inputs, finalize_mean,
                                              launch)


def quantized_accum_plain(q: torch.Tensor, scales: torch.Tensor,
                          wmask: torch.Tensor, *, finalize: bool = True):
    """q (K, C, W) int8, scales and wmask (K, C) f32 -> (avg (C, W),
    counts (C,)); with ``finalize=False`` the raw sums."""
    x = q.to(torch.float32)
    m = wmask.to(torch.float32)
    sm = scales.to(torch.float32) * m
    total, count = blocked_sums(lambda k: x[k] * sm[k, :, None], m,
                                x.shape[2])
    return (finalize_mean(total, count) if finalize else total), count


def quantized_accum(q: torch.Tensor, scales: torch.Tensor,
                    wmask: torch.Tensor, *, finalize: bool = True):
    """Masked FedAvg sum over K clients of int8 payloads.

    q (K, C, W) int8; scales (K, C) f32 per-packet dequant scales; wmask
    (K, C) f32 weighted arrival mask.  -> (avg (C, W) f32, counts (C,)
    f32), as ``fedavg_accum`` on the rows ``q * scale``, with each term
    rounded as ``q * (scale * wmask)``.  CUDA tensors launch the kernel;
    CPU tensors run ``quantized_accum_plain``.
    """
    K, C, W = check_inputs(q, wmask, (torch.int8,))
    dev = q.device
    _build.check_tensor("scales", scales, torch.float32, (K, C), dev)
    if dev.type == "cpu":
        return quantized_accum_plain(q, scales, wmask, finalize=finalize)
    out = torch.empty((C, W), dtype=torch.float32, device=dev)
    cnt = torch.empty((C,), dtype=torch.float32, device=dev)
    launch("quantized_accum_i8", (q.data_ptr(), scales.data_ptr(),
                                  wmask.data_ptr(), out.data_ptr(),
                                  cnt.data_ptr()),
           (K, C, W), FINALIZE if finalize else RAW, dev, quantized_accum)
    return out, cnt


quantized_accum.launches = 0
