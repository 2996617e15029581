"""Count-normalized masked FedAvg accumulation (paper §3.2.2, Algorithm 1).

The server sums K clients' packetized parameters, each packet weighted by
its client's FedAvg weight and dropped where it was lost on the uplink,
and divides every packet by the weight that actually arrived.  Payloads
are client-major ``(K, C, W)`` (K clients, C packets of W weights) with a
``(K, C)`` weighted arrival mask.

Each function comes in two forms:

- ``fedavg_accum`` / ``fedavg_accum_into``: the wrappers.  On CUDA
  tensors they launch the hand-written kernel of ``csrc/fedavg_accum.cu``
  (built with ``nvcc`` for ``sm_90a`` at first use, loaded with
  ``ctypes``) and count each launch in ``fedavg_accum.launches``; on CPU
  tensors they run the plain version.
- ``fedavg_accum_plain``: plain PyTorch with the kernel's arithmetic:
  the clients are summed in blocks of 8 in order, each block's sum is
  formed from zero and then added to the running total, as the
  reference's Pallas kernel (``repro.kernels.fedavg_accum``) carries its
  output block across the client blocks.

The int8 twin is ``kernels/quantized_accum.py``; both kernels live in one
CUDA source and one library.
"""
from __future__ import annotations

import functools
from typing import Callable, Tuple

import torch

from repro_torch.kernels import _build

BLOCK_CLIENTS = 8          # the Pallas kernel's client block (BK)
RAW, FINALIZE, INTO = 0, 1, 2    # the kernel's modes (csrc/fedavg_accum.cu)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the yardstick on the card)
# ---------------------------------------------------------------------------

def finalize_mean(total: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """END divide: total / max(counts, 1e-12), 0 where nobody delivered."""
    avg = total / torch.clamp_min(counts, 1e-12)[:, None]
    return torch.where(counts[:, None] > 0, avg, 0.0)


def blocked_sums(term: Callable[[int], torch.Tensor], m: torch.Tensor,
                 width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum ``term(k)`` (C, W) and ``m[k]`` (C,) over the K clients of the
    (K, C) mask ``m`` in the kernel's order: blocks of ``BLOCK_CLIENTS``
    in client order, each block's sum formed from zero, then added to the
    running total.  -> (sums (C, W), counts (C,)), f32."""
    K, C = m.shape
    total = torch.zeros((C, width), dtype=torch.float32, device=m.device)
    count = torch.zeros((C,), dtype=torch.float32, device=m.device)
    for k0 in range(0, K, BLOCK_CLIENTS):
        bsum, bcnt = torch.zeros_like(total), torch.zeros_like(count)
        for k in range(k0, min(k0 + BLOCK_CLIENTS, K)):
            bsum = bsum + term(k)
            bcnt = bcnt + m[k]
        total = total + bsum
        count = count + bcnt
    return total, count


def fedavg_accum_plain(packets: torch.Tensor, wmask: torch.Tensor, *,
                       finalize: bool = True):
    """packets (K, C, W) f32 or bf16, wmask (K, C) f32 -> (avg (C, W),
    counts (C,)); with ``finalize=False`` the raw masked sums."""
    x = packets.to(torch.float32)
    m = wmask.to(torch.float32)
    total, count = blocked_sums(lambda k: x[k] * m[k, :, None], m,
                                x.shape[2])
    return (finalize_mean(total, count) if finalize else total), count


# ---------------------------------------------------------------------------
# The CUDA kernel: load, check, launch
# ---------------------------------------------------------------------------

@functools.cache
def load_library() -> _build.KernelLibrary:
    """Build ``csrc/fedavg_accum.cu`` (once per source hash) and load it."""
    built = _build.load("fedavg_accum")
    _build.declare(built.lib, "fedavg_accum_f32", 4, 4)
    _build.declare(built.lib, "fedavg_accum_bf16", 4, 4)
    _build.declare(built.lib, "quantized_accum_i8", 5, 4)
    return built


PAYLOAD_DTYPES = (torch.float32, torch.bfloat16)


def check_inputs(packets: torch.Tensor, wmask: torch.Tensor,
                 dtypes: tuple) -> Tuple[int, int, int]:
    """Raise unless packets (K, C, W) of one of ``dtypes`` and wmask (K, C)
    f32 are contiguous on one CPU or CUDA device.  -> (K, C, W)."""
    if not isinstance(packets, torch.Tensor) or packets.dim() != 3:
        raise ValueError("packets must be a (K, C, W) tensor")
    if packets.dtype not in dtypes:
        raise TypeError(f"packets must be one of {dtypes}, got "
                        f"{packets.dtype}")
    dev = packets.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no fedavg_accum kernel for {dev}")
    K, C, W = packets.shape
    _build.check_tensor("packets", packets, packets.dtype, (K, C, W), dev)
    _build.check_tensor("wmask", wmask, torch.float32, (K, C), dev)
    return K, C, W


def launch(fn: str, ptrs: tuple, shape: tuple, mode: int,
           device: torch.device, counter) -> None:
    """One launch of ``fn`` of the library on ``device``'s current stream;
    raises on a CUDA error code, then adds one to ``counter.launches``."""
    lib = load_library()
    lib.check(getattr(lib.lib, fn)(*ptrs, *shape, mode,
                                   _build.stream(device)), fn)
    counter.launches += 1


def _entry(packets: torch.Tensor) -> str:
    """The library function for the payload type."""
    return ("fedavg_accum_bf16" if packets.dtype == torch.bfloat16
            else "fedavg_accum_f32")


def fedavg_accum(packets: torch.Tensor, wmask: torch.Tensor, *,
                 finalize: bool = True):
    """Masked FedAvg sum over the K clients.

    packets (K, C, W) f32 or bf16 (widened to f32 exactly); wmask (K, C)
    f32 weighted arrival mask.  -> (avg (C, W) f32, counts (C,) f32):
    ``avg`` is the sum over k of ``packets[k] * wmask[k]`` divided by
    ``counts = sum_k wmask[k]`` and 0 where that is 0, or with
    ``finalize=False`` the raw sum.  CUDA tensors launch the kernel; CPU
    tensors run ``fedavg_accum_plain``.
    """
    K, C, W = check_inputs(packets, wmask, PAYLOAD_DTYPES)
    if packets.device.type == "cpu":
        return fedavg_accum_plain(packets, wmask, finalize=finalize)
    out = torch.empty((C, W), dtype=torch.float32, device=packets.device)
    cnt = torch.empty((C,), dtype=torch.float32, device=packets.device)
    ptrs = (packets.data_ptr(), wmask.data_ptr(), out.data_ptr(),
            cnt.data_ptr())
    launch(_entry(packets), ptrs, (K, C, W), FINALIZE if finalize else RAW,
           packets.device, fedavg_accum)
    return out, cnt


fedavg_accum.launches = 0


def fedavg_accum_into(total: torch.Tensor, counts: torch.Tensor,
                      packets: torch.Tensor, wmask: torch.Tensor):
    """Streaming fold, in place: total (C, W) += the raw masked sums of
    packets (K, C, W) under wmask (K, C), counts (C,) += their counts.

    The sums are formed from zero first and then added (the reference's
    ``total + sums``), never added block by block into ``total``, which
    would round differently.  One launch of the ``fedavg_accum`` kernel
    on CUDA tensors (counted in ``fedavg_accum.launches``); the plain
    version on CPU tensors.  -> (total, counts).
    """
    K, C, W = check_inputs(packets, wmask, PAYLOAD_DTYPES)
    dev = packets.device
    _build.check_tensor("total", total, torch.float32, (C, W), dev)
    _build.check_tensor("counts", counts, torch.float32, (C,), dev)
    if dev.type == "cpu":
        sums, cnts = fedavg_accum_plain(packets, wmask, finalize=False)
        total.add_(sums)
        counts.add_(cnts)
        return total, counts
    ptrs = (packets.data_ptr(), wmask.data_ptr(), total.data_ptr(),
            counts.data_ptr())
    launch(_entry(packets), ptrs, (K, C, W), INTO, dev, fedavg_accum)
    return total, counts
