"""Where the port's entry points run, and how host inputs reach it."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device, and raises where there is none:
    the CPU runs only when the caller asks for it (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def host_array(x, dtype=None) -> np.ndarray:
    """A numpy view (or copy) of ``x``, which may be a tensor on any
    device, a numpy array or a sequence."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def as_tensor(x, device: torch.device,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x`` (numpy array or tensor) as a ``dtype`` tensor on ``device``."""
    if isinstance(x, np.ndarray):
        # read-only arrays (views of other frameworks' buffers) are copied
        x = torch.from_numpy(np.ascontiguousarray(x) if x.flags.writeable
                             else np.array(x))
    return torch.as_tensor(x, dtype=dtype, device=device)
