"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with
``nvcc`` for ``sm_90a`` into its own shared library in the repo root's
git-ignored ``build/``, keyed by the source's hash, at first use; the
library is then loaded with ``ctypes``.  Every source exports
``<name>_error_string(int)`` (``cudaGetErrorString``), which
``KernelLibrary.check`` uses to turn a launch's error code into an
exception.  There is no fallback: a failed build or launch raises.
``check_tensor`` and ``stream`` are what every wrapper needs before a
launch.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
# the repo root's build/ (git-ignored): src/repro_torch/kernels -> root
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: pathlib.Path
    build_seconds: float      # 0.0 when an up-to-date build was reused
    build_log: str            # nvcc's output (ptxas register/smem report)
    name: str                 # the source's stem

    def check(self, err: int, what: str) -> None:
        """Raise if a launch returned a CUDA error code."""
        if err != 0:
            msg = getattr(self.lib, f"{self.name}_error_string")(err)
            raise RuntimeError(f"{what} kernel launch failed: "
                               f"{msg.decode()} ({err})")


def _nvcc(source: pathlib.Path) -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       f"{source} at first use")


@functools.cache
def load(name: str) -> KernelLibrary:
    """Build ``csrc/<name>.cu`` into ``build/`` (once per source hash)
    and load it.  The caller sets the exported functions' argtypes."""
    source = CSRC / f"{name}.cu"
    tag = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}-{tag}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(source), *NVCC_FLAGS, "-o", str(tmp),
                               str(source)], capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    err_fn = getattr(lib, f"{name}_error_string")
    err_fn.argtypes = [ctypes.c_int]
    err_fn.restype = ctypes.c_char_p
    return KernelLibrary(lib, so, seconds, log, name)


def declare(lib: ctypes.CDLL, fn: str, n_ptr: int, n_int: int,
            n_float: int = 0) -> None:
    """``fn(ptr * n_ptr, int * n_int, float * n_float, stream) -> int``:
    the shape of every launch function in ``csrc/``.  Pointers (and the
    stream) must be ``c_void_p``, or ctypes passes them as 32-bit ints;
    a ``c_float`` argument rounds a Python float to f32 as numpy does."""
    f = getattr(lib, fn)
    f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                  + [ctypes.c_float] * n_float + [ctypes.c_void_p])
    f.restype = ctypes.c_int


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: tuple, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel of ``csrc/`` takes."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream(device: torch.device) -> int:
    """The current CUDA stream of ``device``, as the int a launch takes."""
    return torch.cuda.current_stream(device).cuda_stream
