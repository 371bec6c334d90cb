"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc -gencode arch=compute_90a,code=sm_90a``
into its own shared library with a plain C interface, loaded through
``ctypes``: a few seconds per file, against minutes for an extension that
includes PyTorch's headers. Nothing here runs at import: ``load`` builds a
library the first time a wrapper launches its kernel (the smoke test calls
it for every kernel at once, from one thread each, so the ``nvcc``
processes run side by side).

Libraries land in ``build/repro_torch/`` at the repository root (git
ignores it), named by a hash of their source and flags, so an edited
source is rebuilt and an unchanged one is reused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("filter_eval", "fiber_expand", "masked_cosine_topk")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on PATH,
    then the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([pathlib.Path(home) / "bin" / "nvcc"] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and pathlib.Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _lib_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        out = _lib_path(name)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        _LIBS[name] = lib
    return lib


def ptr(t: torch.Tensor | None) -> int | None:
    """Device address of a tensor for a ``c_void_p`` argument (None for
    an absent optional input, which the C side reads as a null pointer)."""
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device`` as a ``c_void_p``."""
    return torch.cuda.current_stream(device).cuda_stream


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (the C side returns
    ``cudaGetLastError()`` right after the launch)."""
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def require_cuda(what: str, **tensors: torch.Tensor) -> torch.device:
    """Every named tensor must be a contiguous CUDA tensor on one device;
    returns that device."""
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{what}: inputs must share one CUDA device, got "
                         f"{ {k: str(t.device) for k, t in tensors.items()} }")
    bad = [k for k, t in tensors.items() if not t.is_contiguous()]
    if bad:
        raise ValueError(f"{what}: inputs must be contiguous: {bad}")
    return devs.pop()


def require_dtype(what: str, dtype: torch.dtype, **tensors) -> None:
    bad = {k: t.dtype for k, t in tensors.items() if t.dtype != dtype}
    if bad:
        raise ValueError(f"{what}: expected {dtype}, got {bad}")
