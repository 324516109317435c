"""Build and load the port's CUDA kernels (``csrc/kernels.cu``).

The source is compiled at first use with ``nvcc`` into a shared library
with a plain C interface, and loaded with ``ctypes``: a build of a few
seconds, with no PyTorch headers, no ninja and no lock file. The library
is named after a hash of the source, so an edited source is rebuilt and a
stale library is never loaded. Nothing here runs when the module is
imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "kernels.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
BUILD_TIMEOUT_S = 180

_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "slam_gated_match": [_P] * 12 + [_I] * 4 + [_P],
    "slam_hamming_matrix": [_P, _P, _P, _I, _I, _P],
    "slam_gated_match_batched": [_P] * 12 + [_I] * 5 + [_P],
    "slam_hamming_batched": [_P, _P, _P, _I, _I, _I, _P],
    "slam_pose_lm": [_P] * 13 + [_I] * 4 + [_F, _P],
    "slam_pose_lm_batched": [_P] * 13 + [_I] * 5 + [_F, _P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(source: Path = SOURCE) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"slam_kernels_{digest[:16]}.so"


def build(source: Path = SOURCE) -> Path:
    """Compile ``source`` unless its library exists. ptxas's report
    (registers, shared memory and spills of each kernel) is kept beside
    the library as ``<name>.ptxas.txt``."""
    so = library_path(source)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True,
                          timeout=BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    so.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)        # atomic: a reader never sees half a library
    return so


def load(so: Path) -> ctypes.CDLL:
    """Load a kernel library built by ``build`` and declare its entry
    points (those it has: an earlier revision's library, which
    ``kernel_bench --old-source`` builds, may lack the batched ones)."""
    handle = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return handle


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        _lib = load(build())
    return _lib


def check(status: int, name: str):
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError "
                           f"{status}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
            device: torch.device, align: int = 1):
    """Validate one kernel argument (the kernels take no other layout);
    ``align`` is the byte alignment of the kernel's vector loads."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: address not aligned to {align} bytes")


def lane_major(t: torch.Tensor, in_dim, lanes: int) -> torch.Tensor:
    """An argument of a vmap rule with its lane axis first and contiguous:
    a batched one (``in_dim`` its lane axis) moved there, an unbatched one
    (``in_dim`` None) repeated for every lane."""
    t = t.expand(lanes, *t.shape) if in_dim is None else t.movedim(in_dim, 0)
    return t.contiguous()
