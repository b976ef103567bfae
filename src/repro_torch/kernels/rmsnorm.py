"""Row RMSNorm: the CUDA kernel for Hopper, its wrapper and its plain
PyTorch version.

The kernel (``csrc/rmsnorm.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/rmsnorm.py:22`` ``rmsnorm`` (body ``_rmsnorm_kernel``):
per row, the fp32 mean square, ``1/sqrt(var + eps)``, the cast to x's
type and then ``* w``.  Where the TPU kernel normalises (block_rows, D)
tiles, the CUDA kernel gives each row one warp: the TMA engine copies the
row once into shared memory, the warp reduces the square sum by shuffles
and writes with 16-byte stores; a row that is not 16-byte aligned takes a
scalar path of the same kernel.

What bounds it at the smoke shape (x (4096, 2560)): bytes, by the data
sheet (a few operations per element).  Its time on an H100 beside that
bound, and beside ``torch.nn.functional.rms_norm``, is in ``PERF.md``.

No model calls it: the models use ``models/layers.rms_norm``, as the
reference's models use the jnp ``rms_norm``.  Its entry point is
``ops.rmsnorm``.  ``block_rows`` is validated as the reference validates
it and sets no tile.  ``launches`` counts kernel launches (never
plain-path calls); callers reset it by assigning 0.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from . import ref as _ref
from .variants import _clamp_div

__all__ = ["rmsnorm", "rmsnorm_plain", "build", "launches"]

launches = 0

_lib = None


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load("rmsnorm")
    fn = lib.rmsnorm_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def rmsnorm_plain(x, w, *, eps: float = 1e-6):
    """The same function in plain PyTorch (``ref.rmsnorm_ref``), in x's
    type; what the wrapper runs for CPU tensors."""
    return _ref.rmsnorm_ref(x, w, eps=eps).to(x.dtype)


def rmsnorm(x, w, *, eps: float = 1e-6, block_rows: int = 256):
    """x: (N, D); w: (D,) → (N, D) in x's type.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    global launches
    if x.dim() != 2 or tuple(w.shape) != (x.shape[1],):
        raise ValueError(f"want x (N,D) and w (D,); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    N, D = x.shape
    if _clamp_div(block_rows, N) is None:
        raise ValueError(f"tile block_rows={block_rows} does not divide "
                         f"N={N} after clamping")
    if x.device.type == "cpu":
        return rmsnorm_plain(x, w, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if w.device != x.device:
        raise ValueError("x and w must lie on one device")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"the kernel takes x and w of one type, float32 or "
                        f"bfloat16; got {x.dtype}, {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    o = torch.empty_like(x)
    lib = build()
    with torch.cuda.device(x.device):
        err = lib.rmsnorm_fwd(
            x.data_ptr(), w.data_ptr(), o.data_ptr(), N, D, float(eps),
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"rmsnorm_fwd failed to launch: CUDA error {err}")
    launches += 1
    return o
