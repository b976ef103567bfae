"""RG-LRU diagonal linear recurrence ``h_t = a_t ⊙ h_{t-1} + b_t``: the
CUDA kernel for Hopper, its wrapper and its plain PyTorch version.

The kernel (``csrc/rglru_scan.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/rglru_scan.py:56`` ``rglru_scan`` (bodies
``_rglru_kernel``, ``_scan_block``).  Where the TPU kernel scans chunks of
``block_t`` tokens by doubling and carries a row across a sequential grid,
the CUDA kernel gives each (b, d) channel one thread that walks T in
order, with coalesced loads along d.  It rounds each step as the plain
version does, so the two agree bit for bit on the card.

What bounds it at recurrentgemma-2b's width (a, b (1, 4096, 2560) fp32):
bytes, by the data sheet (12 bytes per element, two operations).  The
simple design leaves most of the memory rate unused: B·D = 2560 channels
are 80 warps on 132 SMs, too few loads in flight.  Its time on an H100
beside that bound is in ``PERF.md``.

Layout: a, b (B, T, D), cast to fp32 as the reference casts them; out
h (B, T, D) fp32.  ``block_t`` is validated as the reference validates it
and sets no tile.  ``launches`` counts kernel launches (never plain-path
calls); callers reset it by assigning 0.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from . import ref as _ref
from .variants import _clamp_div

__all__ = ["rglru_scan", "rglru_scan_plain", "build", "launches"]

launches = 0

_lib = None


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load("rglru_scan")
    fn = lib.rglru_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def rglru_scan_plain(a, b):
    """The same function in plain PyTorch: the sequential scan
    (``ref.rglru_scan_ref``); what the wrapper runs for CPU tensors."""
    return _ref.rglru_scan_ref(a, b)


def rglru_scan(a, b, *, block_t: int = 256):
    """a, b: (B, T, D) → inclusive scan h (B, T, D) fp32.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    global launches
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"want a = b of shape (B,T,D); got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    B, T, D = a.shape
    if _clamp_div(block_t, T) is None:
        raise ValueError(f"tile block_t={block_t} does not divide T={T} "
                         "after clamping")
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if b.device != a.device:
        raise ValueError("a and b must lie on one device")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the kernel's grid (65535)")
    a = a.float().contiguous()
    b = b.float().contiguous()
    h = torch.empty_like(a)
    lib = build()
    with torch.cuda.device(a.device):
        err = lib.rglru_scan_fwd(
            a.data_ptr(), b.data_ptr(), h.data_ptr(), B, T, D,
            torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"rglru_scan_fwd failed to launch: CUDA error "
                           f"{err}")
    launches += 1
    return h
