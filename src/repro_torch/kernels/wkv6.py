"""RWKV-6 recurrence: the CUDA kernel for Hopper, its wrapper and its plain
PyTorch version.

The kernel (``csrc/wkv6.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/wkv6.py:86`` ``wkv6_folded`` (body ``_wkv6_kernel``).
Per head, from S = 0: ``o_t = r_t·(S + u⊙k_t⊗v_t)`` and
``S = diag(w_t)·S + k_t⊗v_t``; it returns o and the final S, both fp32.
Where the TPU kernel turns a chunk of ``block_t`` tokens into matrix
products (dividing k by a cumulative decay product, which underflows for
long chunks), the CUDA kernel steps token by token, with each column of S
split over four lanes and held in registers.

What bounds it at rwkv6-3b's width (r, k, v, w (1, 4096, 40, 64)): by the
data sheet, bytes (fp32 inputs) or fp32 operations (bf16 r/k/v/u) about
equally; the kernel itself is latency-bound, since a head's tokens run in
order inside one block and B·H = 40 heads give only 160 blocks of 2 warps
at B = 1.  Its time on an H100 beside that bound is in ``PERF.md``.

Layouts (folded in ``ops.py``): r, k, v, w (BH, T, hs); u (BH, hs).
r, k, v, u are fp32 or bf16 (one type); w is fp32, as the model computes
it.  ``block_t`` is validated as the reference validates it (clamp to T,
then require it to divide T) and sets no tile.  ``launches`` counts kernel
launches (never plain-path calls); callers reset it by assigning 0.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from . import ref as _ref
from .variants import _clamp_div

__all__ = ["wkv6_folded", "wkv6_plain", "build", "launches", "HEAD_SIZES"]

HEAD_SIZES = (8, 16, 32, 64, 128)   # head sizes the kernel is built for

launches = 0

_lib = None


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load("wkv6")
    fn = lib.wkv6_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def wkv6_plain(r, k, v, w, u):
    """The same function in plain PyTorch: the sequential recurrence on the
    folded layout (``ref.wkv6_ref``); what the wrapper runs for CPU
    tensors."""
    return _ref.wkv6_ref(r, k, v, w, u)


def wkv6_folded(r, k, v, w, u, *, block_t: int = 64):
    """r, k, v, w: (BH, T, hs); u: (BH, hs).  Returns (o (BH, T, hs) fp32,
    final state (BH, hs, hs) fp32).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    global launches
    if r.dim() != 3 or any(x.shape != r.shape for x in (k, v, w)):
        raise ValueError(f"want r, k, v, w of one shape (BH,T,hs); got "
                         f"{[tuple(x.shape) for x in (r, k, v, w)]}")
    BH, T, hs = r.shape
    if tuple(u.shape) != (BH, hs):
        raise ValueError(f"u {tuple(u.shape)} is not (BH, hs) = "
                         f"{(BH, hs)}")
    if _clamp_div(block_t, T) is None:
        raise ValueError(f"tile block_t={block_t} does not divide T={T} "
                         "after clamping")
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u)
    if r.device.type != "cuda":
        raise ValueError(f"unsupported device {r.device}")
    if any(x.device != r.device for x in (k, v, w, u)):
        raise ValueError("r, k, v, w, u must lie on one device")
    if r.dtype not in (torch.float32, torch.bfloat16) or \
            any(x.dtype != r.dtype for x in (k, v, u)):
        raise TypeError(f"the kernel takes r, k, v, u of one type, float32 "
                        f"or bfloat16; got {r.dtype}, {k.dtype}, {v.dtype}, "
                        f"{u.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"the kernel takes w in float32, not {w.dtype}")
    if hs not in HEAD_SIZES:
        raise ValueError(f"head size {hs} not in {HEAD_SIZES}")
    if not all(x.is_contiguous() for x in (r, k, v, w, u)):
        raise ValueError("r, k, v, w, u must be contiguous")
    o = torch.empty((BH, T, hs), dtype=torch.float32, device=r.device)
    s = torch.empty((BH, hs, hs), dtype=torch.float32, device=r.device)
    lib = build()
    with torch.cuda.device(r.device):
        err = lib.wkv6_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), o.data_ptr(), s.data_ptr(), BH, T, hs,
            int(r.dtype == torch.bfloat16),
            torch.cuda.current_stream(r.device).cuda_stream)
    if err:
        raise RuntimeError(f"wkv6_fwd failed to launch: CUDA error {err}")
    launches += 1
    return o, s
