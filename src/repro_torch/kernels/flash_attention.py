"""Causal/sliding-window GQA flash attention forward: the two CUDA kernels
for Hopper, their wrapper and the plain PyTorch version.

Both kernels replace the Pallas TPU kernel
``src/repro/kernels/flash_attention.py:flash_attention_folded`` (body
``_flash_kernel``); ``route(dtype, D)`` picks one from the type and the
head dim alone:

- ``"sm90"`` (``csrc/flash_attention_sm90.cu``): bf16 with D in
  ``SM90_HEAD_DIMS``, on the tensor cores (TMA loads, wgmma products in
  fp32, the softmax weights rounded to bf16 before P.V);
- ``"simt"`` (``csrc/flash_attention.cu``): every other case (fp32, and
  bf16 with D < 64), fp32 FMAs on the CUDA cores, register-tiled with
  16-byte ``cp.async`` staging of K and V in 64-key chunks.  fp32 stays
  there: TF32 tensor cores keep about three decimal digits, too few for
  the 2e-5 tolerance of the reference's sweep.

This is a dispatch by shape, not a fallback: a build or launch failure on
either route raises.  Both are bound by operations on an H100; each source
says what its design does about that.

Layouts (folded in ``ops.py``): q (BK, S, G, D) pre-scaled by 1/sqrt(D);
k, v (BK, T, D) where BK = batch x kv_heads.  Output: (BK, S, G, D).

The tile parameters ``block_q``/``block_k`` are validated exactly as the
reference does (clamp to the axis, then require it to divide), so every
registry tile is legal here too; neither kernel's own tiling (SIMT: 64
rows a block, keys in chunks of ``BC`` = 64; sm90: 128 rows x 128 or 64
keys) depends on them.

The kernels are built with ``nvcc`` at first use (``_build.load``;
the sm90 one links ``-lcuda`` for its TMA descriptors) and bound with
``ctypes``.  ``launches`` counts kernel launches on either route, and
``launches_sm90`` / ``launches_simt`` each route's (never plain-path
calls); callers reset them by assigning 0.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .variants import _clamp_div

__all__ = ["flash_attention_folded", "flash_attention_plain", "build",
           "build_sm90", "route", "launches", "launches_sm90",
           "launches_simt", "NEG_INF", "HEAD_DIMS", "SM90_HEAD_DIMS"]

NEG_INF = -1e30
HEAD_DIMS = (8, 16, 32, 64, 128, 256)     # head dims the kernels are built for
SM90_HEAD_DIMS = (64, 128, 256)           # ... of which bf16 takes the sm90 one

launches = 0
launches_sm90 = 0
launches_simt = 0

_lib = None
_lib_sm90 = None


def route(dtype, D: int) -> str:
    """The kernel a CUDA call with this type and head dim launches:
    ``"sm90"`` for bf16 with D in ``SM90_HEAD_DIMS``, else ``"simt"``."""
    return "sm90" if dtype == torch.bfloat16 and D in SM90_HEAD_DIMS \
        else "simt"


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def build_sm90() -> ctypes.CDLL:
    """Compile (once per source hash) and load the tensor-core kernel."""
    global _lib_sm90
    if _lib_sm90 is not None:
        return _lib_sm90
    lib = _build.load("flash_attention_sm90", extra_flags=("-lcuda",))
    fn = lib.flash_attention_fwd_sm90
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib_sm90 = lib
    return lib


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """The same function in plain PyTorch (einsum, mask, softmax), on the
    folded layout; what the wrapper runs for CPU tensors."""
    S, T = q.shape[1], k.shape[1]
    s = torch.einsum("bsgd,btd->bgst", q.float(), k.float())
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (q_pos >= k_pos)
    if window:
        mask = mask & ((q_pos - k_pos) < window)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bgst,btd->bsgd", p, v.float()).to(q.dtype)


def flash_attention_folded(q, k, v, *, causal: bool = True, window: int = 0,
                           block_q: int = 128, block_k: int = 128):
    """q: (BK, S, G, D) pre-scaled by 1/sqrt(D); k, v: (BK, T, D).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    ``route(q.dtype, D)`` names, or raise.  Returns (BK, S, G, D) in q's
    dtype."""
    global launches, launches_sm90, launches_simt
    if q.dim() != 4 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"want q (BK,S,G,D), k = v (BK,T,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    BK, S, G, D = q.shape
    T = k.shape[1]
    if k.shape[0] != BK or k.shape[2] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    for block, axis in ((block_q, S), (block_k, T)):
        if _clamp_div(block, axis) is None:
            raise ValueError(f"tile {block} does not divide axis {axis} "
                             "after clamping")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes float32 or bfloat16, not "
                        f"{q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if BK > 65535 or S * G * D >= 2 ** 31 or T * D >= 2 ** 31:
        raise ValueError(f"shape too large for the kernel: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route(q.dtype, D) == "sm90":
        # TMA reads from 16-byte aligned addresses only
        if any(x.data_ptr() % 16 for x in (q, k, v, out)):
            raise ValueError("q, k, v must be 16-byte aligned")
        lib = build_sm90()
        with torch.cuda.device(q.device):
            err = lib.flash_attention_fwd_sm90(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                BK, S, T, G, D, int(causal), int(window), stream)
        if err:
            raise RuntimeError(f"flash_attention_fwd_sm90 failed to launch: "
                               f"{_describe(err)}")
        launches_sm90 += 1
    else:
        # the kernel stages 16-byte pieces: a view that starts off that
        # alignment is copied into a fresh (aligned) allocation
        q, k, v = (x.clone() if x.data_ptr() % 16 else x for x in (q, k, v))
        lib = build()
        with torch.cuda.device(q.device):
            err = lib.flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                BK, S, T, G, D, int(causal), int(window),
                int(q.dtype == torch.bfloat16), stream)
        if err:
            raise RuntimeError(f"flash_attention_fwd failed to launch: "
                               f"{_describe(err)}")
        launches_simt += 1
    launches += 1
    return out


def _describe(err: int) -> str:
    """A kernel's non-zero return: a cudaError_t, or a negated CUresult
    from encoding a tensor map."""
    return f"CUDA error {err}" if err > 0 else \
        f"tensor map encoding failed (CUresult {-err})"
