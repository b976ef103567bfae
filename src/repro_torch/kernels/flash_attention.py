"""Causal/sliding-window GQA flash attention: the forward's two CUDA
kernels for Hopper, the sm90 backward, their wrappers and the plain
PyTorch versions.

Both forward kernels replace the Pallas TPU kernel
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

The backward: ``bwd_route(dtype, D, S, T, window)`` says which one a
gradient takes.  ``"sm90"`` (``flash_attention_bwd_folded``, two kernels in
``csrc/flash_attention_sm90.cu``: dq, then dk and dv, on the tensor cores
from the forward's saved log-sum-exp) for a CUDA call on the sm90 route
with D in ``SM90_BWD_HEAD_DIMS`` (64, 128: at D = 256 dk and dv do not fit
a warpgroup's registers) where every row sees a key (not when
``S - T >= window > 0``: such rows average every key, which an lse cannot
carry) and T > 0; ``"blockwise"`` for every other case and for CPU
tensors: ``kernels/ops.py`` then recomputes the gradient through
``models.attention.blockwise_attention`` under autograd.  For the sm90
backward the forward writes each row's log-sum-exp (fp32, natural log;
``return_lse=True``), which forward-only callers do not ask for.

This is a dispatch by shape, not a fallback: a build or launch failure on
any route raises.  Each source says what bounds its kernels on an H100 and
what its design does about that.

Layouts (folded in ``ops.py``): q (BK, S, G, D) pre-scaled by 1/sqrt(D);
k, v (BK, T, D) where BK = batch x kv_heads.  Output: (BK, S, G, D); lse
(BK, S, G), on the sm90 route a view of zero-padded rows of ``_lse_width``
floats a bk, the layout the sm90 backward reads.

The tile parameters ``block_q``/``block_k`` are validated exactly as the
reference does (clamp to the axis, then require it to divide), so every
registry tile is legal here too; neither kernel's own tiling (SIMT: 64
rows a block, keys in chunks of ``BC`` = 64; sm90: 128 rows x 128 or 64
keys) depends on them.

The kernels are built with ``nvcc`` at first use (``_build.load``;
the sm90 one links ``-lcuda`` for its TMA descriptors) and bound with
``ctypes``.  ``launches`` counts forward launches on either route, and
``launches_sm90`` / ``launches_simt`` each route's; ``launches_bwd_sm90``
counts calls of the sm90 backward (never plain-path calls); callers reset
them by assigning 0.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .variants import _clamp_div

__all__ = ["flash_attention_folded", "flash_attention_plain",
           "flash_attention_bwd_folded", "flash_attention_bwd_plain",
           "build", "build_sm90", "route", "bwd_route", "launches",
           "launches_sm90", "launches_simt", "launches_bwd_sm90", "NEG_INF",
           "HEAD_DIMS", "SM90_HEAD_DIMS", "SM90_BWD_HEAD_DIMS"]

NEG_INF = -1e30
HEAD_DIMS = (8, 16, 32, 64, 128, 256)     # head dims the kernels are built for
SM90_HEAD_DIMS = (64, 128, 256)           # ... of which bf16 takes the sm90 one
SM90_BWD_HEAD_DIMS = (64, 128)            # ... and the sm90 backward
LSE_ROWS = 128          # the sm90 lse's rows are padded to a multiple

launches = 0
launches_sm90 = 0
launches_simt = 0
launches_bwd_sm90 = 0

_lib = None
_lib_sm90 = None


def route(dtype, D: int) -> str:
    """The kernel a CUDA call with this type and head dim launches:
    ``"sm90"`` for bf16 with D in ``SM90_HEAD_DIMS``, else ``"simt"``."""
    return "sm90" if dtype == torch.bfloat16 and D in SM90_HEAD_DIMS \
        else "simt"


def bwd_route(dtype, D: int, S: int, T: int, window: int) -> str:
    """The backward a CUDA call with these inputs takes: ``"sm90"`` on the
    sm90 route with D in ``SM90_BWD_HEAD_DIMS``, T > 0 and a key for every
    row (not ``S - T >= window > 0``); else ``"blockwise"``."""
    every_row_sees_a_key = not (window > 0 and S - T >= window)
    return "sm90" if route(dtype, D) == "sm90" \
        and D in SM90_BWD_HEAD_DIMS and T > 0 and every_row_sees_a_key \
        else "blockwise"


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
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.flash_attention_bwd_sm90
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib_sm90 = lib
    return lib


def _mask(S: int, T: int, causal: bool, window: int, device):
    """(S, T) bool: which keys each query position sees."""
    q_pos = torch.arange(S, device=device)[:, None]
    k_pos = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (q_pos >= k_pos)
    if window:
        mask = mask & ((q_pos - k_pos) < window)
    return mask


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          return_lse: bool = False):
    """The same function in plain PyTorch (einsum, mask, softmax), on the
    folded layout; what the wrapper runs for CPU tensors.  With
    ``return_lse`` also each row's log-sum-exp (BK, S, G), fp32."""
    S, T = q.shape[1], k.shape[1]
    s = torch.einsum("bsgd,btd->bgst", q.float(), k.float())
    s = s.masked_fill(~_mask(S, T, causal, window, q.device), NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgst,btd->bsgd", p, v.float()).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).permute(0, 2, 1).contiguous()


def flash_attention_bwd_plain(q, k, v, o, do, lse, *, causal: bool = True,
                              window: int = 0):
    """The sm90 backward's arithmetic in plain PyTorch, fp32, on the folded
    layout: from the forward's o and lse (BK, S, G) and do = dL/do, the
    gradients (dq, dk, dv) of the folded q, k, v, in q's dtype.  P is
    exp(s - lse), so every row must see a key (``bwd_route``)."""
    S, T = q.shape[1], k.shape[1]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    mask = _mask(S, T, causal, window, q.device)
    s = torch.einsum("bsgd,btd->bgst", qf, kf).masked_fill(~mask, NEG_INF)
    p = torch.exp(s - lse.float().permute(0, 2, 1)[..., None])
    delta = (dof * o.float()).sum(-1).permute(0, 2, 1)      # (BK, G, S)
    dp = torch.einsum("bsgd,btd->bgst", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bgst,btd->bsgd", ds, kf)
    dk = torch.einsum("bgst,bsgd->btd", ds, qf)
    dv = torch.einsum("bgst,bsgd->btd", p, dof)
    return tuple(x.to(q.dtype) for x in (dq, dk, dv))


def flash_attention_folded(q, k, v, *, causal: bool = True, window: int = 0,
                           block_q: int = 128, block_k: int = 128,
                           return_lse: bool = False):
    """q: (BK, S, G, D) pre-scaled by 1/sqrt(D); k, v: (BK, T, D).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    ``route(q.dtype, D)`` names, or raise.  Returns (BK, S, G, D) in q's
    dtype; with ``return_lse`` (the sm90 route, T > 0) also each row's
    log-sum-exp (BK, S, G) fp32: a view of zeroed rows ``_lse_width(S*G)``
    floats apart, which ``flash_attention_bwd_folded`` takes as it is."""
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
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     return_lse=return_lse)
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
    if return_lse and (route(q.dtype, D) != "sm90" or T == 0):
        raise ValueError(f"the lse comes from the sm90 route over keys "
                         f"only, not {q.dtype} with D = {D}, T = {T}")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route(q.dtype, D) == "sm90":
        # TMA reads from 16-byte aligned addresses only
        if any(x.data_ptr() % 16 for x in (q, k, v, out)):
            raise ValueError("q, k, v must be 16-byte aligned")
        width = _lse_width(S * G)
        lse = torch.zeros((BK, width), dtype=torch.float32, device=q.device
                          ).as_strided((BK, S, G), (width, G, 1)) \
            if return_lse else None
        lib = build_sm90()
        with torch.cuda.device(q.device):
            err = lib.flash_attention_fwd_sm90(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                BK, S, T, G, D, int(causal), int(window),
                None if lse is None else lse.data_ptr(), width, stream)
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
    return (out, lse) if return_lse else out


def _lse_width(n_rows: int) -> int:
    """The sm90 lse's (and delta's) floats a bk: n_rows rounded up to
    ``LSE_ROWS``, since the backward reads a block's rows whole."""
    return -(-n_rows // LSE_ROWS) * LSE_ROWS


def flash_attention_bwd_folded(q, k, v, o, do, lse, *, causal: bool = True,
                               window: int = 0):
    """The gradients (dq, dk, dv) of the folded q, k, v, from the forward's
    o and lse (BK, S, G) and do = dL/do (BK, S, G, D), by the sm90
    backward: CUDA tensors where ``bwd_route`` names it, the lse as
    ``flash_attention_folded(..., return_lse=True)`` returns it; else
    raises (``flash_attention_bwd_plain`` is the same arithmetic in plain
    PyTorch)."""
    global launches_bwd_sm90
    BK, S, G, D = q.shape
    T = k.shape[1]
    if k.shape != (BK, T, D) or v.shape != k.shape or o.shape != q.shape \
            or do.shape != q.shape or lse.shape != (BK, S, G):
        raise ValueError(f"want q, o, do (BK,S,G,D), k = v (BK,T,D), lse "
                         f"(BK,S,G); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(o.shape)}, "
                         f"{tuple(do.shape)}, {tuple(lse.shape)}")
    if q.device.type != "cuda":
        raise ValueError(f"the sm90 backward runs on a card, not {q.device}")
    if any(x.device != q.device for x in (k, v, o, do, lse)):
        raise ValueError("q, k, v, o, do, lse must lie on one device")
    if any(x.dtype != q.dtype for x in (k, v, o, do)) \
            or lse.dtype != torch.float32:
        raise TypeError("q, k, v, o, do must share one dtype, lse fp32")
    if bwd_route(q.dtype, D, S, T, window) != "sm90":
        raise ValueError(f"no sm90 backward for {q.dtype}, D = {D}, S = {S}, "
                         f"T = {T}, window = {window}")
    if not all(x.is_contiguous() for x in (q, k, v, o, do)):
        raise ValueError("q, k, v, o, do must be contiguous")
    if lse.stride() != (_lse_width(S * G), G, 1):
        raise ValueError(f"lse strides {lse.stride()}: want the sm90 "
                         f"forward's padded rows")
    if any(x.data_ptr() % 16 for x in (q, k, v, o, do)):
        raise ValueError("q, k, v, o, do must be 16-byte aligned")
    if BK > 65535 or S * G * D >= 2 ** 31 or T * D >= 2 ** 31:
        raise ValueError(f"shape too large for the kernel: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd_sm90(
        q, k, v, o, do, lse, causal, window)
    launches_bwd_sm90 += 1
    return dq, dk, dv


def _bwd_sm90(q, k, v, o, do, lse, causal: bool, window: int):
    """The CUDA body of the ``repro_torch::flash_attention_bwd_sm90``
    operator: scratch, outputs and the launch of the two kernels."""
    BK, S, G, D = q.shape
    T = k.shape[1]
    width = lse.stride(0)
    delta = torch.zeros((BK, width), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = build_sm90()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_sm90(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), BK, S, T, G, D, int(causal),
            int(window), width, stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd_sm90 failed to launch: "
                           f"{_describe(err)}")
    return dq, dk, dv


# The sm90 backward is launched inside an operator of its own: a profiler
# links a device kernel to the innermost operator running as it was
# launched, never to a ``record_function`` range, so the kernels' time
# counts under ``ops.BACKWARD_RANGE`` only through an operator nested in it.
_OPS = torch.library.Library("repro_torch", "FRAGMENT")
_OPS.define("flash_attention_bwd_sm90(Tensor q, Tensor k, Tensor v, "
            "Tensor o, Tensor grad, Tensor lse, bool causal, int window) "
            "-> (Tensor, Tensor, Tensor)")
_OPS.impl("flash_attention_bwd_sm90", _bwd_sm90, "CUDA")


def _describe(err: int) -> str:
    """A kernel's non-zero return: a cudaError_t, or a negated CUresult
    from encoding a tensor map."""
    return f"CUDA error {err}" if err > 0 else \
        f"tensor map encoding failed (CUresult {-err})"
