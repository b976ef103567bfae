"""RWKV-6 recurrence: the CUDA kernel for Hopper, its wrapper and its plain
PyTorch version.

The kernel (``csrc/wkv6.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/wkv6.py:86`` ``wkv6_folded`` (body ``_wkv6_kernel``).
Per head, from S = 0: ``o_t = r_t·(S + u⊙k_t⊗v_t)`` and
``S = diag(w_t)·S + k_t⊗v_t``; it returns o and the final S, both fp32.
Where the TPU kernel turns a chunk of ``block_t`` tokens into matrix
products by dividing k by a cumulative decay product (which underflows
for strong decays), the CUDA kernels work in chunks of ``CHUNK`` tokens
with the decays in log2 space, every factor 2^x of a direct sum x <= 0:
one parallel pass computes each chunk's own state, an elementwise chain
carries the state across chunks, and a second parallel pass computes the
outputs sub-chunk by sub-chunk (``SUB`` tokens).
``wkv6_chunked_plain`` is that algorithm in plain PyTorch, for the tests.

What bounds it at rwkv6-3b's width (r, k, v, w (1, 4096, 40, 64)): by the
data sheet, bytes (fp32 inputs) or fp32 operations (bf16 r/k/v/u) about
equally; the chunked form does about twice the recurrence's operations
and reads k, v, w twice, for 2560 blocks of 4 warps where the
token-by-token form had 160 of 2.  Its time on an H100 beside that bound
is in ``PERF.md``.

Layouts (folded in ``ops.py``): r, k, v, w (BH, T, hs); u (BH, hs).
r, k, v, u are fp32 or bf16 (one type); w is fp32, as the model computes
it.  ``block_t`` is validated as the reference validates it (clamp to T,
then require it to divide T) and sets no tile.  ``launches`` counts
wrapper calls that launch (never plain-path calls), one per call although
each runs three kernels; callers reset it by assigning 0.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from . import ref as _ref
from .variants import _clamp_div

__all__ = ["wkv6_folded", "wkv6_plain", "wkv6_chunked_plain", "build",
           "launches", "HEAD_SIZES", "CHUNK", "SUB"]

HEAD_SIZES = (8, 16, 32, 64, 128)   # head sizes the kernel is built for
CHUNK = 64          # tokens per chunk of the state pass (the kernel's own)
SUB = 16            # tokens per sub-chunk of the output pass
LOG_W_MIN = math.log2(1e-38)  # log2 w is clamped here, as the reference
                              # clamps w at 1e-38

launches = 0

_lib = None


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load("wkv6")
    fn = lib.wkv6_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def wkv6_plain(r, k, v, w, u):
    """The same function in plain PyTorch: the sequential recurrence on the
    folded layout (``ref.wkv6_ref``); what the wrapper runs for CPU
    tensors."""
    return _ref.wkv6_ref(r, k, v, w, u)


def _sums(lw):
    """Direct sums of log-decays over a run of tokens lw (BH, n, hs), each
    accumulated token by token as the kernel does: ``fwd[t]`` = sum over
    m < t, ``rev[s]`` = sum over s < m < n (from the end back), and
    ``tot`` the sum over the run.  No sum is formed as the difference of
    two others."""
    n = lw.shape[1]
    fwd, rev = torch.empty_like(lw), torch.empty_like(lw)
    acc = torch.zeros_like(lw[:, 0])
    for t in range(n):
        fwd[:, t] = acc
        acc = acc + lw[:, t]
    acc = torch.zeros_like(lw[:, 0])
    for s in range(n - 1, -1, -1):
        rev[:, s] = acc
        acc = acc + lw[:, s]
    return fwd, rev, acc


def wkv6_chunked_plain(r, k, v, w, u):
    """The kernel's algorithm in plain PyTorch, for the tests (the main
    path never calls it): the same function as ``wkv6_plain``, computed in
    chunks with every decay factor 2^x, x a direct sum of log2-decays
    lw = max(log2 w, log2 1e-38): each sum is <= 0, so nothing divides by
    a decay product and an underflow drops only a contribution below
    1e-38.  The passes are the kernel's three:

    1. per chunk of ``CHUNK`` tokens, its own state U_c from S = 0, walked
       sub-chunk by sub-chunk of ``SUB`` tokens:
       U <- 2^(sum_sub lw) U + (k_s 2^(sum_{s<m<t1} lw))^T v_s, and
       tot_c = the sum of the sub-chunks' sums of lw;
    2. the chain S_{c+1} = 2^(tot_c) S_c + U_c from S_0 = 0;
    3. per chunk from S_c, per sub-chunk from its start state S0:
           o_t = (r_t 2^(sum_{t0<=m<t} lw)) S0
                 + sum_{s<t in the sub-chunk} (sum_i r_ti k_si
                                               2^(sum_{s<m<t} lw_i)) v_s
                 + (r_t . (u k_t)) v_t,
       the pair sums accumulated along each diagonal, then S0 advances
       over the sub-chunk as in 1.
    Ragged T: the last chunk and sub-chunk are short.  Returns
    (o (BH, T, hs), final S (BH, hs, hs)), fp32."""
    BH, T, hs = r.shape
    r, k, v = (x.float() for x in (r, k, v))
    uu = u.float()
    lw = torch.log2(w.float()).clamp(min=LOG_W_MIN)

    def advance(S, a, b):  # over one sub-chunk [a, b)
        _, rev, tot = _sums(lw[:, a:b])
        kr = k[:, a:b] * torch.exp2(rev)
        return torch.exp2(tot)[..., None] * S + \
            torch.einsum("bsi,bsj->bij", kr, v[:, a:b]), tot

    S = torch.zeros((BH, hs, hs), dtype=torch.float32, device=r.device)
    starts = []
    for c0 in range(0, T, CHUNK):
        c1 = min(c0 + CHUNK, T)
        U = torch.zeros_like(S)
        tot = torch.zeros((BH, hs), dtype=torch.float32, device=r.device)
        for t0 in range(c0, c1, SUB):
            U, t = advance(U, t0, min(t0 + SUB, c1))
            tot = tot + t
        starts.append(S)
        S = torch.exp2(tot)[..., None] * S + U
    o = torch.empty((BH, T, hs), dtype=torch.float32, device=r.device)
    for c0, S0 in zip(range(0, T, CHUNK), starts):
        c1 = min(c0 + CHUNK, T)
        for t0 in range(c0, c1, SUB):
            t1 = min(t0 + SUB, c1)
            n = t1 - t0
            rs, ks, vs, ls = (x[:, t0:t1] for x in (r, k, v, lw))
            fwd, _, _ = _sums(ls)
            out = torch.einsum("bti,bij->btj", rs * torch.exp2(fwd), S0)
            # pair (t, t - d): d = 0 is the bonus u; d >= 1 decays by
            # lw over t - d < m < t, summed from m = t - 1 down
            score = torch.zeros((BH, n, n), dtype=torch.float32,
                                device=r.device)
            idx = torch.arange(n, device=r.device)
            score[:, idx, idx] = (rs * uu[:, None] * ks).sum(-1)
            acc = torch.zeros_like(rs)
            for d in range(1, n):
                t = idx[d:]
                score[:, t, t - d] = (rs[:, d:] * ks[:, :n - d]
                                      * torch.exp2(acc[:, d:])).sum(-1)
                acc[:, d:] = acc[:, d:] + ls[:, :n - d]
            o[:, t0:t1] = out + torch.einsum("bts,bsj->btj", score, vs)
            S0, _ = advance(S0, t0, t1)
    return o, S


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
    # the kernels read 16-byte pieces: a view that starts off that
    # alignment is copied into a fresh (aligned) allocation
    r, k, v, w = (x.clone() if x.data_ptr() % 16 else x
                  for x in (r, k, v, w))
    o = torch.empty((BH, T, hs), dtype=torch.float32, device=r.device)
    s = torch.empty((BH, hs, hs), dtype=torch.float32, device=r.device)
    # scratch: each chunk's own state, then the state at its start, and
    # each chunk's sum of log2 w per row
    n_chunks = -(-T // CHUNK)
    states = torch.empty((BH, n_chunks, hs, hs), dtype=torch.float32,
                         device=r.device)
    totals = torch.empty((BH, n_chunks, hs), dtype=torch.float32,
                         device=r.device)
    lib = build()
    with torch.cuda.device(r.device):
        err = lib.wkv6_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), o.data_ptr(), s.data_ptr(), states.data_ptr(),
            totals.data_ptr(), BH, T, hs,
            int(r.dtype == torch.bfloat16),
            torch.cuda.current_stream(r.device).cuda_stream)
    if err:
        raise RuntimeError(f"wkv6_fwd failed to launch: CUDA error {err}")
    launches += 1
    return o, s
