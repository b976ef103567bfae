"""RG-LRU diagonal linear recurrence ``h_t = a_t ⊙ h_{t-1} + b_t``: the
CUDA kernel for Hopper, its wrapper and its plain PyTorch version.

The kernel (``csrc/rglru_scan.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/rglru_scan.py:56`` ``rglru_scan`` (bodies
``_rglru_kernel``, ``_scan_block``).  Where the TPU kernel scans chunks of
``block_t`` tokens by doubling and carries a row across a sequential grid,
the CUDA kernel makes T a parallel axis in one pass: persistent blocks
take tiles of ``CHUNK`` tokens × ``DTILE`` channels in order, stage their
rows of a and b in shared memory, publish each chunk's own product and
scan from h = 0 (its aggregate) as soon as the rows land, find the carry
into the chunk by a decoupled look-back over the predecessors' published
values, and rescan the chunk from that carry.  ``rglru_scan_chunked_plain``
is that algorithm in plain PyTorch, for the tests.  Each step is rounded
as the plain version rounds it, so the two differ only through the carry.

What bounds it at recurrentgemma-2b's width (a, b (1, 4096, 2560) fp32):
bytes, by the data sheet (12 bytes per element, two operations); the
kernel moves each of them once.  Its time on an H100 beside that bound is
in ``PERF.md``.

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

__all__ = ["rglru_scan", "rglru_scan_plain", "rglru_scan_chunked_plain",
           "build", "launches", "CHUNK", "DTILE"]

# the kernel's tile, Tc tokens x Dc channels (kTc, kDc in the source)
CHUNK, DTILE = 32, 256

launches = 0

_lib = None


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load("rglru_scan")
    fn = lib.rglru_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def rglru_scan_plain(a, b):
    """The same function in plain PyTorch: the sequential scan
    (``ref.rglru_scan_ref``); what the wrapper runs for CPU tensors."""
    return _ref.rglru_scan_ref(a, b)


def _step(a, h, b):
    return a * h + b  # two roundings, as the kernel's __fmul_rn, __fadd_rn


def rglru_scan_chunked_plain(a, b, chunk: int = CHUNK, lookback=None):
    """The kernel's algorithm in plain PyTorch, for the tests (the main
    path never calls it): the same function as ``rglru_scan_plain``,
    computed in chunks of ``chunk`` tokens by the kernel's passes:

    1. per chunk c its aggregate: A_c = prod a_t and B_c = the scan from
       h = 0 at the chunk's end;
    2. the carry into chunk c (0 for chunk 0): fold the aggregates of the
       ``lookback`` nearest predecessors (all of them if None),
       acc_B += acc_A B_p, acc_A *= A_p from p = c - 1 down, then
       carry = acc_B + acc_A I_p with I_p the inclusive value of the next
       one; each chunk's inclusive value is I_c = B_c + A_c carry_c.  The
       kernel's depth depends on timing; every depth gives one function;
    3. the rescan of each chunk from its carry.
    Ragged T: the last chunk is short.  Returns h (B, T, D) fp32."""
    a32, b32 = a.float(), b.float()
    T = a32.shape[1]
    starts = list(range(0, T, chunk))
    agg = []
    for t0 in starts:
        A = torch.ones_like(a32[:, 0])
        Bc = torch.zeros_like(a32[:, 0])
        for t in range(t0, min(t0 + chunk, T)):
            Bc = _step(a32[:, t], Bc, b32[:, t])
            A = A * a32[:, t]
        agg.append((A, Bc))
    carries, inclusive = [], []
    for c, (A, Bc) in enumerate(agg):
        carry = torch.zeros_like(Bc)
        if c:
            depth = c - 1 if lookback is None else min(lookback, c - 1)
            acc_a, acc_b = torch.ones_like(A), torch.zeros_like(Bc)
            for p in range(c - 1, c - 1 - depth, -1):
                acc_b = _step(acc_a, agg[p][1], acc_b)
                acc_a = acc_a * agg[p][0]
            carry = _step(acc_a, inclusive[c - 1 - depth], acc_b)
        carries.append(carry)
        inclusive.append(_step(A, carry, Bc) if c else Bc)
    h = torch.empty_like(a32)
    for t0, carry in zip(starts, carries):
        for t in range(t0, min(t0 + chunk, T)):
            carry = _step(a32[:, t], carry, b32[:, t])
            h[:, t] = carry
    return h


def rglru_scan(a, b, *, block_t: int = 256):
    """a, b: (B, T, D) → inclusive scan h (B, T, D) fp32.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.  The kernel's scratch is allocated per call and reset on the
    current stream: every word to its "unpublished" pattern (all bits
    set), the ticket after it to -1."""
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
    n_chunks = -(-T // CHUNK)
    if B * n_chunks * -(-D // DTILE) > (2 ** 31 - 1) // 2:
        raise ValueError(f"{(B, T, D)} has too many tiles for the kernel's "
                         f"int32 tickets")
    a = a.float().contiguous()
    b = b.float().contiguous()
    h = torch.empty_like(a)
    # each chunk's A, B and inclusive value I, for D rounded up to 4
    # channels, then the ticket
    scratch = torch.full((3 * B * n_chunks * (-(-D // 4) * 4) + 1,), -1,
                         dtype=torch.int32, device=a.device)
    lib = build()
    with torch.cuda.device(a.device):
        err = lib.rglru_scan_fwd(
            a.data_ptr(), b.data_ptr(), h.data_ptr(), scratch.data_ptr(),
            B, T, D, torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"rglru_scan_fwd failed to launch: CUDA error "
                           f"{err}")
    launches += 1
    return h
