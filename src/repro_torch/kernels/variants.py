"""Enumerable tile/block variant grids for the kernels.

Each kernel exposes a small grid of lane-aligned tile sizes plus the three
hooks the kernel axis of the plan-space tuner needs:

  * ``validate(shapes, params)`` — mirror the kernel's own clamping
    (``block = min(block, axis)``) and divisibility asserts, returning the
    *canonical* (clamped) parameter dict or ``None`` when the tile shape is
    invalid for these operand shapes.  Canonicalisation is what lets
    dominance pruning merge declared variants that collapse onto the same
    launched tile (e.g. ``block_q=256`` on a 128-token sequence).
  * ``roofline(shapes, itemsizes, params)`` — analytic (flops, HBM bytes)
    for one full sweep of the kernel grid, the per-kernel cutout consumed by
    ``roofline.analysis.kernel_roofline_terms``.  Bytes follow the tile
    revisit structure (e.g. flash attention re-reads K/V once per q tile),
    so ``kernel_s`` genuinely differs across variants.
  * the operand-shape convention: a kernel-tagged block's declared reads
    are, in order, the kernel's array operands at the *ops layer* layout
    (``flash_attention``: q (B,S,K,G,D), k, v (B,T,K,D); ``wkv6``: r, k, v,
    w (B,T,H,hs), u (H,hs); ``rglru_scan``: a, b (B,T,D); ``rmsnorm``:
    x (..., D), w (D,)).

This module is imported by the verifier and the executor and stays
stdlib-only.  The grids are the reference registry's unchanged: the CUDA
flash-attention kernel launches every tile it admits (its own tiling does
not depend on ``block_q``/``block_k``), so no tile is refused here.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["KernelVariant", "KERNELS", "kernel_names", "variants_for",
           "default_variant", "validate_variant", "kernel_roofline",
           "kernel_workset", "bind_variant"]

Params = Dict[str, int]
ParamsKey = Tuple[Tuple[str, int], ...]


def _key(params: Params) -> ParamsKey:
    return tuple(sorted(params.items()))


@dataclasses.dataclass(frozen=True)
class KernelVariant:
    """One point of a kernel's tile grid: ``params`` is the canonical
    sorted ``((name, value), ...)`` tuple — hashable, JSON-friendly, and
    the unit dominance pruning keys on."""
    kernel: str
    params: ParamsKey

    @property
    def label(self) -> str:
        inner = ",".join(f"{k}={v}" for k, v in self.params)
        return f"{self.kernel}[{inner}]"

    def kwargs(self) -> Params:
        return dict(self.params)


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def _clamp_div(block: int, axis: int) -> Optional[int]:
    """The kernels' shared tile rule: clamp to the axis, then require the
    axis to divide evenly."""
    block = min(int(block), int(axis))
    if block <= 0 or axis % block:
        return None
    return block


# --- flash_attention: q (B, S, K, G, D); k, v (B, T, K, D) ----------------

def _flash_validate(shapes, params) -> Optional[Params]:
    (B, S, K, G, D) = shapes[0]
    T = shapes[1][1]
    bq = _clamp_div(params["block_q"], S)
    bk = _clamp_div(params["block_k"], T)
    if bq is None or bk is None:
        return None
    return {"block_q": bq, "block_k": bk}


def _flash_workset(shapes, itemsizes, params):
    (B, S, K, G, D) = shapes[0]
    eb = itemsizes[0]
    bq, bk = params["block_q"], params["block_k"]
    # one program instance's VMEM tiles: q + fp32 o/accumulators, the
    # current k/v tile pair, and the fp32 score tile
    return float(bq * G * D * (eb + 4) + 2 * bk * D * eb + bq * G * bk * 4)


def _flash_roofline(shapes, itemsizes, params):
    (B, S, K, G, D) = shapes[0]
    T = shapes[1][1]
    eb_q, eb_k, eb_v = itemsizes[:3]
    # two MXU dots per (q, k) tile pair: s = q·kᵀ and p·v, 2·bq·G·bk·D each
    flops = 4.0 * B * K * S * G * T * D
    n_q = S // params["block_q"]
    # q + o stream once; every q tile re-sweeps the whole K/V sequence
    q_bytes = B * K * S * G * D
    kv_bytes = B * K * T * D
    bytes_ = (q_bytes * (eb_q + eb_q)
              + n_q * kv_bytes * (eb_k + eb_v))
    return flops, float(bytes_)


# --- wkv6: r, k, v, w (B, T, H, hs); u (H, hs) ----------------------------

def _wkv6_validate(shapes, params) -> Optional[Params]:
    T = shapes[0][1]
    bt = _clamp_div(params["block_t"], T)
    if bt is None:
        return None
    return {"block_t": bt}


def _wkv6_workset(shapes, itemsizes, params):
    (B, T, H, hs) = shapes[0]
    eb = itemsizes[0]
    L = params["block_t"]
    # r/k/v/w chunk tiles + u + fp32 running state + fp32 score tile + o
    return float(4 * L * hs * eb + hs * eb + hs * hs * 4
                 + L * L * 4 + L * hs * 4)


def _wkv6_roofline(shapes, itemsizes, params):
    (B, T, H, hs) = shapes[0]
    L = params["block_t"]
    n_t = T // L
    # four MXU dots per chunk: inter (L·hs²), scores (L²·hs), intra (L²·hs),
    # state update (L·hs²) — ×2 flops each, summed over B·H·n_t chunks
    flops = 2.0 * B * H * (2 * T * hs * hs + 2 * T * L * hs)
    eb = itemsizes[0]
    io = B * T * H * hs
    bytes_ = (4 * io * eb            # r, k, v, w read once
              + io * 4               # o written fp32
              + B * H * hs * hs * 4  # final state out fp32
              + n_t * B * H * hs * eb)   # u re-read per chunk
    return flops, float(bytes_)


# --- rglru_scan: a, b (B, T, D) -------------------------------------------

def _rglru_validate(shapes, params) -> Optional[Params]:
    T = shapes[0][1]
    bt = _clamp_div(params["block_t"], T)
    if bt is None:
        return None
    return {"block_t": bt}


def _rglru_workset(shapes, itemsizes, params):
    (B, T, D) = shapes[0]
    L = params["block_t"]
    # a/b chunk tiles in, h chunk out + fp32 carry row, all fp32
    return float(3 * L * D * 4 + D * 4)


def _rglru_roofline(shapes, itemsizes, params):
    (B, T, D) = shapes[0]
    L = params["block_t"]
    # Hillis-Steele doubling: ceil(log2 L) steps × 3 VPU flops per element
    steps = max(1, math.ceil(math.log2(L))) if L > 1 else 1
    flops = 3.0 * B * T * D * steps
    bytes_ = 3 * B * T * D * 4       # a, b in + h out, all fp32
    return flops, float(bytes_)


# --- rmsnorm: x (..., D); w (D,) ------------------------------------------

def _rmsnorm_canon_rows(block_rows: int, n: int) -> int:
    # mirror ops.rmsnorm: clamp, then halve until the row count divides
    br = min(int(block_rows), int(n))
    while br > 1 and n % br:
        br //= 2
    return max(br, 1)


def _rmsnorm_validate(shapes, params) -> Optional[Params]:
    x = shapes[0]
    n = _prod(x[:-1])
    return {"block_rows": _rmsnorm_canon_rows(params["block_rows"], n)}


def _rmsnorm_workset(shapes, itemsizes, params):
    x = shapes[0]
    D = x[-1]
    eb = itemsizes[0]
    br = params["block_rows"]
    # the row tile in/out + the gain vector
    return float(2 * br * D * eb + D * eb)


def _rmsnorm_roofline(shapes, itemsizes, params):
    x = shapes[0]
    D = x[-1]
    n = _prod(x[:-1])
    flops = 3.0 * n * D              # square-reduce, rsqrt-scale, gain
    eb = itemsizes[0]
    n_blocks = n // params["block_rows"]
    bytes_ = (2 * n * D * eb         # x in, o out
              + n_blocks * D * eb)   # w re-read per row tile
    return flops, float(bytes_)


KERNELS: Dict[str, dict] = {
    "flash_attention": {
        "grid": {"block_q": (64, 128, 256), "block_k": (64, 128, 256)},
        "defaults": {"block_q": 128, "block_k": 128},
        "validate": _flash_validate,
        "roofline": _flash_roofline,
        "workset": _flash_workset,
    },
    "wkv6": {
        # 128 is deliberately absent: the chunk form divides k by the
        # in-chunk decay cumprod, which overflows fp32 once the chunk is
        # long enough for strong decays (w ~ 0.2 over 128 steps)
        "grid": {"block_t": (16, 32, 64)},
        "defaults": {"block_t": 64},
        "validate": _wkv6_validate,
        "roofline": _wkv6_roofline,
        "workset": _wkv6_workset,
    },
    "rglru_scan": {
        "grid": {"block_t": (64, 128, 256)},
        "defaults": {"block_t": 256},
        "validate": _rglru_validate,
        "roofline": _rglru_roofline,
        "workset": _rglru_workset,
    },
    "rmsnorm": {
        "grid": {"block_rows": (64, 128, 256, 512)},
        "defaults": {"block_rows": 256},
        "validate": _rmsnorm_validate,
        "roofline": _rmsnorm_roofline,
        "workset": _rmsnorm_workset,
    },
}


def kernel_names() -> Tuple[str, ...]:
    return tuple(KERNELS)


def validate_variant(kernel: str, shapes: Sequence[tuple],
                     params: Params) -> Optional[KernelVariant]:
    """Canonical variant for ``params`` on these operand shapes, or ``None``
    when the tile shape is invalid (non-dividing after clamping)."""
    canon = KERNELS[kernel]["validate"](tuple(map(tuple, shapes)), params)
    if canon is None:
        return None
    return KernelVariant(kernel, _key(canon))


def variants_for(kernel: str, shapes: Sequence[tuple],
                 itemsizes: Sequence[int] = ()) -> Tuple[KernelVariant, ...]:
    """All *distinct* valid variants of ``kernel`` for these operand
    shapes: the declared grid, shape-validity filtered, canonicalised and
    deduped (clamping can fold several declared tiles onto one launch)."""
    spec = KERNELS[kernel]
    names = tuple(spec["grid"])
    seen, out = set(), []
    for combo in itertools.product(*(spec["grid"][n] for n in names)):
        v = validate_variant(kernel, shapes, dict(zip(names, combo)))
        if v is not None and v.params not in seen:
            seen.add(v.params)
            out.append(v)
    return tuple(out)


def default_variant(kernel: str) -> KernelVariant:
    return KernelVariant(kernel, _key(KERNELS[kernel]["defaults"]))


def kernel_roofline(kernel: str, params: Params, shapes: Sequence[tuple],
                    itemsizes: Sequence[int] = ()) -> Tuple[float, float]:
    """(flops, HBM bytes) for one grid sweep of ``kernel`` launched with
    ``params`` on these operand shapes."""
    shapes = tuple(map(tuple, shapes))
    if not itemsizes:
        itemsizes = (4,) * len(shapes)
    canon = KERNELS[kernel]["validate"](shapes, dict(params))
    if canon is None:
        raise ValueError(
            f"invalid {kernel} tile {dict(params)} for shapes {shapes}")
    return KERNELS[kernel]["roofline"](shapes, tuple(itemsizes), canon)


def kernel_workset(kernel: str, params: Params, shapes: Sequence[tuple],
                   itemsizes: Sequence[int] = ()) -> float:
    """On-chip working-set bytes of one program instance of ``kernel``
    launched with ``params`` — the tile buffers a single grid step holds
    live (ISSUE 10: the kernel-variant term of the plan peak-memory
    walk, ``repro_torch.core.residency.plan_peak_device_bytes``).  Larger
    tiles buy roofline time at the price of residency, which is exactly
    the time × memory trade-off the Pareto tuner surfaces."""
    shapes = tuple(map(tuple, shapes))
    if not itemsizes:
        itemsizes = (4,) * len(shapes)
    canon = KERNELS[kernel]["validate"](shapes, dict(params))
    if canon is None:
        raise ValueError(
            f"invalid {kernel} tile {dict(params)} for shapes {shapes}")
    return KERNELS[kernel]["workset"](shapes, tuple(itemsizes), canon)


@functools.lru_cache(maxsize=None)
def bind_variant(fn, params: ParamsKey):
    """A *memoized* partial binding of a kernel block fn to its variant
    kwargs.  Memoization keeps the bound callable's identity stable across
    calls so backend jit caches (keyed on fn identity) still hit."""
    return functools.partial(fn, **dict(params))
