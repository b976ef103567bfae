"""AdamW's update of one leaf and the clip norm's square sum: the CUDA
kernels for Hopper, their wrappers and their plain PyTorch versions.

The kernels (``csrc/adamw.cu``) replace no TPU kernel: the reference's
``src/repro/optim/adamw.py`` is plain jnp, which XLA fuses.  They replace
the port's own slice loop (``adamw_leaf_plain``: ~17 PyTorch elementwise
kernels a slice of ``chunk`` elements, each through 256 MB fp32
temporaries, ~150 bytes moved a bf16 parameter) and slice sum
(``square_sum_plain``: a cast, a square and a sum a slice) with one pass
each over a whole leaf.

What bounds them: bytes.  ``adamw_leaf`` reads g, p and fp32 m, v and
writes m, v, p, 22 bytes a bf16 parameter; ``square_sum`` reads g once, 2
bytes.  The kernels read and write each byte once, in 16-byte vectors
with streaming hints, and keep no temporary in device memory; their times
on an H100 beside that bound are in ``PERF.md``.

``adamw_leaf`` computes the plain loop's formula term for term with each
operation rounded as PyTorch rounds it, so its m, v and p are bitwise the
plain loop's on the card; ``square_sum`` accumulates in fp64 in a fixed
order, so it repeats bit for bit and may differ from the plain sum in the
last bits of fp32.  ``optim/adamw.py`` calls both.  Tensors off a card
(the CPU, and the dry-run's ``meta`` tensors, whose traced ops it counts)
take the plain versions (``chunk`` is their slice length; a kernel takes
the whole range in one launch); CUDA tensors launch the kernel or raise.
``launches_leaf`` and ``launches_square_sum`` count kernel launches (never
plain-path calls); callers reset them by assigning 0.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["adamw_leaf", "adamw_leaf_plain", "square_sum",
           "square_sum_plain", "build", "launches_leaf",
           "launches_square_sum"]

launches_leaf = 0
launches_square_sum = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# resident blocks an SM at most: 2048 threads over the kernels' 256
_BLOCKS_PER_SM = 8

_lib = None


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load("adamw")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.adamw_leaf.argtypes = [p] * 4 + [ctypes.c_longlong, i] + [p] * 3 \
        + [f] * 7 + [p]
    lib.square_sum.argtypes = [p, ctypes.c_longlong, i, p, i, p, p]
    for fn in (lib.adamw_leaf, lib.square_sum):
        fn.restype = i
    _lib = lib
    return lib


def _slices(n: int, chunk: int):
    for lo in range(0, n, chunk):
        yield lo, min(lo + chunk, n)


def adamw_leaf_plain(g, m, v, p, scale, bc1, bc2, *, b1, b2, eps, lr,
                     weight_decay, chunk):
    """The update of one flat leaf in slices of ``chunk`` elements, in
    place: fp32 ``m``/``v``, the param ``p`` and its gradient ``g`` of one
    type, ``scale``/``bc1``/``bc2`` 0-d fp32 tensors (the clip scale and
    the bias corrections)."""
    for lo, hi in _slices(p.numel(), chunk):
        ms, vs, pc = m[lo:hi], v[lo:hi], p[lo:hi]
        gs = g[lo:hi].to(torch.float32) * scale
        t = gs * (1 - b1)
        ms.mul_(b1).add_(t)                      # b1 m + (1 - b1) g
        torch.square(gs, out=t)
        vs.mul_(b2).add_(t.mul_(1 - b2))         # b2 v + (1 - b2) g²
        torch.div(vs, bc2, out=t)
        t.sqrt_().add_(eps)                      # sqrt(v̂) + eps
        torch.div(ms, bc1, out=gs)
        gs.div_(t)                               # m̂ / (sqrt(v̂) + eps)
        if weight_decay:
            torch.mul(pc.to(torch.float32), weight_decay, out=t)
            gs.add_(t)
        torch.sub(pc, gs.mul_(lr), out=t)        # p - lr · delta, fp32
        pc.copy_(t)


def adamw_leaf(g, m, v, p, scale, bc1, bc2, *, b1, b2, eps, lr,
               weight_decay, chunk):
    """One leaf's AdamW update in place (see ``adamw_leaf_plain``).  CUDA
    tensors launch the kernel once (``chunk`` unused) or raise; any other
    device takes the plain version."""
    global launches_leaf
    if p.device.type != "cuda":
        return adamw_leaf_plain(g, m, v, p, scale, bc1, bc2, b1=b1, b2=b2,
                                eps=eps, lr=lr, weight_decay=weight_decay,
                                chunk=chunk)
    _check(p, (g, m, v), (scale, bc1, bc2))
    if g.dtype != p.dtype or m.dtype != torch.float32 \
            or v.dtype != torch.float32:
        raise TypeError(f"the kernel takes g and p of one type and fp32 m, "
                        f"v; got g {g.dtype}, p {p.dtype}, m {m.dtype}, v "
                        f"{v.dtype}")
    if p.numel() == 0:
        return
    torch.ops.repro_torch.adamw_leaf(g, m, v, p, scale, bc1, bc2, float(b1),
                                     float(b2), float(eps), float(lr),
                                     float(weight_decay))
    launches_leaf += 1


def _adamw_leaf_cuda(g, m, v, p, scale, bc1, bc2, b1, b2, eps, lr,
                     weight_decay):
    """The CUDA body of the ``repro_torch::adamw_leaf`` operator.  The
    constants go to the kernel as fp32, each Python double rounded once
    (as PyTorch rounds a scalar operand of an fp32 tensor)."""
    lib = build()
    with torch.cuda.device(p.device):
        err = lib.adamw_leaf(
            g.data_ptr(), m.data_ptr(), v.data_ptr(), p.data_ptr(),
            p.numel(), _DTYPES[p.dtype], scale.data_ptr(), bc1.data_ptr(),
            bc2.data_ptr(), b1, 1 - b1, b2, 1 - b2, eps, lr, weight_decay,
            torch.cuda.current_stream(p.device).cuda_stream)
    if err:
        raise RuntimeError(f"adamw_leaf failed to launch: CUDA error {err}")


def square_sum_plain(g, *, chunk):
    """Σ g² of a flat tensor in fp32 (a 0-d tensor), slice by slice."""
    total = torch.zeros((), dtype=torch.float32, device=g.device)
    for lo, hi in _slices(g.numel(), chunk):
        total = total + torch.square(g[lo:hi].to(torch.float32)).sum()
    return total


def square_sum(g, *, chunk):
    """Σ g² of a flat tensor in fp32, a 0-d tensor on g's device.  CUDA
    tensors launch the kernel once (``chunk`` unused) or raise; any other
    device takes the plain version."""
    global launches_square_sum
    if g.device.type != "cuda":
        return square_sum_plain(g, chunk=chunk)
    _check(g, (), ())
    if g.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=g.device)
    out = torch.ops.repro_torch.square_sum(g)
    launches_square_sum += 1
    return out


def _square_sum_cuda(g):
    """The CUDA body of the ``repro_torch::square_sum`` operator: the
    partials (one a resident block, ``_BLOCKS_PER_SM`` an SM at most), the
    output and the launch of the two kernels."""
    lib = build()
    sms = torch.cuda.get_device_properties(g.device).multi_processor_count
    partials = torch.empty(sms * _BLOCKS_PER_SM, dtype=torch.float64,
                           device=g.device)
    out = torch.empty((), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        err = lib.square_sum(g.data_ptr(), g.numel(), _DTYPES[g.dtype],
                             partials.data_ptr(), partials.numel(),
                             out.data_ptr(),
                             torch.cuda.current_stream(g.device).cuda_stream)
    if err:
        raise RuntimeError(f"square_sum failed to launch: CUDA error {err}")
    return out


def _check(x, same, scalars) -> None:
    """Raise unless ``x`` (a CUDA tensor) is contiguous and of a type the
    kernels take, each of ``same`` a contiguous tensor of its length and
    each of ``scalars`` one fp32 element, all on ``x``'s device."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"the kernels take fp32, bf16 or fp16; got {x.dtype}")
    for t in (x, *same, *scalars):
        if t.device != x.device:
            raise ValueError(f"tensors on {t.device} and {x.device}: the "
                             "kernels want one device")
        if not t.is_contiguous():
            raise ValueError("the kernels take contiguous tensors")
    for t in same:
        if t.numel() != x.numel():
            raise ValueError(f"lengths {t.numel()} and {x.numel()} differ")
    for t in scalars:
        if t.numel() != 1 or t.dtype != torch.float32:
            raise TypeError(f"want an fp32 scalar; got {t.dtype} of "
                            f"{t.numel()} elements")


# Each kernel is launched inside an operator of its own: a profiler links a
# device kernel to the innermost operator running as it was launched, never
# to a ``record_function`` range, so the kernels' time counts under the
# optimizer's range (``trace.UPDATE_RANGE``) only through an operator.
_OPS = torch.library.Library("repro_torch", "FRAGMENT")
_OPS.define("adamw_leaf(Tensor g, Tensor(a!) m, Tensor(b!) v, Tensor(c!) p, "
            "Tensor scale, Tensor bc1, Tensor bc2, float b1, float b2, "
            "float eps, float lr, float weight_decay) -> ()")
_OPS.impl("adamw_leaf", _adamw_leaf_cuda, "CUDA")
_OPS.define("square_sum(Tensor g) -> Tensor")
_OPS.impl("square_sum", _square_sum_cuda, "CUDA")
