"""The plain reference: straightforward PyTorch in float32 with TF32 off,
written from the model's equations, that imports nothing of the program.

``dense`` is the GQA decoder (internlm2), ``rwkv6`` RWKV-6's time and
channel mixes, ``adamw`` the optimizer, ``layout`` the parameter shapes
both sides are handed and their seeded values.  Every matrix product goes
through ``Mat``: ``Mat("fp32")`` computes in float32, ``Mat("fp8")``
rounds both operands to float8 e4m3 first (the control: the precision
below bfloat16).
"""
import torch

from .adamw import AdamW
from .dense import Dense
from .layout import layout, make_params
from .rwkv6 import RWKV6

__all__ = ["Dense", "RWKV6", "AdamW", "Mat", "layout", "make_params",
           "model_for", "full_fp32"]


def _round(t, dtype, top: float):
    """``t`` rounded to the float8 ``dtype`` with one scale per tensor
    (its largest magnitude maps to the type's largest, ``top``)."""
    s = t.abs().amax().clamp(min=1e-30) / top
    return (t / s).to(dtype).to(t.dtype) * s


class _Fp8(torch.autograd.Function):
    """An operand of a product rounded to e4m3, its gradient passed
    through as it comes."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Grad(torch.autograd.Function):
    """The identity, whose gradient is rounded to e5m2: the gradient that
    reaches a product's backward is in fp8 too, as fp8 training does."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


class Mat:
    """Matrix products of the reference in one precision: ``fp32``, or
    ``fp8`` (operands in e4m3, the gradients of their outputs in e5m2,
    each product accumulated in fp32)."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def __call__(self, eq: str, *ops):
        if self.precision == "fp32":
            return torch.einsum(eq, *ops)
        return _Fp8Grad.apply(torch.einsum(eq, *(_Fp8.apply(o)
                                                 for o in ops)))


def model_for(cfg: dict, precision: str = "fp32"):
    """The reference model of a configuration file's ``family``."""
    mat = Mat(precision)
    if cfg["family"] == "dense":
        return Dense(cfg, mat)
    if cfg["family"] == "rwkv6":
        return RWKV6(cfg, mat)
    raise ValueError(f"no reference for family {cfg['family']!r}")


class full_fp32:
    """TF32 off for cuBLAS and cuDNN inside, the flags back after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
        return False
