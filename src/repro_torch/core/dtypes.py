"""One mapping between numpy and torch dtypes, both ways.

The planner, the verifier and the emitted text speak numpy dtypes (byte
sizes come from ``np.dtype(...).itemsize``); device handles are torch
tensors.  Every boundary where a dtype crosses between the two goes
through these two functions.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["numpy_dtype", "torch_dtype"]

_PAIRS = (
    (np.float64, torch.float64), (np.float32, torch.float32),
    (np.float16, torch.float16), (np.int64, torch.int64),
    (np.int32, torch.int32), (np.int16, torch.int16), (np.int8, torch.int8),
    (np.uint8, torch.uint8), (np.bool_, torch.bool),
    (np.complex64, torch.complex64), (np.complex128, torch.complex128),
)
_TO_TORCH = {np.dtype(n): t for n, t in _PAIRS}
_TO_NUMPY = {t: np.dtype(n) for n, t in _PAIRS}


def numpy_dtype(dtype) -> np.dtype:
    """``dtype`` (torch or numpy-like) as a numpy dtype; raises for torch
    dtypes numpy has no counterpart of (bfloat16)."""
    if isinstance(dtype, torch.dtype):
        try:
            return _TO_NUMPY[dtype]
        except KeyError:
            raise TypeError(f"{dtype} has no numpy counterpart") from None
    return np.dtype(dtype)


def torch_dtype(dtype) -> torch.dtype:
    """``dtype`` (numpy-like or torch) as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _TO_TORCH[np.dtype(dtype)]
    except KeyError:
        raise TypeError(f"{np.dtype(dtype)} has no torch counterpart") \
            from None
