"""Carry params across from the reference: nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)`` of a reference model) become the
port's nested dicts of tensors, with the same keys and stacked layouts."""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["params_from_numpy"]


def _tensor(arr, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 is not a type torch.from_numpy takes; every
        # bf16 value is exact in fp32, so the round trip is lossless
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree: Dict[str, Any], device,
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Convert every leaf to a tensor on ``device`` (cast to ``dtype`` if
    given, else in the array's own type)."""
    return {k: params_from_numpy(v, device, dtype) if isinstance(v, dict)
            else _tensor(v, device, dtype) for k, v in tree.items()}
