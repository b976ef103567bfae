"""Config registry: the architectures this port runs so far (+ polybench)."""
from . import qwen2_5_14b, recurrentgemma_2b, rwkv6_3b
from .base import (SHAPES, ArchConfig, ShapeSpec, active_param_count,
                   get_config, list_archs, param_count, reduced, register)
from .polybench import POLYBENCH_PROBLEMS

ALL_ARCHS = (qwen2_5_14b.CONFIG, recurrentgemma_2b.CONFIG, rwkv6_3b.CONFIG)

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "get_config", "list_archs",
           "param_count", "active_param_count", "reduced", "register",
           "ALL_ARCHS", "POLYBENCH_PROBLEMS"]
