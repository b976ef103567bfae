"""Config registry: one module per assigned architecture (+ polybench)."""
from . import (arctic_480b, chameleon_34b, command_r_35b, internlm2_20b,
               musicgen_large, nemotron4_15b, qwen2_5_14b, qwen3_moe_30b_a3b,
               recurrentgemma_2b, rwkv6_3b)
from .base import (SHAPES, ArchConfig, ShapeSpec, active_param_count,
                   get_config, list_archs, param_count, reduced, register)
from .polybench import POLYBENCH_PROBLEMS

ALL_ARCHS = (
    qwen2_5_14b.CONFIG, internlm2_20b.CONFIG, command_r_35b.CONFIG,
    nemotron4_15b.CONFIG, qwen3_moe_30b_a3b.CONFIG, arctic_480b.CONFIG,
    recurrentgemma_2b.CONFIG, musicgen_large.CONFIG, chameleon_34b.CONFIG,
    rwkv6_3b.CONFIG,
)

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "get_config", "list_archs",
           "param_count", "active_param_count", "reduced", "register",
           "ALL_ARCHS", "POLYBENCH_PROBLEMS"]
