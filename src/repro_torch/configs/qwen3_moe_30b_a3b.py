"""Qwen3-30B-A3B — MoE 128 experts top-8, GQA kv=4, qk-norm
[hf:Qwen/Qwen3-30B-A3B]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_head=128,
    d_ff=768, vocab=151936,
    activation="swiglu", qk_norm=True,
    n_experts=128, top_k=8,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-30B-A3B",
))
