"""Command-R 35B — dense GQA, no bias [hf:CohereForAI/c4ai-command-r-v01].

Assumption (noted in DESIGN.md): the real model uses a parallel
attention+FFN block; we model the standard sequential residual form.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=22528, vocab=256000,
    activation="swiglu", qkv_bias=False,
    rope_theta=8_000_000.0,
    source="hf:CohereForAI/c4ai-command-r-v01",
))
