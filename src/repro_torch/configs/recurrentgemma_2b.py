"""RecurrentGemma-2B (Griffin) — RG-LRU + local attention, 1:2
[arXiv:2402.19427].

Pattern (R, R, A): layers 2, 5, 8, ... are local-attention (window 2048,
MQA kv=1), the rest are RG-LRU recurrent blocks.  Sub-quadratic: long_500k
runs (recurrent state + fixed window KV).
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_head=256,
    d_ff=7680, vocab=256000,
    activation="geglu",
    layer_pattern="griffin", local_window=2048, rglru_conv_width=4,
    sub_quadratic=True,
    source="arXiv:2402.19427",
))
