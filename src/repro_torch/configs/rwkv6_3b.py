"""RWKV-6 (Finch) 3B — attention-free, data-dependent decay
[arXiv:2404.05892].

Sub-quadratic: state is O(1) in sequence length; long_500k runs.
heads = d_model / head_size = 40.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=0, n_kv_heads=0, d_head=0,
    d_ff=8960, vocab=65536,
    activation="sq_relu",
    layer_pattern="rwkv", rwkv_head_size=64,
    sub_quadratic=True,
    source="arXiv:2404.05892",
))
