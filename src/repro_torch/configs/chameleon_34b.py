"""Chameleon-34B — early-fusion VLM over a unified token vocabulary
[arXiv:2405.09818].

The VQ image tokenizer is a STUB: inputs are a single (B, S) stream of ids
over the joint 65536 vocab (text + image tokens).  QK-norm enabled (the
paper's training-stability fix).
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=22016, vocab=65536,
    activation="swiglu", qk_norm=True,
    source="arXiv:2405.09818",
))
