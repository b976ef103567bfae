"""Nemotron-4 15B — dense GQA with squared-ReLU FFN [arXiv:2402.16819]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=24576, vocab=256000,
    activation="sq_relu",
    source="arXiv:2402.16819",
))
