"""InternLM2-20B — dense GQA [arXiv:2403.17297; hf]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=16384, vocab=92544,
    activation="swiglu",
    rope_theta=1_000_000.0,
    source="arXiv:2403.17297",
))
