"""Snowflake Arctic 480B — MoE 128e top-2 + dense residual branch
[hf:Snowflake/snowflake-arctic-base].

Assumption (DESIGN.md): the dense residual FFN uses hidden = d_ff (4864).
Default optimizer for this config is adafactor (Adam fp32 state for 480B
exceeds one pod's HBM); the host-offloaded Adam variant is the framework's
paper-technique alternative (optim/offload.py).
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=4864, vocab=32000,
    activation="swiglu",
    n_experts=128, top_k=2, moe_dense_residual=True,
    source="hf:Snowflake/snowflake-arctic-base",
))
