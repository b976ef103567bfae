"""MusicGen-large — decoder-only over EnCodec tokens [arXiv:2306.05284].

Backbone only: the EnCodec frontend is a STUB — ``input_specs()`` provides
precomputed frame embeddings (B, S, d).  4 codebooks -> 4 parallel 2048-way
output heads with per-codebook cross-entropy; kv=32 means full MHA.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=8192, vocab=2048,
    activation="geglu",
    n_codebooks=4, input_embeds=True,
    source="arXiv:2306.05284",
))
