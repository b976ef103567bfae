"""Model substrate: the rwkv, griffin and full-attention patterns, dense or
MoE (``moe.py``), over tokens or embeddings, as one composable Transformer
(the port of ``src/repro/models``)."""
from .convert import params_from_numpy
from .layers import P, cross_entropy, rms_norm
from .transformer import Transformer, model_spec

__all__ = ["Transformer", "model_spec", "P", "cross_entropy", "rms_norm",
           "params_from_numpy"]
