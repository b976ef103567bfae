"""Model substrate: the forward of the rwkv, griffin and dense patterns as
one composable Transformer (the port of ``src/repro/models``)."""
from .convert import params_from_numpy
from .layers import P, cross_entropy, rms_norm
from .transformer import Transformer, model_spec

__all__ = ["Transformer", "model_spec", "P", "cross_entropy", "rms_norm",
           "params_from_numpy"]
