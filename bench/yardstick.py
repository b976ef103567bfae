"""The frozen yardstick: the chip's peaks and the operations and bytes a
kernel or a step needs, computed from shapes alone.

Peaks are the NVIDIA H100 SXM data sheet's dense rates at 700 W.  A
roofline share is the least time the chip could take for the work (the
larger of operations over the peak and bytes over the memory rate)
divided by the time measured; each input byte counts as read once and
each output byte as written once, whatever a kernel reads again.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12      # dense bf16 tensor-core rate, FLOP/s
HBM_BYTES_PER_S = 3.35e12     # HBM3 rate, bytes/s
BF16 = 2                      # bytes a bf16 element


def causal_pairs(S: int) -> int:
    """(query, key) pairs a causal mask keeps over S positions."""
    return S * (S + 1) // 2


def flash_fwd_flops(B: int, S: int, H: int, D: int) -> float:
    """Causal attention's forward: Q·Kᵀ and P·V over the kept pairs."""
    return 4.0 * B * H * D * causal_pairs(S)


def flash_fwd_bytes(B: int, S: int, H: int, K: int, D: int) -> float:
    """q and o (H heads), k and v (K heads), bf16, each moved once."""
    return float(BF16 * B * S * D * (2 * H + 2 * K))


def flash_bwd_flops(B: int, S: int, H: int, D: int) -> float:
    """The backward of any implementation: 2.5 times the forward's
    operations (dV, dP, dS·K, dSᵀ·Q and the recomputed scores)."""
    return 2.5 * flash_fwd_flops(B, S, H, D)


def flash_bwd_bytes(B: int, S: int, H: int, K: int, D: int) -> float:
    """q, o, do and dq (H heads), k, v, dk and dv (K heads), bf16."""
    return float(BF16 * B * S * D * (4 * H + 4 * K))


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip needs for the work."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def dense_matmul_params(cfg: dict) -> int:
    """Parameters of a dense GQA stack that take part in a matrix product:
    every layer's projections and FFN, and the head (the embedding table
    is a gather)."""
    d, H, K, D, f = (cfg[k] for k in ("d_model", "n_heads", "n_kv_heads",
                                      "d_head", "d_ff"))
    per_layer = d * H * D * 2 + d * K * D * 2 + 3 * d * f
    return cfg["n_layers"] * per_layer + d * cfg["vocab"]


def dense_params(cfg: dict) -> int:
    """Every parameter of a dense GQA stack with an untied head."""
    d = cfg["d_model"]
    return (dense_matmul_params(cfg) + cfg["vocab"] * d
            + cfg["n_layers"] * 2 * d + d)


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """A dense train step's model FLOPs: 6·N·T over the matmul
    parameters, plus causal attention's 12·H·D·(S/2) per token and layer
    (forward and backward, recomputation not counted)."""
    T = batch * seq
    attn = 12.0 * cfg["n_heads"] * cfg["d_head"] * (seq / 2) * T \
        * cfg["n_layers"]
    return 6.0 * dense_matmul_params(cfg) * T + attn
