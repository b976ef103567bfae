"""Architecture + shape configuration registry.

Every assigned architecture is a frozen ``ArchConfig``; ``reduced()``
produces the small same-family variant used by the CPU smoke tests.  The
FULL configs are only ever lowered abstractly (ShapeDtypeStruct) by
``launch/dryrun.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "register", "get_config",
           "list_archs", "reduced", "param_count"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                # 0 for attention-free archs
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    activation: str = "swiglu"  # swiglu | sq_relu | geglu
    qkv_bias: bool = False
    qk_norm: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- hybrid / ssm ---
    layer_pattern: str = "full"   # full | griffin (R,R,A) | rwkv
    local_window: int = 0         # >0: sliding-window attention
    rglru_conv_width: int = 4
    rwkv_head_size: int = 64
    # --- io / heads ---
    n_codebooks: int = 0          # musicgen: 4 parallel output heads
    input_embeds: bool = False    # frontend STUB supplies (B, S, d) embeds
    # --- numerics ---
    dtype: str = "bfloat16"
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    # --- capability flags ---
    sub_quadratic: bool = False   # True => long_500k is runnable
    source: str = ""              # provenance note

    @property
    def attn_free(self) -> bool:
        return self.layer_pattern == "rwkv"

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def layer_kind(self, i: int) -> str:
        """'attn' | 'rglru' | 'rwkv' for layer i (griffin: R,R,A pattern)."""
        if self.layer_pattern == "griffin":
            return "attn" if i % 3 == 2 else "rglru"
        if self.layer_pattern == "rwkv":
            return "rwkv"
        return "attn"

    def layer_kinds(self) -> Tuple[str, ...]:
        return tuple(self.layer_kind(i) for i in range(self.n_layers))


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k":    ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k":   ShapeSpec("long_500k", "decode", 524_288, 1),
}

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        # import side-effect registration
        from . import ALL_ARCHS  # noqa: F401
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; known: {sorted(_REGISTRY)}") from None


def list_archs() -> Tuple[str, ...]:
    from . import ALL_ARCHS  # noqa: F401
    return tuple(sorted(_REGISTRY))


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Small same-family config for CPU smoke tests: few layers (enough to
    cover a full hybrid pattern), tiny width/vocab, few experts."""
    n_layers = 3 if cfg.layer_pattern == "griffin" else 2
    n_heads = 0 if cfg.attn_free else 4
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=n_heads if not cfg.attn_free else 0,
        n_kv_heads=0 if cfg.attn_free else (1 if cfg.n_kv_heads == 1 else 2),
        d_head=16,
        d_ff=96 if not cfg.is_moe else 32,
        vocab=257,
        n_experts=8 if cfg.is_moe else 0,
        top_k=min(cfg.top_k, 2) if cfg.is_moe else 0,
        local_window=32 if cfg.local_window else 0,
        rwkv_head_size=16,
        dtype="float32",
    )


def param_count(cfg: ArchConfig) -> int:
    """Analytic parameter count (used for 6ND in the roofline report)."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    total = v * d                       # embedding
    if cfg.n_codebooks:
        total += cfg.n_codebooks * v * d    # per-codebook output heads
    else:
        total += v * d                      # untied LM head
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        total += 2 * d                      # 2 norms
        if kind == "attn":
            q = cfg.n_heads * cfg.d_head
            kv = cfg.n_kv_heads * cfg.d_head
            total += d * q + 2 * d * kv + q * d
            if cfg.qkv_bias:
                total += q + 2 * kv
        elif kind == "rglru":
            # in/out proj + conv + gates (x2 branch) + recurrence params
            total += 2 * d * d + cfg.rglru_conv_width * d + 2 * d * d + 2 * d
        elif kind == "rwkv":
            # time-mix: r,k,v,w,g projections + output + lora + decay
            total += 5 * d * d + d * d + 6 * d + 2 * (d * 32 + 32 * d)
        # FFN
        if cfg.is_moe:
            if cfg.activation in ("swiglu", "geglu"):
                e_params = 3 * d * f
            else:
                e_params = 2 * d * f
            total += cfg.n_experts * e_params + d * cfg.n_experts  # + router
            if cfg.moe_dense_residual:
                total += e_params
        elif kind != "rwkv":
            if cfg.activation in ("swiglu", "geglu"):
                total += 3 * d * f
            else:
                total += 2 * d * f
        else:
            total += 2 * d * f              # rwkv channel-mix (r + k/v)
    return total


def active_param_count(cfg: ArchConfig) -> int:
    """Active params per token (MoE: top_k of n_experts) for 6·N_active·D."""
    if not cfg.is_moe:
        return param_count(cfg)
    d, f = cfg.d_model, cfg.d_ff
    e_params = (3 if cfg.activation in ("swiglu", "geglu") else 2) * d * f
    return param_count(cfg) - cfg.n_layers * \
        (cfg.n_experts - cfg.top_k) * e_params
