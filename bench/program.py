"""The seam to the system under test, ``repro_torch``: the architecture
it runs for a configuration file, and the checks that its parameter
layout is the one the benchmark hands it."""
from __future__ import annotations

import dataclasses

# configuration-file keys the program's ArchConfig takes as they are
ARCH_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head",
             "d_ff", "vocab", "activation", "rope_theta", "norm_eps",
             "dtype", "qkv_bias", "rwkv_head_size")


def arch(cfg: dict):
    """The program's ``ArchConfig`` of a configuration file."""
    from repro_torch.configs import get_config
    base = get_config(cfg["arch"])
    return dataclasses.replace(base, **{k: cfg[k] for k in ARCH_KEYS
                                        if k in cfg})


def flat(tree, prefix=""):
    """{path: tensor} of a nested dict, in sorted key order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def check_layout(model, params) -> None:
    """Raise unless ``params`` has the program's keys and shapes."""
    want = {k: tuple(v.shape) for k, v in flat(model.abstract_params())
            .items()}
    have = {k: tuple(v.shape) for k, v in flat(params).items()}
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()))
        raise SystemExit(f"parameter layout differs from the program's: "
                         f"{diff[:6]}")
