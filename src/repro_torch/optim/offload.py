"""Training-step block programs for the offload planner.

``plan_step_program`` is a miniature training loop (host update blocks +
device compute blocks) whose offload schedule can be inspected with the
paper's emitter and counted by the executor; ``attention_step_program``
is the same shape of program around a kernel-tagged flash-attention
block, the tuner's ``attn_step`` gate.

Both are the reference package's builders, written so the bodies run
under numpy and torch alike (``xp.ones(64, dtype=...)`` and
``.sum().reshape(1, 1)`` where the reference relied on numpy-only
keywords); the values and shapes are the same.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.core import Program

__all__ = ["plan_step_program", "attention_step_program"]


def plan_step_program(n_steps: int = 4) -> Program:
    """A miniature training loop as a block program: host data producer,
    device fwd/bwd codelet, device optimizer update reading offloaded state,
    host metric logging — the planner hoists the batch upload (prefetch) and
    sinks the metric download (lazy fetch)."""
    p = Program("train_loop")
    p.bind("w", np.zeros((64, 64), np.float32))
    p.bind("opt_m", np.zeros((64, 64), np.float32))
    p.bind("seed", np.zeros((2,), np.float32))

    p.host(lambda xp, seed: {"batch": xp.outer(
               seed + 1.0, xp.ones(64, dtype=xp.float32))},
           reads=("seed",), writes=("batch",), name="next_batch")
    with p.loop(n_steps):
        p.offload(lambda xp, w, batch:
                  {"grad": (w @ batch.T @ batch) / 64.0,
                   "loss": ((batch @ w) ** 2).sum().reshape(1, 1)},
                  reads=("w", "batch"), writes=("grad", "loss"),
                  name="fwd_bwd")
        p.offload(lambda xp, w, grad, opt_m:
                  {"w": w - 0.1 * (0.9 * opt_m + grad),
                   "opt_m": 0.9 * opt_m + grad},
                  reads=("w", "grad", "opt_m"), writes=("w", "opt_m"),
                  name="opt_update")
    p.host(lambda xp, loss: {"final_loss": loss},
           reads=("loss",), writes=("final_loss",), name="log_metrics")
    p.set_outputs("final_loss", "w")
    return p


def attention_step_program(n_steps: int = 2, *,
                           shapes: Optional[Tuple[int, ...]] = None
                           ) -> Program:
    """A flash-attention train step as a block program with a *tagged*
    kernel block: the ``kernel="flash_attention"`` tag lets the tuner
    enumerate tile variants (``block_q``/``block_k``) for the attention
    launch.  ``shapes`` is (B, S, T, K, G, D); the default is the
    reference's small (1, 128, 128, 1, 1, 8), and a caller passes a model's
    attention width (e.g. qwen2.5-14b: K = 8, G = 5, D = 128) to run the
    same four blocks at full size.  Inputs come from ``default_rng(0)``."""
    from repro_torch.kernels import ops

    B, S, T, K, G, D = shapes or (1, 128, 128, 1, 1, 8)
    rng = np.random.default_rng(0)
    p = Program("attention_step")
    p.bind("q", rng.standard_normal((B, S, K, G, D)).astype(np.float32))
    p.bind("k", rng.standard_normal((B, T, K, D)).astype(np.float32))
    p.bind("v", rng.standard_normal((B, T, K, D)).astype(np.float32))
    p.bind("gain", np.ones((1,), np.float32))

    p.host(lambda xp, gain: {"g": gain * 1.001},
           reads=("gain",), writes=("g",), name="next_gain")
    with p.loop(n_steps):
        # reads are the kernel's ops-layer operands, in operand order —
        # the tuner resolves the variant grid from their shapes
        p.offload(lambda xp, q, k, v, *, block_q=128, block_k=128:
                  {"o": ops.flash_attention(q, k, v, causal=True,
                                            block_q=block_q,
                                            block_k=block_k)},
                  reads=("q", "k", "v"), writes=("o",),
                  name="attention", kernel="flash_attention")
        p.offload(lambda xp, o, g:
                  {"loss": (o * o).sum().reshape(1) * g},
                  reads=("o", "g"), writes=("loss",), name="reduce")
    p.host(lambda xp, loss: {"final_loss": loss},
           reads=("loss",), writes=("final_loss",), name="log_metrics")
    p.set_outputs("final_loss",)
    return p
