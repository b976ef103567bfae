"""Seeded synthetic load: open-loop Poisson arrivals with mixed lengths.

Open-loop means arrival times are drawn up front and do NOT react to
engine backpressure — the realistic regime for a serving benchmark
(clients don't slow down because the server is busy).  Everything is
driven by one ``numpy`` Generator, so a (seed, rate, mixes) tuple is a
reproducible trace: the continuous and static benchmark modes replay
the IDENTICAL request sequence.

The default generation-length mix is deliberately skewed (mostly short,
a few long): that is the traffic shape where continuous batching wins —
under static batching every group drains at the pace of its longest
member, while continuous batching backfills the freed rows.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .request import Request

__all__ = ["make_trace", "DEFAULT_GEN_MIX", "DEFAULT_PROMPT_MIX"]

# (length, probability) pairs; probabilities are normalized
DEFAULT_PROMPT_MIX: Sequence = ((8, 0.5), (16, 0.35), (24, 0.15))
DEFAULT_GEN_MIX: Sequence = ((4, 0.55), (8, 0.30), (48, 0.15))


def _draw(rng: np.random.Generator, mix: Sequence, n: int) -> np.ndarray:
    vals = np.array([v for v, _ in mix], np.int64)
    p = np.array([w for _, w in mix], np.float64)
    return rng.choice(vals, size=n, p=p / p.sum())


def make_trace(cfg, *, n_requests: int, rate_rps: float, seed: int = 0,
               prompt_mix: Sequence = DEFAULT_PROMPT_MIX,
               gen_mix: Sequence = DEFAULT_GEN_MIX,
               max_seq: Optional[int] = None) -> List[Request]:
    """Build ``n_requests`` requests with Exp(1/rate) inter-arrival gaps
    (i.e. Poisson arrivals at ``rate_rps``).  Prompts are random tokens in
    ``cfg.vocab`` — or random embeds for ``input_embeds`` archs.  When
    ``max_seq`` is given, drawn lengths are clamped so every request fits."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(rate_rps, 1e-9), n_requests)
    arrivals = np.cumsum(gaps)
    plens = _draw(rng, prompt_mix, n_requests)
    glens = _draw(rng, gen_mix, n_requests)
    if max_seq is not None:
        plens = np.minimum(plens, max_seq - 1)
        glens = np.minimum(glens, max_seq - plens)
    out: List[Request] = []
    for rid in range(n_requests):
        L = int(plens[rid])
        if cfg.input_embeds:
            prompt = rng.standard_normal((L, cfg.d_model)).astype(np.float32)
        else:
            prompt = rng.integers(0, cfg.vocab, (L,)).astype(np.int32)
        out.append(Request(rid=rid, prompt=prompt,
                           max_new_tokens=int(glens[rid]),
                           arrival_s=float(arrivals[rid])))
    return out
