"""The general traffic generator: a cell's traffic parameters and a seed
in, requests or token batches out.

Every seed gets the same work: the prompt and output lengths are the
mix's weights apportioned over the cell's request count, and the gaps
between arrivals are the quantiles of the arrival law, each set shuffled
by the cell's ``order_seed``, so every run offers the same schedule.
Token ids are drawn by the run's seed.

Serve parameters (``traffic`` of a serve workload file):
  ``rate_rps``     mean offered rate, requests/s; the request count is
                   rate × seconds;
  ``prompt_lens``  [[tokens, weight], ...];
  ``output_lens``  [[tokens, weight], ...];
  ``on_s``, ``off_s`` (optional) on/off bursts: arrivals only in the on
                   periods, at rate × (on + off) / on, so the mean holds.
  ``order_seed``   (optional, 0) the seed of the schedule: the order of
                   the arrival gaps and of the lengths.
Train parameters: ``batch`` rows of ``seq`` tokens a step, uniform ids.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def apportion(mix: Sequence, n: int) -> np.ndarray:
    """n values of ``mix`` ([[value, weight], ...]) in proportion to the
    weights (largest remainders), in mix order."""
    vals = np.array([v for v, _ in mix], np.int64)
    w = np.array([w for _, w in mix], np.float64)
    exact = w / w.sum() * n
    counts = np.floor(exact).astype(np.int64)
    for i in np.argsort(-(exact - counts), kind="stable")[:n - counts.sum()]:
        counts[i] += 1
    return np.repeat(vals, counts)


def arrivals(params: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """n arrival times (s): Poisson quantile gaps in a seeded order, or
    the same squeezed into on periods."""
    rate = float(params["rate_rps"])
    on, off = params.get("on_s"), params.get("off_s")
    busy_rate = rate if not on else rate * (on + off) / on
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u) / busy_rate
    t = np.cumsum(rng.permutation(gaps))
    if on:
        t = np.floor(t / on) * (on + off) + np.mod(t, on)
    return t


def serve_requests(params: Dict, vocab: int, seconds: float, seed: int
                   ) -> List[dict]:
    """The requests due in a window of ``seconds``: dicts of ``rid``,
    ``arrival_s``, ``prompt`` (int32 ids) and ``max_new_tokens``."""
    rng = np.random.default_rng([int(seed), 0x5e7e])
    order = np.random.default_rng([int(params.get("order_seed", 0)), 0x5e7e])
    n = max(1, int(round(float(params["rate_rps"]) * seconds)))
    t = arrivals(params, n, order)
    plens = order.permutation(apportion(params["prompt_lens"], n))
    olens = order.permutation(apportion(params["output_lens"], n))
    return [{"rid": i, "arrival_s": float(t[i]),
             "prompt": rng.integers(0, vocab, int(plens[i]), dtype=np.int64
                                    ).astype(np.int32),
             "max_new_tokens": int(olens[i])} for i in range(n)]


class TokenBatches:
    """Training batches: batch ``i`` is a pure function of (seed, i), and
    every row of every batch is drawn afresh.  ``batch_at`` is the source
    interface the program's ``PrefetchIterator`` reads."""

    def __init__(self, params: Dict, vocab: int, seed: int):
        self.batch, self.seq = int(params["batch"]), int(params["seq"])
        self.vocab, self.seed = int(vocab), int(seed)

    def batch_at(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng([self.seed, 0x7a1, int(index)])
        toks = rng.integers(0, self.vocab, (self.batch, self.seq + 1),
                            dtype=np.int64).astype(np.int32)
        return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}

    @property
    def tokens_per_step(self) -> int:
        return self.batch * self.seq

