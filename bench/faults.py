"""Faults planted underneath the timed path, for the checks that
``correct`` must catch them (``calibrate.py`` on the chip, the tests on
the CPU).  The benchmark's own runs never use this module."""
from __future__ import annotations

import contextlib

import torch


def unchanged_state(step):
    """A train step that returns its params and state unchanged (its loss
    still computed)."""
    model = step.args[0]

    def run(params, state, batch):
        with torch.no_grad():
            loss, _ = model.loss(params, batch)
        return params, state, {"loss": loss}
    return run


def half_batch(step):
    """A train step on half of its batch's tokens, the mean taken over
    the rest (the other half's labels masked out)."""
    def run(params, state, batch):
        lab = batch["labels"].clone()
        lab[:, lab.shape[1] // 2:] = -1
        return step(params, state, {**batch, "labels": lab})
    return run


TRAIN = {"unchanged_state": unchanged_state, "half_batch": half_batch}


@contextlib.contextmanager
def altered_tokens(every: int = 7):
    """Every ``every``-th decode step of ``ServeRuntime``, each row's new
    token is replaced by the next id where it is produced: in the output
    buffer and in the token the next step reads."""
    from repro_torch.serve.engine import ServeRuntime
    orig = ServeRuntime.decode

    def decode(self, cache, tok, pos, out_buf, gen_idx):
        orig(self, cache, tok, pos, out_buf, gen_idx)
        self._fault_steps = getattr(self, "_fault_steps", 0) + 1
        if self._fault_steps % every:
            return
        with self.on_stream(0):
            new = torch.remainder(tok + 1, self.cfg.vocab).to(tok.dtype)
            rows = torch.arange(out_buf.shape[0], device=out_buf.device)
            out_buf[rows, (gen_idx.long() - 1).clamp(min=0)] = new
            tok.copy_(new)
    ServeRuntime.decode = decode
    try:
        yield
    finally:
        ServeRuntime.decode = orig
