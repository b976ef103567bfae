"""The control, the reference in float8 put in the program's place, comes
out as not correct against each cell's limits, at sizes a test run can
hold (on the chip ``calibrate.py --control`` reads it at the cells'
sizes)."""
import numpy as np
import torch

from bench.drivers import serve as S, train as T
from bench.drivers.common import verdict
from bench.reference import make_params, model_for
from bench.tests import tiny


def test_train_control_fails():
    c = tiny.cell("internlm2-20b.train-4k")
    ref = T.reference_readings(c, 11, "cpu")
    ctl = T.reference_readings(c, 11, "cpu", "fp8")
    ok, checks = verdict(T.compare(ctl, ref), c["work"]["check"])
    assert not ok, checks


def _control(name, **sizes):
    c = tiny.cell(name)
    cfg = c["cfg"]
    cfg.update(sizes)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg["vocab"], (2, 48)))
    p = make_params(cfg, 3, "cpu", torch.float32)
    ref = model_for(cfg).logits(p, toks)
    ctl = model_for(cfg, "fp8").logits(p, toks)
    stats = S.gap_stats(S.gaps(list(ref), [x.argmax(-1).numpy()
                                           for x in ctl]))
    limits = {k: v for k, v in c["work"]["check"].items()
              if k.endswith("gap")}
    return verdict(stats, limits)


def test_rwkv6_serve_control_fails_at_full_depth():
    # the cell's mean gap is a 32-layer stack's: held at that depth
    ok, checks = _control("rwkv6-3b.serve-chat", n_layers=32, d_model=256,
                          d_ff=896, vocab=4096)
    assert not ok, checks
