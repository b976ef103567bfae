"""End-to-end training driver.

The port of ``src/repro/launch/train.py``, with its host↔device schedule,
the paper's optimized plan on the training loop:

  * advancedload: the data pipeline copies batch i+1 to the card on its
    own stream while step i runs (``PrefetchIterator``), and with an
    offloaded optimizer (``optim.offloaded_optimizer``) the state streams
    in from pinned host memory piece by piece inside the update;
  * delegatestore: metrics stay on the device and are fetched only at log
    steps; checkpoints copy device→host at once and reach the disk on a
    background thread;
  * noupdate: params and optimizer state never move (updated in place);
  * synchronize: the one host sync a log step makes (``float(loss)``).

Fault tolerance: auto-resume from the latest checkpoint and its data
cursor, injected failures (``--fail-at``) for the restart path, the
straggler watchdog.  Params come from the port's seeded
``Transformer.init``.  Runs on the card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-20b \\
        --reduced --steps 30 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt \\
        --device cpu
"""
from __future__ import annotations

import argparse
import functools
import time
from typing import Optional

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config, reduced as reduce_cfg
from ..data import PrefetchIterator, SyntheticLM
from ..models import Transformer
from ..optim import default_optimizer
from ..runtime import FaultInjector, StepWatchdog
from .steps import train_step

__all__ = ["make_train_step", "train", "main"]


def make_train_step(model, opt):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    value and grad of ``model.loss``, then ``opt.update``, in place."""
    return functools.partial(train_step, model, opt)


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("launch.train: no CUDA device is available (ask "
                           "for the CPU with device='cpu' / --device cpu)")
    return dev


def train(cfg, *, steps: int, batch: int, seq: int, ckpt_dir: str,
          ckpt_every: int = 10, log_every: int = 5, seed: int = 0,
          injector: Optional[FaultInjector] = None,
          resume: bool = True, device=None) -> dict:
    dev = _device(device)
    model = Transformer(cfg)
    opt = default_optimizer(cfg)
    ckpt = CheckpointManager(ckpt_dir)
    watchdog = StepWatchdog()

    params = model.init(torch.Generator(dev).manual_seed(seed), device=dev)
    opt_state = opt.init(params)
    start_step = 0
    state_tree = {"params": params, "opt": opt_state}
    if resume:
        restored = ckpt.restore_latest(state_tree)
        if restored is not None:
            start_step, state_tree, extra = restored
            print(f"[train] resumed from step {start_step}")
    params, opt_state = state_tree["params"], state_tree["opt"]

    source = SyntheticLM(cfg, batch, seq, seed=seed)
    it = PrefetchIterator(source, start_index=start_step,
                          device=dev)                     # advancedload
    step_fn = make_train_step(model, opt)

    losses = []
    t_start = time.perf_counter()
    try:
        for step in range(start_step, steps):
            t0 = time.perf_counter()
            batch_dev = next(it)
            if injector is not None:
                injector.maybe_fail(step)
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 batch_dev)
            # metrics stay on the device (delegatestore deferred until the
            # log step below forces the sync)
            if (step + 1) % log_every == 0 or step + 1 == steps:
                loss = float(metrics["loss"])      # ← the sync point
                losses.append((step + 1, loss))
                dt = time.perf_counter() - t0
                watchdog.record("host0", dt)
                print(f"[train] step {step + 1:5d} loss {loss:.4f} "
                      f"({dt * 1e3:.0f} ms)"
                      + (" STRAGGLER" if watchdog.stragglers() else ""))
            if (step + 1) % ckpt_every == 0 or step + 1 == steps:
                ckpt.save(step + 1,
                          {"params": params, "opt": opt_state},
                          extra={"data_index": step + 1})
    finally:
        it.close()
        ckpt.wait()                                # final synchronize
    wall = time.perf_counter() - t_start
    return {"losses": losses, "final_step": steps, "wall_s": wall,
            "params": params}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject failures at these steps (restart demo)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    injector = FaultInjector(tuple(args.fail_at)) if args.fail_at else None

    attempts = 0
    while True:
        try:
            out = train(cfg, steps=args.steps, batch=args.batch,
                        seq=args.seq, ckpt_dir=args.ckpt_dir,
                        ckpt_every=args.ckpt_every, injector=injector,
                        device=args.device)
            break
        except RuntimeError as e:
            if "no CUDA device" in str(e):
                raise
            attempts += 1
            print(f"[train] FAILURE ({e}); restarting from latest "
                  f"checkpoint (attempt {attempts})")
            if attempts > 5:
                raise
    first = out["losses"][0][1] if out["losses"] else float("nan")
    last = out["losses"][-1][1] if out["losses"] else float("nan")
    print(f"[train] done: steps={out['final_step']} "
          f"loss {first:.4f} -> {last:.4f} wall={out['wall_s']:.1f}s "
          f"restarts={attempts}")
    return out


if __name__ == "__main__":
    main()
