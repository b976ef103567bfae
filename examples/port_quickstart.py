"""Quickstart on the PyTorch port: train a small LM end to end with the
whole stack (prefetching data pipeline = advancedload, async
checkpointing = delegatestore, auto-resume), then serve a few tokens from
the trained weights.  Whether it learned is read on one held-out batch of
the stream, before and after: 60 steps at lr 1e-4 move the training
losses by less than their batch-to-batch spread.  Runs on ``cuda:0``
(and raises without a card) unless ``--device cpu``:

    PYTHONPATH=src python examples/port_quickstart.py [--device cpu]
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import Transformer  # noqa: E402

HELD_OUT = 10_000          # a batch index the 60 steps never read


def held_out_loss(cfg, params, device) -> float:
    batch = {k: torch.from_numpy(v).to(device) for k, v in
             SyntheticLM(cfg, 8, 64, seed=0).batch_at(HELD_OUT).items()}
    with torch.no_grad():
        return float(Transformer(cfg).loss(params, batch)[0])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    cfg = reduced(get_config("internlm2-20b"))
    print(f"config: {cfg.name} ({cfg.n_layers}L d={cfg.d_model})")

    with tempfile.TemporaryDirectory() as ckpt_dir:
        out = train(cfg, steps=60, batch=8, seq=64, ckpt_dir=ckpt_dir,
                    ckpt_every=20, log_every=10, device=args.device)
    first, last = out["losses"][0][1], out["losses"][-1][1]
    print(f"\ntrained {out['final_step']} steps: "
          f"loss {first:.3f} -> {last:.3f} "
          f"({out['wall_s']:.1f}s wall)")
    init = Transformer(cfg).init(
        torch.Generator(args.device).manual_seed(0), device=args.device)
    before = held_out_loss(cfg, init, args.device)
    after = held_out_loss(cfg, out["params"], args.device)
    print(f"held-out batch: loss {before:.3f} -> {after:.3f}")
    assert after < before, "loss should decrease on the learnable stream"

    res = serve(cfg, batch=2, prompt_len=16, gen=8, device=args.device,
                params=out["params"])
    print(f"served: {res['generated'].shape[1]} tokens/request, "
          f"{res['tokens_per_s']:.0f} tok/s")
    print("sample tokens:", res["generated"][0])
    return out, res


if __name__ == "__main__":
    main()
