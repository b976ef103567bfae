"""Batched serving demo on the PyTorch port: prefill + greedy decode for
three architecture families (dense GQA, Griffin hybrid, RWKV-6), showing
the per-family cache kinds (full KV / ring buffer + recurrent state /
constant-size state).  Runs on ``cuda:0`` (and raises without a card)
unless ``--device cpu``:

    PYTHONPATH=src python examples/port_serve_demo.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import Transformer  # noqa: E402
from repro_torch.serve.kvpool import tree_flatten  # noqa: E402


def cache_report(cfg):
    """The cache's buffers and bytes at (B=2, T=64), built on the meta
    device: shapes and dtypes only, nothing allocated."""
    m = Transformer(reduced(cfg) if cfg.n_layers > 4 else cfg)
    leaves = tree_flatten(m.init_cache(2, 64, device="meta"))[1]
    total = sum(x.numel() * x.element_size() for x in leaves)
    return f"{len(leaves)} buffers, {total / 1024:.0f} KiB at (B=2, T=64)"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    outs = {}
    for name in ("internlm2-20b", "recurrentgemma-2b", "rwkv6-3b"):
        cfg = reduced(get_config(name))
        print(f"\n=== {name} [{get_config(name).family}] ===")
        print("cache:", cache_report(get_config(name)))
        out = serve(cfg, batch=4, prompt_len=16, gen=12, device=args.device)
        print(f"prefill {out['prefill_s']:.2f}s, decode "
              f"{out['decode_s']:.2f}s ({out['tokens_per_s']:.0f} tok/s)")
        print("tokens[0]:", out["generated"][0])
        outs[name] = out
    return outs


if __name__ == "__main__":
    main()
