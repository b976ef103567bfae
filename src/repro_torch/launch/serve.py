"""Serving entry point: batched prefill + greedy decode with in-place caches.

The port of ``src/repro/launch/serve.py``.  Residency policy (the
paper's, applied to serving): weights and KV caches are uploaded once
and stay device-resident (noupdate); per-request tokens are the only
per-step host→device transfer (advancedload of a few bytes); sampled
tokens are fetched back lazily in batches (delegatestore).

``serve()`` is the one-shot static-batch path: one group of ``batch``
identical requests, prefill + ``gen - 1`` decode steps.  The continuous-
batching engine (``repro_torch.serve``) generalizes it to request-level
scheduling; ``--engine`` runs a seeded open-loop trace through it.  An
``input_embeds`` arch (musicgen-large) takes a seeded embeds prompt and
steps on zero embeds, and a codebook arch is sampled on codebook 0, as
the reference does.  Both run on ``cuda:0`` (and raise without a card)
unless ``--backend cpu``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --reduced --batch 4 --prompt-len 16 --gen 16 --backend cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --reduced --engine --n-requests 24 --rate 50 --capacity 4 \
        --policy fcfs --backend cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, reduced as reduce_cfg
from ..core.backend import TorchDeviceBackend
from ..models import Transformer

BACKENDS = ("torch", "cpu")


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("launch.serve: no CUDA device is available (ask "
                           "for the CPU with device='cpu' / --backend cpu)")
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def serve(cfg, *, batch: int, prompt_len: int, gen: int, seed: int = 0,
          device=None, params=None):
    """``params`` (e.g. a training run's) on ``device``, else the seeded
    init."""
    dev = _device(device)
    model = Transformer(cfg)
    if params is None:
        params = model.init(torch.Generator(dev).manual_seed(seed),
                            device=dev)                   # resident
    rng = np.random.default_rng(seed)
    max_seq = prompt_len + gen
    if cfg.input_embeds:
        prompt = {"embeds": torch.from_numpy(rng.standard_normal(
            (batch, prompt_len, cfg.d_model), dtype=np.float32)).to(dev)}
    else:
        prompt = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int32)
        ).to(dev)}

    def sample(logits):
        """Greedy tokens; codebook archs sample codebook 0."""
        if cfg.n_codebooks:
            logits = logits[..., 0, :]
        return torch.argmax(logits, dim=-1).to(torch.int32)

    t0 = time.perf_counter()
    logits, cache = model.prefill(params, prompt, max_seq=max_seq)
    tok = sample(logits)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out_tokens = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        pos = torch.full((batch,), prompt_len + i, dtype=torch.int32,
                         device=dev)
        if cfg.input_embeds:
            step_in = {"embeds": torch.zeros((batch, cfg.d_model),
                                             dtype=torch.float32, device=dev)}
        else:
            step_in = {"tokens": tok}
        logits, cache = model.decode_step(params, cache, step_in, pos)
        tok = sample(logits)
        out_tokens.append(tok)
    # delegatestore: one fetch for the whole generation
    generated = torch.stack(out_tokens, dim=1).cpu().numpy()
    t_decode = time.perf_counter() - t0
    # gen == 1 never enters the decode loop: the only token comes from the
    # prefill, so decode throughput is 0 by definition
    decode_tok_s = (batch * (gen - 1) / max(t_decode, 1e-9)
                    if gen > 1 else 0.0)
    total = t_prefill + t_decode
    return {
        "generated": generated,
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_s": decode_tok_s,
        "tokens_per_s": batch * gen / max(total, 1e-9),
    }


def make_backend(name: str):
    """``torch`` → None (the torch backend on ``cuda:0``), ``cpu`` → a
    ``TorchDeviceBackend`` on the host."""
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; have {BACKENDS}")
    return TorchDeviceBackend("cpu") if name == "cpu" else None


def run_engine(cfg, *, n_requests: int, rate_rps: float, capacity: int,
               policy: str, join_policy: str = "continuous",
               max_seq: int = 64, seed: int = 0,
               respect_arrivals: bool = True, backend=None):
    """Replay a seeded open-loop trace through the continuous-batching
    engine (``repro_torch.serve``) and return its report."""
    from ..serve import Engine, ServeRuntime, make_trace
    rt = ServeRuntime(cfg, max_seq=max_seq, seed=seed, backend=backend)
    eng = Engine(rt, capacity=capacity, join_policy=join_policy,
                 policy=policy)
    reqs = make_trace(cfg, n_requests=n_requests, rate_rps=rate_rps,
                      seed=seed, max_seq=max_seq)
    return eng.run(reqs, respect_arrivals=respect_arrivals)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--engine", action="store_true",
                    help="continuous-batching engine over a seeded trace")
    ap.add_argument("--n-requests", type=int, default=24)
    ap.add_argument("--rate", type=float, default=50.0,
                    help="open-loop arrival rate (requests/s)")
    ap.add_argument("--capacity", type=int, default=4)
    ap.add_argument("--policy", default="fcfs", choices=("fcfs", "sjf"))
    ap.add_argument("--join-policy", default="continuous",
                    choices=("continuous", "static"))
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="torch", choices=BACKENDS,
                    help="torch: cuda:0 (raises without a card); cpu: the "
                    "host")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)

    if args.engine:
        rep = run_engine(cfg, n_requests=args.n_requests,
                         rate_rps=args.rate, capacity=args.capacity,
                         policy=args.policy, join_policy=args.join_policy,
                         max_seq=args.max_seq, seed=args.seed,
                         backend=make_backend(args.backend))
        print(f"[serve.engine] {rep['n_requests']} requests in "
              f"{rep['wall_s']:.2f}s  {rep['requests_per_s']:.1f} req/s  "
              f"{rep['tokens_per_s']:.0f} tok/s  "
              f"p50={rep['latency_p50_s']*1e3:.0f}ms "
              f"p99={rep['latency_p99_s']*1e3:.0f}ms  "
              f"occupancy={rep['occupancy']:.2f}")
        print(f"[serve.engine] tune: {rep['tune']['measurements']} measured "
              f"/ {rep['tune']['hits']} cached  pool: {rep['pool']}")
        return rep

    out = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, seed=args.seed,
                device="cpu" if args.backend == "cpu" else None)
    print(f"[serve] generated shape {out['generated'].shape} "
          f"prefill={out['prefill_s']:.2f}s decode={out['decode_s']:.2f}s "
          f"({out['tokens_per_s']:.0f} tok/s end-to-end, "
          f"{out['decode_tok_s']:.0f} tok/s decode)")
    print("[serve] sample:", out["generated"][0][:12])
    return out


if __name__ == "__main__":
    main()
