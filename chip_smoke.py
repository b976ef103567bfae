#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    PYTHONPATH=src python3 chip_smoke.py

Drives the port's main path through its public entry points and checks it:

1. environment: torch, CUDA, nvcc, triton, and the card with its power limit;
2. build: compiles the flash-attention CUDA kernel from the repo's source;
3. kernel vs plain: the kernel against its plain PyTorch version at the
   attention width of qwen2.5-14b (q (1,4096,8,5,128), k and v
   (1,4096,8,128)), causal and window=1024, fp32 and bf16, every registry
   tile, with the kernel's, the plain version's and one PyTorch call's
   (scaled_dot_product_attention, never called by the port) times beside
   the card's bound;
4. polybench: the ten problems at their default sizes, optimized and naive
   plans, interpreted and compiled, on the torch backend on cuda, against
   the numpy host oracle;
5. attn_step: the flash-attention step program at qwen width (2 steps),
   planned, verified and executed in both modes, with the kernel's launch
   count read around the run.

Prints one JSON line per phase, then the ``{"kernels": [...]}`` line, the
card's ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is non-zero and no result line is printed; so does a machine without
a CUDA card.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

FP32_TOL = 2e-5      # kernel vs plain, fp32 (the reference's kernel sweep)
BF16_TOL = 2e-2      # kernel vs plain, bf16 outputs (same)
# polybench vs the numpy host oracle: fp32 products and sums taken in
# another order than numpy's; checked normwise against the output's scale
POLY_RTOL = 1e-3
LOSS_RTOL = 1e-4     # attn_step final_loss vs the plain version on the card

# NVIDIA data-sheet peaks (dense): fp32 outside the tensor cores, bf16 in
# them, and memory bandwidth, keyed by the name nvidia-smi reports
PEAKS = (
    ("H100 PCIe", {"fp32": 51e12, "bf16": 756e12, "bytes": 2.0e12}),
    ("H100 NVL", {"fp32": 60e12, "bf16": 835e12, "bytes": 3.9e12}),
    ("H100", {"fp32": 67e12, "bf16": 989e12, "bytes": 3.35e12}),
    ("H200", {"fp32": 67e12, "bf16": 989e12, "bytes": 4.8e12}),
)


def report(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card_peaks(name: str) -> dict:
    for key, peaks in PEAKS:
        if key in name:
            return peaks
    raise RuntimeError(f"no peak figures for card {name!r}")


def time_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median of ``reps`` warm calls, each timed with CUDA events."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return sorted(times)[len(times) // 2]


def phase_environment() -> str:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    nvcc_version = subprocess.run([nvcc, "--version"], capture_output=True,
                                  text=True, check=True).stdout
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    report("environment", torch=torch.__version__,
           torch_cuda=torch.version.cuda,
           nvcc=nvcc_version.strip().splitlines()[-1],
           triton=triton_version, card=smi,
           device=torch.cuda.get_device_name(0),
           count=torch.cuda.device_count())
    return smi


def phase_build() -> None:
    from repro_torch.kernels import flash_attention as fa
    t = time.perf_counter()
    lib = fa.build()
    report("build", kernel="flash_attention", seconds=time.perf_counter() - t,
           library=lib._name)


def _bound(shape, dtype_name: str, window: int, peaks: dict):
    """Least time for one causal folded call on these inputs: the visible
    (query, key) pairs' FLOPs over the type's peak, against q, k, v read
    once and o written once over the memory rate."""
    import numpy as np
    BK, S, G, D, T = shape
    q_pos = np.arange(S)
    lo = np.maximum(q_pos - window + 1, 0) if window else 0
    pairs = int(np.maximum(np.minimum(q_pos + 1, T) - lo, 0).sum())
    flops = 4.0 * BK * G * D * pairs
    itemsize = 4 if dtype_name == "float32" else 2
    nbytes = (2 * BK * S * G * D + 2 * BK * T * D) * itemsize
    ops_ms = flops / peaks["fp32" if dtype_name == "float32" else "bf16"] * 1e3
    bytes_ms = nbytes / peaks["bytes"] * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", flops, nbytes)


def phase_kernel(peaks: dict) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, variants

    cfg = get_config("qwen2.5-14b")
    B, S = 1, 4096
    K, G, D = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.d_head
    T = S
    rng = np.random.default_rng(0)
    host = {"q": rng.standard_normal((B, S, K, G, D)).astype(np.float32),
            "k": rng.standard_normal((B, T, K, D)).astype(np.float32),
            "v": rng.standard_normal((B, T, K, D)).astype(np.float32)}
    shapes = [host[n].shape for n in ("q", "k", "v")]
    tiles = variants.variants_for("flash_attention", shapes)
    check(len(tiles) == 9, f"want all 9 registry tiles, got {len(tiles)}")
    main = None
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        q, k, v = (torch.from_numpy(host[n]).to("cuda", dtype)
                   for n in ("q", "k", "v"))
        qf, kf, vf = ops.fold_attention(q, k, v)
        for window in (0, 1024):
            want = fa.flash_attention_plain(qf, kf, vf, causal=True,
                                            window=window)
            want = want.reshape(B, K, S, G, D).permute(0, 2, 1, 3, 4)
            errs = {}
            for tile in tiles:
                out = ops.flash_attention(q, k, v, causal=True, window=window,
                                          **tile.kwargs())
                torch.cuda.synchronize()
                errs[tile.label] = (out.float() - want.float()).abs().max() \
                    .item()
            err = max(errs.values())
            check(err <= tol, f"kernel vs plain {dtype} window={window}: "
                  f"max abs err {err} > {tol}")
            kernel_ms = time_ms(lambda: fa.flash_attention_folded(
                qf, kf, vf, causal=True, window=window))
            plain_ms = time_ms(lambda: fa.flash_attention_plain(
                qf, kf, vf, causal=True, window=window), reps=5)
            qs, ks, vs = qf.transpose(1, 2), kf[:, None], vf[:, None]
            if window:
                i = torch.arange(S, device="cuda")
                allowed = (i[:, None] >= i[None, :]) & \
                    (i[:, None] - i[None, :] < window)
                library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qs, ks, vs, attn_mask=allowed, scale=1.0, enable_gqa=True)
            else:
                library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qs, ks, vs, is_causal=True, scale=1.0, enable_gqa=True)
            library_ms = time_ms(library)
            dname = str(dtype).replace("torch.", "")
            bound_ms, bound_by, flops, nbytes = _bound(
                (B * K, S, G, D, T), dname, window, peaks)
            row = {"dtype": dname, "window": window, "tol": tol,
                   "max_abs_err": err, "tiles": len(errs),
                   "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "flops": flops, "bytes": nbytes}
            report("kernel_vs_plain", kernel="flash_attention",
                   q=list(host["q"].shape), k=list(host["k"].shape), **row)
            if dtype is torch.float32 and window == 0:
                main = row
            del want, out
        del q, k, v, qf, kf, vf
        torch.cuda.empty_cache()
    return main


def phase_polybench() -> None:
    import numpy as np

    from repro_torch.core import (TorchDeviceBackend, emit, execute, plan,
                                  run_host_oracle)
    from repro_torch.polybench import PROBLEMS, build

    be = TorchDeviceBackend("cuda")
    for name in PROBLEMS:
        p, _ = build(name)
        oracle = run_host_oracle(p)
        counts = {}
        for policy in ("optimized", "naive"):
            pl = plan(p, policy=policy)
            out_i, s_i = execute(pl, backend=be, mode="interpreted")
            out_c, s_c = execute(pl, backend=be, mode="compiled")
            check(s_i.transfer_counts() == s_c.transfer_counts(),
                  f"{name}/{policy}: transfer counts differ between modes")
            worst = 0.0
            for k in p.outputs:
                check(np.array_equal(out_i[k], out_c[k]),
                      f"{name}/{policy}: compiled != interpreted for {k!r}")
                scale = float(np.abs(oracle[k]).max()) or 1.0
                rel = float(np.abs(out_c[k] - oracle[k]).max()) / scale
                check(rel <= POLY_RTOL, f"{name}/{policy}: {k!r} off the "
                      f"host oracle by {rel} of its scale > {POLY_RTOL}")
                worst = max(worst, rel)
            counts[policy] = s_i.transfer_counts()
            report("polybench", problem=name, policy=policy,
                   n=int(p.inputs[next(iter(p.inputs))].shape[0]),
                   normwise_err=worst, tol=POLY_RTOL,
                   wall_ms_interpreted=s_i.wall_time * 1e3,
                   wall_ms_compiled=s_c.wall_time * 1e3,
                   fused_launches=s_c.fused_launches,
                   **s_i.transfer_counts())
            if name == "3mm" and policy == "optimized":
                text = emit(pl)
                header = text[:text.index("int main()")].rstrip()
        moved = {pol: c["h2d_transfers"] + c["d2h_transfers"]
                 for pol, c in counts.items()}
        check(moved["optimized"] <= moved["naive"],
              f"{name}: optimized moves more transfers than naive {moved}")
        if name == "3mm":
            report("table2_3mm", optimized=counts["optimized"],
                   naive=counts["naive"], emit_header=header.splitlines())


def phase_attn_step() -> int:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import execute, plan, verify_plan
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.optim import attention_step_program

    cfg = get_config("qwen2.5-14b")
    K, G, D = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.d_head
    shapes = (1, 4096, 4096, K, G, D)
    prog = attention_step_program(2, shapes=shapes)
    pl = plan(prog)
    rep = verify_plan(pl)
    check(rep.ok and not rep.violations, rep.summary())

    fa.launches = 0          # the main path's run starts here
    results = {}
    for mode in ("interpreted", "compiled"):
        before = fa.launches
        out, stats = execute(pl, mode=mode)
        check(fa.launches - before == 2,
              f"attn_step {mode}: {fa.launches - before} kernel launches, "
              "want 2 (one per step)")
        results[mode] = (out["final_loss"], stats)
    launches = fa.launches   # ... and ends here
    loss_i, s_i = results["interpreted"]
    loss_c, s_c = results["compiled"]
    check(np.array_equal(loss_i, loss_c),
          "attn_step: compiled final_loss != interpreted")
    check(s_i.transfer_counts() == s_c.transfer_counts(),
          "attn_step: transfer counts differ between modes")

    o = fa.flash_attention_plain(*ops.fold_attention(
        *(torch.from_numpy(prog.inputs[n]).cuda() for n in "qkv")),
        causal=True)
    g = torch.from_numpy(prog.inputs["gain"] * np.float32(1.001)).cuda()
    want = ((o * o).sum().reshape(1) * g).cpu().numpy()
    rel = float(np.abs(loss_c - want).max() / np.abs(want).max())
    check(rel <= LOSS_RTOL, f"attn_step final_loss {loss_c} vs plain {want}:"
          f" rel err {rel} > {LOSS_RTOL}")
    report("attn_step", shapes=list(shapes), n_steps=2,
           verify=pl.meta["verify"], final_loss=float(loss_c[0]),
           plain_loss=float(want[0]), rel_err=rel, tol=LOSS_RTOL,
           kernel_launches=launches,
           wall_ms_interpreted=s_i.wall_time * 1e3,
           wall_ms_compiled=s_c.wall_time * 1e3,
           compile_ms=s_c.compile_time * 1e3, **s_i.transfer_counts())
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    smi = phase_environment()
    peaks = card_peaks(torch.cuda.get_device_name(0))
    phase_build()
    main_row = phase_kernel(peaks)
    phase_polybench()
    launches = phase_attn_step()
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:80",
        "launches": launches, "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
