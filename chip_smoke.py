#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    PYTHONPATH=src python3 chip_smoke.py

Drives the port's main path through its public entry points and checks it:

1. environment: torch, CUDA, nvcc, triton, and the card with its power limit;
2. build: compiles the five CUDA kernel sources of the repo, one
   ``nvcc`` per source, all started together, each with its build time;
3. kernel vs plain: each kernel against its plain PyTorch version on every
   registry tile, with the kernel's, the plain version's and (where one
   exists) one PyTorch call's time beside the card's bound:
   flash attention at qwen2.5-14b's attention width (q (1,4096,8,5,128),
   k and v (1,4096,8,128)), causal and window=1024, fp32 (the SIMT route)
   and bf16 (the sm90 tensor-core route), and at recurrentgemma-2b's
   (q (1,4096,1,10,256), k and v (1,4096,1,256), bf16 and fp32, window
   2048), beside scaled_dot_product_attention; wkv6 at rwkv6-3b's width
   (r, k, v, w (1,4096,40,64), u (40,64)), fp32 and bf16 r/k/v/u, and
   once more in fp32 with decays of exactly 0, 1e-30 and 1.0 among them;
   rglru_scan at
   recurrentgemma-2b's width (a, b (1,4096,2560) fp32), once more with
   exact zeros, 1e-30 and 1.0 among the decays, at (2,16384,512) for a
   deep look-back, with its (Tc, Dc) tile reported; rmsnorm on
   x (4096,2560), fp32 and bf16, beside torch.nn.functional.rms_norm.
   The PyTorch calls are yardsticks the port never calls;
4. polybench: the ten problems at their default sizes, optimized and naive
   plans, interpreted and compiled, on the torch backend on cuda, against
   the numpy host oracle;
5. attn_step: the flash-attention step program at qwen width (2 steps),
   planned, verified and executed in both modes, with the kernel's launch
   count read around the run;
6. model_forward: ``Transformer.loss`` for rwkv6-3b and recurrentgemma-2b
   at full width, B = 1, S = 4096, with the port's own seeded weights:
   (a) fp32 at a cut depth (4 and 8 layers), kernels (wkv6, rglru_scan,
   flash's SIMT route) against the plain path, with the launch counts read
   around the run, and the final hidden states held against each other
   too; for recurrentgemma-2b the same in bf16 (flash's sm90 route);
   (b) bf16 at full depth (32 and 26 layers) with kernels, timed with CUDA
   events, and one forward under torch.profiler for the device's busy
   time and its largest kernels (which must show the sm90 flash kernel
   once per attention layer and the SIMT one never, and rglru_scan's
   kernel once per recurrent layer);
7. rmsnorm_path: rmsnorm's entry point ``ops.rmsnorm`` on (1,4096,2560)
   activations, fp32 and bf16, with its launch count read around it (no
   model calls rmsnorm, as in the reference);
8. tuner: the plan-space tuner (``tune``, what ``plan(p, policy="auto")``
   calls) on ``TorchDeviceBackend("cuda")`` with a fresh ``TuneCache``:
   (a) 3mm at n = 2048 and (b) attn_step at qwen2.5-14b's attention width
   (2 steps, fp32, flash's SIMT route) measured, each winner executed with
   ``winner_exec_kwargs`` and held against the host oracle / the plain
   loss, each tuned a second time to hit the cache; (c) the four gate
   programs of ``benchmarks/port_check_tuning_baseline.py`` at its sizes,
   unmeasured, against ``tests/golden/port_tuning_baseline.json``.  The
   candidate and execution-class counts must equal the reference tuner's
   (``TUNER_EXPECT``); flash's kernels do not read the tile, so classes
   that differ only in it are measured once (the measured counts), every
   measured kernel time (CUDA events) must lie in (0, wall time], flash
   must launch (1 + reps) x 2 times per measured attn_step class, and
   TF32 must be as the phase found it.

Each kernel's ``launches`` in the kernels line sums the paths that ran it:
attn_step, model_forward and tuner for flash's SIMT route (``flash_attention``),
model_forward for its sm90 route (``flash_attention_sm90``), wkv6 and
rglru_scan, rmsnorm_path for rmsnorm; comparison launches are not counted.
Prints one JSON line per phase, then the ``{"kernels": [...]}`` line, the
card's ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is non-zero and no result line is printed; so does a machine without
a CUDA card.
"""
from __future__ import annotations

import json
import math
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
# kernel vs plain for the recurrences and the norm, as |err| <= tol x
# (1 + |want|): the reference's kernel sweep tolerances (wkv6 2e-4,
# rglru_scan 1e-5, rmsnorm fp32 1e-5, bf16 2e-2)
WKV6_TOL = 2e-4
RGLRU_TOL = 1e-5
RMSNORM_TOL = 1e-5
# model_forward: fp32 loss with kernels vs the plain path's, on the card
FORWARD_RTOL = 1e-4
# model_forward, bf16 at cut depth: the final hidden states with kernels vs
# the plain path, normwise (the norm of the difference over the norm of the
# plain path's states).  Both paths round every activation to bf16 (2^-8
# relative) and the sm90 flash kernel rounds its softmax weights to bf16
# as well, so single roundings differ by an ulp here and there, and the
# recurrent layers amplify a few of them: elementwise, the largest
# difference is a quarter of the largest state, while the bf16 plain path
# itself sits about 0.7 normwise from its fp32 counterpart (PERF.md).  The
# norm measures the kernel, not that amplification
FORWARD_BF16_TOL = 5e-2

# time_ms's spin before each timed call: about a millisecond of SM cycles
HOLD_CYCLES = 2_000_000

# the TPU kernel each CUDA kernel replaces
REPLACES = {"flash_attention": "src/repro/kernels/flash_attention.py:80",
            "flash_attention_sm90": "src/repro/kernels/flash_attention.py:80",
            "wkv6": "src/repro/kernels/wkv6.py:86",
            "rglru_scan": "src/repro/kernels/rglru_scan.py:56",
            "rmsnorm": "src/repro/kernels/rmsnorm.py:22"}
# model_forward's fp32 correctness run keeps this many layers (griffin:
# 2 periods of (R, R, A) plus the 2-layer tail, so the tail path runs)
MODEL_CUTS = {"rwkv6-3b": 4, "recurrentgemma-2b": 8}

# the tuner phase's programs: candidates, kernel tile variants and the
# execution classes left after dominance pruning, as the reference's tuner
# gives them on its numpy backend (derived and held equal to the port's by
# tests/test_torch_tuner.py::test_chip_tuner_constants_equal_reference).
# attn_step at qwen width has 9 flash tiles (every registry tile divides
# 4096), the gate's 128-token step 4
TUNER_EXPECT = {
    "table2_3mm_n2048": {"n_valid": 64, "n_kernel_variants": 1,
                         "n_classes": 5, "n_measured": 5},
    "attn_step_qwen": {"n_valid": 576, "n_kernel_variants": 9,
                       "n_classes": 63, "n_measured": 7},
    "gate_attn_step": {"n_valid": 256, "n_kernel_variants": 4,
                       "n_classes": 28, "n_measured": 0},
    "gate_fig4_advancedload": {"n_valid": 64, "n_kernel_variants": 1,
                               "n_classes": 3, "n_measured": 0},
    "gate_fig5_delegatestore": {"n_valid": 64, "n_kernel_variants": 1,
                                "n_classes": 2, "n_measured": 0},
    "gate_table2_3mm": {"n_valid": 64, "n_kernel_variants": 1,
                        "n_classes": 5, "n_measured": 0},
}
TUNE_REPS = 2           # timed executes per measured class (after 1 warm)
# attn_step's peak device bytes at its default shape (the walk of the
# registry's worksets; tests/golden/tuning_baseline.json)
ATTN_STEP_PEAK_BYTES = 61444.0

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
    """Median of ``reps`` warm calls, each timed with CUDA events.  A short
    spin on the stream (``torch.cuda._sleep``) precedes each call, so the
    host enqueues the call while the card is busy and the events read the
    device's time rather than the host's enqueue (a wrapper's Python takes
    tens of microseconds, as long as the smaller kernels themselves).  A
    plain version whose own host work outlasts the spin still shows it."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
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
    """Start one nvcc per kernel source, all at once, and wait for all."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import flash_attention, rglru_scan, rmsnorm, wkv6

    def build(make):
        t = time.perf_counter()
        lib = make()
        return lib._name, time.perf_counter() - t

    makes = {"flash_attention": flash_attention.build,
                "flash_attention_sm90": flash_attention.build_sm90,
                "wkv6": wkv6.build, "rglru_scan": rglru_scan.build,
                "rmsnorm": rmsnorm.build}
    t = time.perf_counter()
    with ThreadPoolExecutor(len(makes)) as pool:
        futures = {name: pool.submit(build, make)
                   for name, make in makes.items()}
        for name, fut in futures.items():
            library, seconds = fut.result()
            report("build", kernel=name, seconds=seconds, library=library)
    report("build", kernel="all", seconds=time.perf_counter() - t)


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


def _flash_rows(peaks: dict, model: str, B: int, S: int, cases,
                seed: int) -> dict:
    """flash attention at ``model``'s attention width, B = 1, S = T: for
    each (dtype, tol, window) in ``cases`` the kernel against its plain
    version on every registry tile, then the kernel's, the plain
    version's and scaled_dot_product_attention's times beside the bound.
    Returns the rows by (dtype name, window)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, variants

    cfg = get_config(model)
    K, G, D = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.d_head
    T = S
    rng = np.random.default_rng(seed)
    host = {"q": rng.standard_normal((B, S, K, G, D)).astype(np.float32),
            "k": rng.standard_normal((B, T, K, D)).astype(np.float32),
            "v": rng.standard_normal((B, T, K, D)).astype(np.float32)}
    shapes = [host[n].shape for n in ("q", "k", "v")]
    tiles = variants.variants_for("flash_attention", shapes)
    check(len(tiles) == 9, f"want all 9 registry tiles, got {len(tiles)}")
    rows = {}
    for dtype, tol, window in cases:
        q, k, v = (torch.from_numpy(host[n]).to("cuda", dtype)
                   for n in ("q", "k", "v"))
        qf, kf, vf = ops.fold_attention(q, k, v)
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
        route = fa.route(dtype, D)
        check(err <= tol, f"{model} flash {route} kernel vs plain {dtype} "
              f"window={window}: max abs err {err} > {tol}")
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
        row = {"route": route, "dtype": dname, "window": window, "tol": tol,
               "max_abs_err": err, "tiles": len(errs),
               "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "flops": flops, "bytes": nbytes}
        report("kernel_vs_plain", kernel="flash_attention", width=model,
               q=list(host["q"].shape), k=list(host["k"].shape), **row)
        rows[(dname, window)] = row
        del q, k, v, qf, kf, vf, want, out
        torch.cuda.empty_cache()
    return rows


def phase_kernel(peaks: dict) -> dict:
    """flash at qwen2.5-14b's attention width (fp32 and bf16, causal and
    window 1024) and at recurrentgemma-2b's (bf16 and fp32, window 2048,
    the model's own).  Returns the kernels line's rows: the fp32 causal one
    for the SIMT route, the bf16 causal qwen-width one for the sm90
    route."""
    import torch
    qwen = _flash_rows(peaks, "qwen2.5-14b", 1, 4096, [
        (dtype, tol, window)
        for dtype, tol in ((torch.float32, FP32_TOL),
                           (torch.bfloat16, BF16_TOL))
        for window in (0, 1024)], seed=0)
    griffin = _flash_rows(peaks, "recurrentgemma-2b", 1, 4096,
                          [(torch.bfloat16, BF16_TOL, 2048),
                           (torch.float32, FP32_TOL, 2048)], seed=5)
    check(qwen[("float32", 0)]["route"] == "simt"
          and qwen[("bfloat16", 0)]["route"] == "sm90"
          and griffin[("bfloat16", 2048)]["route"] == "sm90"
          and griffin[("float32", 2048)]["route"] == "simt",
          "flash routes: want fp32 on simt, bf16 at D = 128 and 256 on sm90")
    return {"flash_attention": qwen[("float32", 0)],
            "flash_attention_sm90": qwen[("bfloat16", 0)]}


def _close(got, want, tol: float):
    """Max abs error, and whether |got - want| <= tol * (1 + |want|)
    holds everywhere (the recurrences' outputs grow with the state)."""
    diff = (got.float() - want.float()).abs()
    scaled = (diff / (1.0 + want.float().abs())).max().item()
    return diff.max().item(), scaled <= tol


def _bound_ms(flops: float, nbytes: float, peak_flops: float, peaks: dict):
    ops_ms = flops / peak_flops * 1e3
    bytes_ms = nbytes / peaks["bytes"] * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes")


def phase_wkv6_kernel(peaks: dict) -> dict:
    """wkv6 at rwkv6-3b width: r, k, v, w (1, 4096, 40, 64), u (40, 64);
    fp32, and bf16 r/k/v/u (w stays fp32, as the model computes it)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, variants
    from repro_torch.kernels import wkv6 as wk

    cfg = get_config("rwkv6-3b")
    hs = cfg.rwkv_head_size
    B, T, H = 1, 4096, cfg.d_model // hs
    rng = np.random.default_rng(1)
    host = [rng.standard_normal((B, T, H, hs)).astype(np.float32)
            for _ in range(3)]
    host.append(rng.uniform(0.2, 0.99, (B, T, H, hs)).astype(np.float32))
    host.append(rng.standard_normal((H, hs)).astype(np.float32))
    tiles = variants.variants_for("wkv6", [x.shape for x in host])
    check(len(tiles) == 3, f"want all 3 registry tiles, got {len(tiles)}")

    def fold(t):
        return t.permute(0, 2, 1, 3).reshape(B * H, T, hs).contiguous()

    main = None
    for dtype in (torch.float32, torch.bfloat16):
        r, k, v, w, u = (torch.from_numpy(x).cuda() for x in host)
        r, k, v, u = (x.to(dtype) for x in (r, k, v, u))
        folded = [fold(x) for x in (r, k, v, w)] + [u.contiguous()]
        want_o, want_s = wk.wkv6_plain(*folded)
        errs = []
        for tile in tiles:
            o, s = ops.wkv6(r, k, v, w, u, **tile.kwargs())
            torch.cuda.synchronize()
            for got, want in ((fold(o), want_o), (s.reshape(B * H, hs, hs),
                                                  want_s)):
                err, ok = _close(got, want, WKV6_TOL)
                check(ok, f"wkv6 kernel vs plain {dtype} {tile.label}: "
                      f"max abs err {err} beyond {WKV6_TOL} x (1 + |want|)")
                errs.append(err)
        kernel_ms = time_ms(lambda: wk.wkv6_folded(*folded))
        plain_ms = time_ms(lambda: wk.wkv6_plain(*folded), reps=3, warm=1)
        item = r.element_size()
        flops = float(B * H * T * (5 * hs * hs + 5 * hs))
        nbytes = float(B * H * T * hs * (3 * item + 4 + 4)
                       + H * hs * item + B * H * hs * hs * 4)
        bound_ms, bound_by = _bound_ms(flops, nbytes, peaks["fp32"], peaks)
        dname = str(dtype).replace("torch.", "")
        row = {"dtype": dname, "tol": WKV6_TOL, "max_abs_err": max(errs),
               "tiles": len(tiles), "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "library_ms": None,
               "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
               "bytes": nbytes}
        report("kernel_vs_plain", kernel="wkv6", r=[B, T, H, hs],
               u=[H, hs], **row)
        if dtype is torch.float32:
            main = row
        del r, k, v, w, u, folded, want_o, want_s, o, s
        torch.cuda.empty_cache()
    # the same width with extreme decays (10% exactly 0, 10% 1e-30, 20%
    # 1.0), where a chunked form that subtracts prefix sums of log w
    # loses digits: the kernel against the sequential plain version
    w = host[3].copy()
    pick = rng.uniform(size=w.shape)
    w[pick < 0.1] = 0.0
    w[(pick >= 0.1) & (pick < 0.2)] = 1e-30
    w[(pick >= 0.2) & (pick < 0.4)] = 1.0
    folded = [fold(torch.from_numpy(x).cuda())
              for x in (*host[:3], w)] + [torch.from_numpy(host[4]).cuda()]
    want_o, want_s = wk.wkv6_plain(*folded)
    o, s = wk.wkv6_folded(*folded)
    torch.cuda.synchronize()
    errs = []
    for got, want in ((o, want_o), (s, want_s)):
        err, ok = _close(got, want, WKV6_TOL)
        check(ok, f"wkv6 kernel vs plain, extreme decays: max abs err {err} "
              f"beyond {WKV6_TOL} x (1 + |want|)")
        errs.append(err)
    report("kernel_vs_plain", kernel="wkv6", r=[B, T, H, hs], u=[H, hs],
           dtype="float32", decays="0 / 1e-30 / 1.0 among uniform(0.2, "
           "0.99)", tol=WKV6_TOL, max_abs_err=max(errs))
    main["max_abs_err"] = max(main["max_abs_err"], max(errs))
    return main


def phase_rglru_kernel(peaks: dict) -> dict:
    """rglru_scan at recurrentgemma-2b width: a, b (1, 4096, 2560) fp32, on
    every registry tile, once more at the extreme mix of a (exact 0, 1e-30
    and 1.0 among uniform(0.4, 0.999)), and at (2, 16384, 512), 16384 /
    Tc chunks a row, for a deep look-back."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, variants
    from repro_torch.kernels import rglru_scan as rg

    cfg = get_config("recurrentgemma-2b")
    B, T, D = 1, 4096, cfg.d_model
    rng = np.random.default_rng(2)

    def inputs(shape, extreme=False):
        a = rng.uniform(0.4, 0.999, shape).astype(np.float32)
        if extreme:
            pick = rng.uniform(size=shape)
            a[pick < 0.1] = 0.0
            a[(pick >= 0.1) & (pick < 0.2)] = 1e-30
            a[(pick >= 0.2) & (pick < 0.4)] = 1.0
        b = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()

    def checked(what, got, want):
        torch.cuda.synchronize()
        err, ok = _close(got, want, RGLRU_TOL)
        check(ok, f"rglru_scan kernel vs plain {what}: max abs err {err} "
              f"beyond {RGLRU_TOL} x (1 + |want|)")
        return err

    a, b = inputs((B, T, D))
    tiles = variants.variants_for("rglru_scan", [a.shape, b.shape])
    check(len(tiles) == 3, f"want all 3 registry tiles, got {len(tiles)}")
    want = rg.rglru_scan_plain(a, b)
    errs = [checked(tile.label, ops.rglru_scan(a, b, **tile.kwargs()), want)
            for tile in tiles]
    for shape, extreme, what in (((B, T, D), True, "extreme mix"),
                                 ((2, 16384, 512), False, "deep look-back")):
        x, y = inputs(shape, extreme)
        err = checked(what, rg.rglru_scan(x, y), rg.rglru_scan_plain(x, y))
        report("kernel_vs_plain", kernel="rglru_scan", a=list(shape),
               case=what, tol=RGLRU_TOL, max_abs_err=err)
        errs.append(err)
        del x, y
    flops, nbytes = 2.0 * B * T * D, 12.0 * B * T * D
    bound_ms, bound_by = _bound_ms(flops, nbytes, peaks["fp32"], peaks)
    kernel_ms = time_ms(lambda: rg.rglru_scan(a, b))
    plain_ms = time_ms(lambda: rg.rglru_scan_plain(a, b), reps=3, warm=1)
    row = {"dtype": "float32", "tol": RGLRU_TOL, "max_abs_err": max(errs),
           "tiles": len(tiles), "chunk": rg.CHUNK, "dtile": rg.DTILE,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
           "flops": flops, "bytes": nbytes}
    report("kernel_vs_plain", kernel="rglru_scan", a=[B, T, D], **row)
    return row


def phase_rmsnorm_kernel(peaks: dict) -> dict:
    """rmsnorm on x (4096, 2560), fp32 and bf16, with
    torch.nn.functional.rms_norm (never called by the port) timed beside
    it."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, variants
    from repro_torch.kernels import rmsnorm as rn

    N, D = 4096, 2560
    rng = np.random.default_rng(3)
    hx = rng.standard_normal((N, D)).astype(np.float32)
    hw = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    tiles = variants.variants_for("rmsnorm", [hx.shape, hw.shape])
    check(len(tiles) == 4, f"want all 4 registry tiles, got {len(tiles)}")
    main = None
    for dtype, tol in ((torch.float32, RMSNORM_TOL),
                       (torch.bfloat16, BF16_TOL)):
        x = torch.from_numpy(hx).to("cuda", dtype)
        w = torch.from_numpy(hw).to("cuda", dtype)
        want = rn.rmsnorm_plain(x, w)
        errs = []
        for tile in tiles:
            got = ops.rmsnorm(x, w, **tile.kwargs())
            torch.cuda.synchronize()
            err, ok = _close(got, want, tol)
            check(ok, f"rmsnorm kernel vs plain {dtype} {tile.label}: max "
                  f"abs err {err} beyond {tol} x (1 + |want|)")
            errs.append(err)
        kernel_ms = time_ms(lambda: rn.rmsnorm(x, w))
        plain_ms = time_ms(lambda: rn.rmsnorm_plain(x, w))
        library_ms = time_ms(lambda: F.rms_norm(x, (D,), w, eps=1e-6))
        item = x.element_size()
        flops, nbytes = 4.0 * N * D, float((2 * N * D + D) * item)
        bound_ms, bound_by = _bound_ms(flops, nbytes, peaks["fp32"], peaks)
        dname = str(dtype).replace("torch.", "")
        row = {"dtype": dname, "tol": tol, "max_abs_err": max(errs),
               "tiles": len(tiles), "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
               "bytes": nbytes}
        report("kernel_vs_plain", kernel="rmsnorm", x=[N, D], **row)
        if dtype is torch.float32:
            main = row
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


def phase_attn_step() -> dict:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import execute, plan, verify_plan
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.optim import attention_step_program

    cfg = get_config("qwen2.5-14b")
    K, G, D = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.d_head
    shapes = (1, 4096, 4096, K, G, D)
    prog = attention_step_program(2, shapes=shapes)
    pl = plan(prog)
    rep = verify_plan(pl)
    check(rep.ok and not rep.violations, rep.summary())

    _set_launch_counts(dict.fromkeys(_counters(), 0))  # the run starts
    results = {}
    for mode in ("interpreted", "compiled"):
        before = fa.launches_simt
        out, stats = execute(pl, mode=mode)
        check(fa.launches_simt - before == 2,
              f"attn_step {mode}: {fa.launches_simt - before} SIMT kernel "
              "launches, want 2 (one per step)")
        results[mode] = (out["final_loss"], stats)
    launches = _launch_counts()                        # ... and ends here
    check(launches["flash_attention_sm90"] == 0,
          "attn_step (fp32) launched the sm90 kernel")
    loss_i, s_i = results["interpreted"]
    loss_c, s_c = results["compiled"]
    check(np.array_equal(loss_i, loss_c),
          "attn_step: compiled final_loss != interpreted")
    check(s_i.transfer_counts() == s_c.transfer_counts(),
          "attn_step: transfer counts differ between modes")

    want = _attn_step_plain_loss(prog)
    rel = float(np.abs(loss_c - want).max() / np.abs(want).max())
    check(rel <= LOSS_RTOL, f"attn_step final_loss {loss_c} vs plain {want}:"
          f" rel err {rel} > {LOSS_RTOL}")
    report("attn_step", shapes=list(shapes), n_steps=2,
           verify=pl.meta["verify"], final_loss=float(loss_c[0]),
           plain_loss=float(want[0]), rel_err=rel, tol=LOSS_RTOL,
           kernel_launches=launches["flash_attention"],
           wall_ms_interpreted=s_i.wall_time * 1e3,
           wall_ms_compiled=s_c.wall_time * 1e3,
           compile_ms=s_c.compile_time * 1e3, **s_i.transfer_counts())
    return launches


def _attn_step_plain_loss(prog):
    """attn_step's final_loss by the plain version on the card: the last
    step's attention output, squared and summed, times the gain."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    o = fa.flash_attention_plain(*ops.fold_attention(
        *(torch.from_numpy(prog.inputs[n]).cuda() for n in "qkv")),
        causal=True)
    g = torch.from_numpy(prog.inputs["gain"] * np.float32(1.001)).cuda()
    want = ((o * o).sum().reshape(1) * g).cpu().numpy()
    del o
    torch.cuda.empty_cache()
    return want


def _counters() -> dict:
    """The main path's launch counters, by their name in the kernels line:
    (module, attribute).  Flash counts each route apart."""
    from repro_torch.kernels import flash_attention, rglru_scan, wkv6
    return {"wkv6": (wkv6, "launches"),
            "rglru_scan": (rglru_scan, "launches"),
            "flash_attention": (flash_attention, "launches_simt"),
            "flash_attention_sm90": (flash_attention, "launches_sm90")}


def _launch_counts() -> dict:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _counters().items()}


def _set_launch_counts(counts: dict) -> None:
    for name, (mod, attr) in _counters().items():
        setattr(mod, attr, counts[name])


def _expected_launches(cfg, dtype, n_forwards: int = 1) -> dict:
    """One launch per layer of the kernel's kind; attention layers go to
    the flash route that ``dtype`` and the head dim select."""
    from repro_torch.kernels import flash_attention as fa
    kinds = cfg.layer_kinds()
    attn = n_forwards * kinds.count("attn")
    sm90 = fa.route(dtype, cfg.d_head) == "sm90"
    return {"wkv6": n_forwards * kinds.count("rwkv"),
            "rglru_scan": n_forwards * kinds.count("rglru"),
            "flash_attention": 0 if sm90 else attn,
            "flash_attention_sm90": attn if sm90 else 0}


def _perturb_constants(params, generator, scale: float = 0.1) -> None:
    """Add seeded noise to every leaf the init sets to a constant (conv
    weights, lerp mixes, decays, gains), in place, so that every branch of
    the forward carries a signal (a zero conv makes the RG-LRU input 0)."""
    import torch
    for v in params.values():
        if isinstance(v, dict):
            _perturb_constants(v, generator, scale)
        elif bool((v == v.reshape(-1)[0]).all()):
            v.add_(scale * torch.randn(v.shape, generator=generator,
                                       device=v.device))


def phase_model_forward(name: str, cut_layers: int, reps: int = 3) -> dict:
    """Transformer.loss at full width, B = 1, S = 4096, with the port's
    own seeded weights: (a) fp32 at a cut depth, kernels vs the plain
    path; (b) bf16 at full depth, with kernels, timed.  Returns the
    kernels' launches over both runs."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Transformer

    full = get_config(name)
    B, S = 1, 4096
    gen = torch.Generator("cuda").manual_seed(0)
    batch = {k: torch.randint(0, full.vocab, (B, S), generator=gen,
                              device="cuda") for k in ("tokens", "labels")}

    # (a) correctness: fp32, cut depth, kernels vs the plain path
    cfg = dataclasses.replace(full, n_layers=cut_layers, dtype="float32")
    params = Transformer(cfg).init(gen)
    _perturb_constants(params, gen)
    kernels, plain = (Transformer(cfg, use_pallas=p) for p in (True, False))
    _set_launch_counts(dict.fromkeys(_counters(), 0))       # run starts
    t = time.perf_counter()
    loss_k, _ = kernels.loss(params, batch)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t
    counts_a = _launch_counts()
    t = time.perf_counter()
    loss_p, _ = plain.loss(params, batch)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    check(_launch_counts() == counts_a, "the plain path launched a kernel")
    want_a = _expected_launches(cfg, torch.float32)
    check(counts_a == want_a, f"{name} fp32: launches {counts_a}, want "
          f"{want_a}")
    loss_k, loss_p = float(loss_k), float(loss_p)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    check(math.isfinite(loss_k) and rel <= FORWARD_RTOL,
          f"{name} fp32 loss with kernels {loss_k} vs plain {loss_p}: rel "
          f"err {rel} > {FORWARD_RTOL}")
    # the loss of random weights barely moves with the hidden states, so
    # the states the head reads are held against each other too (these
    # two calls are comparisons: their launches are not counted)
    before = _launch_counts()
    h_k, h_p = kernels.hidden(params, batch), plain.hidden(params, batch)
    _set_launch_counts(before)
    h_rel = ((h_k - h_p).abs().max() / h_p.abs().max()).item()
    check(h_k.shape == (B, S, cfg.d_model) and math.isfinite(h_rel)
          and h_rel <= FORWARD_RTOL,
          f"{name} fp32 hidden states with kernels vs plain: max abs err "
          f"{h_rel} of their scale > {FORWARD_RTOL}")
    report("model_forward", model=name, run="fp32_cut_depth",
           n_layers=cut_layers, batch=B, seq=S, loss_kernels=loss_k,
           loss_plain=loss_p, rel_err=rel, hidden_rel_err=h_rel,
           tol=FORWARD_RTOL, launches=counts_a, wall_s_kernels=kernel_s,
           wall_s_plain=plain_s)
    del h_k, h_p
    del params
    torch.cuda.empty_cache()
    if "attn" in cfg.layer_kinds():
        counts_a = {k: counts_a[k] + v for k, v in
                    _bf16_cut_depth(name, cfg, gen, batch).items()}

    # (b) timed: bf16, full depth, with kernels
    params = Transformer(full).init(gen, dtype=torch.bfloat16)
    n_params = sum(_leaf_sizes(params))
    model = Transformer(full, use_pallas=True)
    torch.cuda.reset_peak_memory_stats()
    before = _launch_counts()
    loss_b, _ = model.loss(params, batch)                   # warm-up
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        loss_b, _ = model.loss(params, batch)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    rows, busy_ms = _profile(lambda: model.loss(params, batch))
    counts_b = {k: v - before[k] for k, v in _launch_counts().items()}
    want_b = _expected_launches(full, torch.bfloat16, reps + 2)
    check(counts_b == want_b, f"{name} bf16: launches {counts_b}, want "
          f"{want_b}")
    # the profiled forward's own flash kernels, by name: one sm90 launch
    # per attention layer, no SIMT launch
    n_attn = full.layer_kinds().count("attn")
    flash = {kernel: [r for r in rows or () if kernel + "<" in r[0]]
             for kernel in ("flash_fwd_sm90_kernel", "flash_fwd_kernel")}
    seen = {kernel: sum(r[2] for r in rs) for kernel, rs in flash.items()}
    check(rows is not None and seen == {"flash_fwd_sm90_kernel": n_attn,
                                        "flash_fwd_kernel": 0},
          f"{name} bf16 profile: flash kernels {seen}, want {n_attn} sm90 "
          "and no SIMT launch")
    # ... and its rglru_scan kernels: one launch per recurrent layer
    n_rglru = full.layer_kinds().count("rglru")
    rglru = [r for r in rows or () if "rglru_scan_kernel<" in r[0]]
    rglru_seen = sum(r[2] for r in rglru)
    check(rows is not None and rglru_seen == n_rglru,
          f"{name} bf16 profile: {rglru_seen} rglru_scan launches, want "
          f"{n_rglru}")
    loss_b = float(loss_b)
    check(math.isfinite(loss_b), f"{name} bf16 loss is {loss_b}")
    wall_ms = sorted(times)[len(times) // 2]
    report("model_forward", model=name, run="bf16_full_depth",
           n_layers=full.n_layers, batch=B, seq=S, params=n_params,
           loss=loss_b, wall_ms=wall_ms, wall_ms_all=times,
           tokens_per_s=B * S / wall_ms * 1e3,
           peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
           launches_per_forward=_expected_launches(full, torch.bfloat16),
           profiled_flash_launches=seen,
           profiled_flash_ms={k: sum(r[1] for r in rs)
                              for k, rs in flash.items()},
           profiled_rglru_launches=rglru_seen,
           profiled_rglru_ms=sum(r[1] for r in rglru),
           device_busy_ms=busy_ms,
           device_busy_share=None if busy_ms is None else busy_ms / wall_ms,
           top_device_ms=None if rows is None else rows[:8])
    del params
    torch.cuda.empty_cache()
    return {k: counts_a[k] + counts_b[k] for k in counts_a}


def _bf16_cut_depth(name: str, cfg, gen, batch) -> dict:
    """model_forward (a) in bf16: the cut-depth model with kernels (flash
    on its sm90 route) against the plain path, loss and final hidden
    states.  Returns the launches of the loss with kernels."""
    import torch

    from repro_torch.models import Transformer
    params = Transformer(cfg).init(gen, dtype=torch.bfloat16)
    _perturb_constants(params, gen)
    kernels, plain = (Transformer(cfg, use_pallas=p) for p in (True, False))
    before = _launch_counts()
    loss_k, _ = kernels.loss(params, batch)
    torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in _launch_counts().items()}
    want = _expected_launches(cfg, torch.bfloat16)
    check(counts == want, f"{name} bf16 cut depth: launches {counts}, want "
          f"{want}")
    loss_p, _ = plain.loss(params, batch)
    loss_k, loss_p = float(loss_k), float(loss_p)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    # comparisons: their launches are not counted.  The plain path on the
    # same weights in fp32 says how far bf16 itself moves the states
    before = _launch_counts()
    h_k, h_p = kernels.hidden(params, batch), plain.hidden(params, batch)
    h_32 = plain.hidden(_tree_float(params), batch)
    _set_launch_counts(before)
    h_k, h_p = h_k.float(), h_p.float()
    h_rel = ((h_k - h_p).norm() / h_p.norm()).item()
    check(math.isfinite(loss_k) and h_k.shape == h_p.shape
          and math.isfinite(h_rel) and h_rel <= FORWARD_BF16_TOL,
          f"{name} bf16 hidden states with kernels vs plain: normwise err "
          f"{h_rel} > {FORWARD_BF16_TOL}")
    report("model_forward", model=name, run="bf16_cut_depth",
           n_layers=cfg.n_layers, loss_kernels=loss_k, loss_plain=loss_p,
           rel_err=rel, hidden_rel_err=h_rel, tol=FORWARD_BF16_TOL,
           hidden_max_abs_err_of_max=((h_k - h_p).abs().max()
                                      / h_p.abs().max()).item(),
           plain_bf16_vs_fp32=((h_p - h_32).norm() / h_32.norm()).item(),
           launches=counts)
    del params, h_k, h_p, h_32
    torch.cuda.empty_cache()
    return counts


def _tree_float(v):
    return {k: _tree_float(x) for k, x in v.items()} if isinstance(v, dict) \
        else v.float()


def _profile(fn):
    """One call of fn under torch.profiler: its kernels by device time, as
    [[name, ms, calls], ...] largest first, and their device time in all,
    in ms.  (None, None) where the profiler sees no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        # device-side events only: a CPU op also reports its kernels'
        # time, which would count each kernel twice
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            rows.append([e.key[:90], e.self_device_time_total / 1e3,
                         e.count])
    if not rows:
        return None, None
    rows.sort(key=lambda r: -r[1])
    return rows, sum(r[1] for r in rows)


def _leaf_sizes(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaf_sizes(v)
        else:
            yield v.numel()


def phase_rmsnorm_path() -> int:
    """rmsnorm's entry point, ops.rmsnorm, on (1, 4096, 2560) activations
    in fp32 and bf16 with its default tile: the reference's only way to
    reach the kernel (no model calls it)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rn

    gen = torch.Generator("cuda").manual_seed(4)
    x = torch.randn((1, 4096, 2560), generator=gen, device="cuda")
    w = 1.0 + 0.1 * torch.randn((2560,), generator=gen, device="cuda")
    rn.launches = 0            # the path's run starts here
    outs = {dt: ops.rmsnorm(x.to(dt), w.to(dt))
            for dt in (torch.float32, torch.bfloat16)}
    torch.cuda.synchronize()
    launches = rn.launches     # ... and ends here
    check(launches == 2, f"rmsnorm path: {launches} launches, want 2")
    errs = {}
    for dt, out in outs.items():
        tol = RMSNORM_TOL if dt is torch.float32 else BF16_TOL
        want = rn.rmsnorm_plain(x.to(dt).reshape(-1, 2560), w.to(dt))
        err, ok = _close(out.reshape(-1, 2560), want, tol)
        check(out.shape == x.shape and out.dtype == dt and ok,
              f"rmsnorm path {dt}: shape {tuple(out.shape)}, max abs err "
              f"{err} beyond {tol} x (1 + |want|)")
        errs[str(dt).replace("torch.", "")] = err
    report("rmsnorm_path", x=list(x.shape), launches=launches,
           max_abs_err=errs)
    return launches


def _tune_checked(name: str, prog, be, tc, **kw):
    """tune(prog) on ``be`` with cache ``tc``, checked against
    TUNER_EXPECT[name]; returns the winner and the table's counts."""
    from repro_torch.core import tune
    pl = tune(prog, backend=be, cache=tc, **kw)
    tuning = pl.meta["tuning"]
    valid = [c for c in tuning["candidates"] if c["valid"]]
    survivors = [c for c in valid if c["alias_of"] is None]
    counts = {"n_valid": len(valid),
              "n_kernel_variants": len({json.dumps(
                  c["config"]["kernel_variants"]) for c in valid}),
              "n_classes": len(survivors),
              "n_measured": pl.meta["tuning_cache"]["measurements"]}
    check(counts == TUNER_EXPECT[name],
          f"tuner {name}: {counts}, want {TUNER_EXPECT[name]}")
    check(pl.meta["verify"]["ok"], f"tuner {name}: the winner does not "
          f"verify: {pl.meta['verify']}")
    return pl, counts


def _tuner_line(name: str, pl, counts: dict, seconds: float, **extra):
    """One program's line: the choice, per-objective winners, the top 5
    candidates by predicted cost, and the calibration's verdict."""
    tuning = pl.meta["tuning"]
    cal = tuning.get("calibration") or {}
    top = sorted((c for c in tuning["candidates"] if c["valid"]),
                 key=lambda c: c["rank"])[:5]
    report("tuner", program=name, chosen=tuning["chosen"],
           winners=tuning["winners"], **counts,
           top5=[{"label": c["label"], "predicted_s": c["predicted_s"],
                  "measured_s": c["measured_s"],
                  "measured_kernel_s": c.get("measured_kernel_s")}
                 for c in top],
           rank_corr_before=cal.get("rank_corr_before"),
           rank_corr_after=cal.get("rank_corr_after"),
           calibration_accepted=cal.get("accepted"),
           fitted=cal.get("fitted"),
           seconds=seconds, **extra)


def _check_measured(name: str, pl, be, tc, reps: int) -> None:
    """Every measured row's kernel time in (0, wall time], and a second
    tune answered from the cache: no measurement, the same table."""
    from repro_torch.core import tune
    tuning = pl.meta["tuning"]
    rows = [c for c in tuning["candidates"]
            if c["valid"] and c["alias_of"] is None]
    ran = [c for c in rows if "measured_as" not in c]
    check(pl.meta["tuning_cache"]["measurements"] == len(ran),
          f"tuner {name}: {pl.meta['tuning_cache']['measurements']} "
          f"measurements for {len(ran)} measured classes")
    for c in rows:
        check(0 < c["measured_kernel_s"] <= c["measured_s"],
              f"tuner {name} {c['label']}: kernel {c['measured_kernel_s']} "
              f"s outside (0, wall {c['measured_s']} s]")
    again = tune(pl.program, backend=be, cache=tc, reps=reps)
    info = again.meta["tuning_cache"]
    check(info["hit"] and info["measurements"] == 0,
          f"tuner {name}: second tune {info}, want a hit, 0 measurements")
    check(json.dumps(again.meta["tuning"], sort_keys=True)
          == json.dumps(tuning, sort_keys=True),
          f"tuner {name}: the cached table differs from the measured one")


def phase_tuner() -> int:
    """The plan-space tuner on the card (see the module docstring, 8).
    Returns flash's SIMT launches in the phase: the tuner's measurements
    of attn_step and its winner's execute."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import (TorchDeviceBackend, TuneCache, execute,
                                  run_host_oracle, tune, winner_exec_kwargs)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.optim import attention_step_program
    from repro_torch.polybench import build_3mm

    sys.path.insert(0, str(Path(__file__).resolve().parent / "benchmarks"))
    import port_check_tuning_baseline as gate

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    t_phase = time.perf_counter()
    be = TorchDeviceBackend("cuda")
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_tunecache-")
    tc = TuneCache(cache_dir)
    try:
        # (a) 3mm at n = 2048, measured
        t = time.perf_counter()
        p3, _ = build_3mm(n=2048)
        pl, counts = _tune_checked("table2_3mm_n2048", p3, be, tc,
                                   reps=TUNE_REPS)
        seconds = time.perf_counter() - t
        _check_measured("table2_3mm_n2048", pl, be, tc, TUNE_REPS)
        out, _ = execute(pl, **winner_exec_kwargs(pl, be))
        oracle = run_host_oracle(p3)
        err = float(np.abs(out["out"] - oracle["out"]).max()
                    / np.abs(oracle["out"]).max())
        check(err <= POLY_RTOL, f"tuner 3mm winner off the host oracle by "
              f"{err} of its scale > {POLY_RTOL}")
        _tuner_line("table2_3mm_n2048", pl, counts, seconds,
                    normwise_err=err, tol=POLY_RTOL)

        # (b) attn_step at qwen2.5-14b's attention width, measured
        cfg = get_config("qwen2.5-14b")
        shapes = (1, 4096, 4096, cfg.n_kv_heads,
                  cfg.n_heads // cfg.n_kv_heads, cfg.d_head)
        pa = attention_step_program(2, shapes=shapes)
        t = time.perf_counter()
        _set_launch_counts(dict.fromkeys(_counters(), 0))  # the run starts
        pl, counts = _tune_checked("attn_step_qwen", pa, be, tc,
                                   reps=TUNE_REPS)
        tuned = fa.launches_simt
        want = counts["n_measured"] * (1 + TUNE_REPS) * 2
        check(tuned == want, f"tuner attn_step: {tuned} SIMT launches, "
              f"want {want} ((1 + {TUNE_REPS}) x 2 steps a measured class)")
        seconds = time.perf_counter() - t
        out, _ = execute(pl, **winner_exec_kwargs(pl, be))
        launches = _launch_counts()                        # ... and ends
        check(launches["flash_attention"] == tuned + 2
              and launches["flash_attention_sm90"] == 0,
              f"tuner attn_step winner: launches {launches}")
        _check_measured("attn_step_qwen", pl, be, tc, TUNE_REPS)
        want = _attn_step_plain_loss(pa)
        rel = float(np.abs(out["final_loss"] - want).max()
                    / np.abs(want).max())
        check(rel <= LOSS_RTOL, f"tuner attn_step winner loss "
              f"{out['final_loss']} vs plain {want}: rel err {rel}")
        _tuner_line("attn_step_qwen", pl, counts, seconds, shapes=shapes,
                    rel_err=rel, tol=LOSS_RTOL,
                    flash_launches=launches["flash_attention"])

        # (c) the gate programs, unmeasured, against the port's golden
        golden = json.loads(gate.PORT_BASELINE_PATH.read_text())["programs"]
        for name, prog in sorted(gate.gate_programs().items()):
            t = time.perf_counter()
            pl, counts = _tune_checked(f"gate_{name}", prog, be, tc,
                                       measure=False, use_calibration=False)
            row = gate.baseline_row(pl)
            for key in ("predicted_winner", "winners", "n_pareto"):
                check(row[key] == golden[name][key],
                      f"tuner gate {name}: {key} {row[key]}, golden "
                      f"{golden[name][key]}")
            if name == "attn_step":
                check(row["peak_bytes"] == ATTN_STEP_PEAK_BYTES,
                      f"tuner gate attn_step: peak_bytes "
                      f"{row['peak_bytes']}, want {ATTN_STEP_PEAK_BYTES}")
            _tuner_line(f"gate_{name}", pl, counts,
                        time.perf_counter() - t,
                        predicted_s=row["predicted_s"],
                        energy_j=row["energy_j"],
                        peak_bytes=row["peak_bytes"])
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    now = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    check(now == tf32, f"tuner: TF32 flags {tf32} became {now}")
    report("tuner", program="all", seconds=time.perf_counter() - t_phase,
           tf32=list(now))
    return launches["flash_attention"]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    smi = phase_environment()
    peaks = card_peaks(torch.cuda.get_device_name(0))
    phase_build()
    rows = {**phase_kernel(peaks),
            "wkv6": phase_wkv6_kernel(peaks),
            "rglru_scan": phase_rglru_kernel(peaks),
            "rmsnorm": phase_rmsnorm_kernel(peaks)}
    phase_polybench()
    launches = phase_attn_step()
    for name, cut in MODEL_CUTS.items():
        for kernel, n in phase_model_forward(name, cut).items():
            launches[kernel] += n
    launches["rmsnorm"] = phase_rmsnorm_path()
    launches["flash_attention"] += phase_tuner()
    for name in rows:
        check(launches[name] > 0, f"the main path never launched {name}")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": REPLACES[name], "launches": launches[name],
        "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"]}
        for name, row in rows.items()]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
