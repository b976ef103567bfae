#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    PYTHONPATH=src python3 chip_smoke.py

Drives the port's main path through its public entry points and checks it:

1. environment: torch, CUDA, nvcc, triton, and the card with its power limit;
2. build: compiles the six CUDA kernel sources of the repo, one
   ``nvcc`` per source, all started together, each with its build time;
3. kernel vs plain: each kernel against its plain PyTorch version on every
   registry tile, with the kernel's, the plain version's and (where one
   exists) one PyTorch call's time beside the card's bound:
   flash attention at qwen2.5-14b's attention width (q (1,4096,8,5,128),
   k and v (1,4096,8,128)), causal and window=1024, fp32 (the SIMT route)
   and bf16 (the sm90 tensor-core route), and at recurrentgemma-2b's
   (q (1,4096,1,10,256), k and v (1,4096,1,256), bf16 and fp32, window
   2048), beside scaled_dot_product_attention, and in bf16 (causal) at
   the GQA group sizes of the model zoo: musicgen-large (q (1,4096,32,1,
   64)), qwen3-moe-30b-a3b ((1,4096,4,8,128)) and arctic-480b
   ((1,4096,8,7,128), where a 128-row block straddles a query position);
   wkv6 at rwkv6-3b's width
   (r, k, v, w (1,4096,40,64), u (40,64)), fp32 and bf16 r/k/v/u, and
   once more in fp32 with decays of exactly 0, 1e-30 and 1.0 among them;
   rglru_scan at
   recurrentgemma-2b's width (a, b (1,4096,2560) fp32), once more with
   exact zeros, 1e-30 and 1.0 among the decays, at (2,16384,512) for a
   deep look-back, with its (Tc, Dc) tile reported; rmsnorm on
   x (4096,2560), fp32 and bf16, beside torch.nn.functional.rms_norm;
   flash's sm90 backward at internlm2-20b's train-4k call (BK 8, S 4096,
   G 6, D 128) and at D = 64, G 1 against the plain fp32 backward, beside
   the blockwise recompute and scaled_dot_product_attention's backward;
   AdamW's ``adamw_leaf`` and ``square_sum`` at internlm2-20b's train-4k
   leaves (the bf16 ``embed`` (92544, 6144), one layer's (6144, 16384)
   MLP matrix and the cell's leaf of six of them) against the plain slice
   loop and slice sum, bitwise for the update.  The PyTorch calls are
   yardsticks the port never calls;
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
   (c) the rest of the zoo in bf16, B = 1, at published widths cut in
   depth only, kernels against the plain path (final hidden states held
   normwise at ``FORWARD_BF16_TOL``, one flash launch per attention
   layer), each with its parameter count and peak device memory (see
   ``ZOO_FORWARD``): qwen3-moe-30b-a3b (MoE, 8 of 48 layers, S = 4096,
   also timed and profiled: expert products, dispatch, flash, other
   GEMMs), arctic-480b (MoE with its dense branch, 1 of 35, S = 2048),
   musicgen-large (embeds in, four codebook heads, all 48 layers), and
   internlm2-20b, command-r-35b, nemotron-4-15b and chameleon-34b (2
   layers each, S = 4096);
7. serve: the serving path (``repro_torch.serve``: ``ServeRuntime``,
   ``Engine``) at full width with the port's seeded weights, uploaded
   through ``DeviceResidency``.  (a) Exactness, fp32, TF32 off: rwkv6-3b
   (4 of 32 layers), qwen2.5-14b (2 of 48; once more with an int8 KV
   pool), recurrentgemma-2b (8 of 26, with one more request of a
   2048-token prompt and 16 new tokens, so its 2048-slot ring wraps),
   qwen3-moe-30b-a3b (2 of 48) and musicgen-large (2 of 48: embeds
   prompts, zero embeds a step, codebook 0 sampled) serve ``make_trace``
   (seed 0, 16 requests, capacity 4); every
   request's tokens must equal its standalone greedy decode (prefill at
   batch 1, no padding, then decode_step) or differ first where that
   decode's top two logits lie within ``SERVE_TIE`` of the largest
   |logit|.  The MoE run lifts the capacity factor to n_experts / top_k
   (C >= T): at the published 1.25 the engine's padded prefill buckets and
   idle decode rows compete for capacity that a standalone decode at
   batch 1 does not share, so the two may rightly drop different tokens.
   (b) Timed, bf16: rwkv6-3b at full depth and qwen2.5-14b at
   8 of 48 layers serve ``benchmarks/port_serve_bench.py``'s trace (48
   requests, capacity 8, max_seq 128) after its warm-up, continuous and
   static, with its checks (all finish, no drop or leak, the pool never
   reallocates, warm runs measure no bucket); the weights' h2d bytes
   must equal the params', a second runtime on the same bucket cache
   must measure nothing, and the decode step is timed (CUDA events) and
   profiled.  No kernel counter may move in the phase: the reference's
   serving path launches no Pallas kernel;
8. train: qwen2.5-14b at full width (d 5120, 40 query and 8 KV heads, D
   128, vocab 152064), B = 1, S = 4096, batches from ``SyntheticLM``, the
   port's seeded weights: (a) fp32, 2 of 48 layers, TF32 off,
   ``build_cell``'s train function with kernels (flash's SIMT route, run
   in the forward and again in each layer's recompute) against the plain
   path: the loss within 1e-4 relative, every gradient leaf within 1e-3
   normwise, two SIMT launches per layer a step, and on both sides
   AdamW's ``adamw_leaf`` and ``square_sum`` once a leaf; (b) bf16, 4 of 48
   layers, flash's sm90 route, AdamW, ``PrefetchIterator``: one warm
   step, three timed with CUDA events (median step ms, tokens/s, peak
   memory), one under torch.profiler (busy share; flash's forward, its
   sm90 backward, the other GEMMs, the optimizer update), eight sm90
   forward and four sm90 backward launches a step, ``adamw_leaf`` and
   ``square_sum`` once a leaf a step, finite losses; (c) bf16, 2 of 48
   layers, the model's plain path, two steps of
   ``offloaded_optimizer(adamw())`` against ``adamw()`` from the same
   start: params bitwise equal, the state in pinned host memory, each
   run's device peak, the host's MemTotal, ``square_sum`` once a leaf a
   step in both and ``adamw_leaf`` once a leaf on the card, once a piece
   of at most ``CHUNK`` elements offloaded;
9. rmsnorm_path: rmsnorm's entry point ``ops.rmsnorm`` on (1,4096,2560)
   activations, fp32 and bf16, with its launch count read around it (no
   model calls rmsnorm, as in the reference);
10. tuner: the plan-space tuner (``tune``, what ``plan(p, policy="auto")``
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
   TF32 must be as the phase found it;
11. mesh: the sharded entry points on one card, through DTensor and
   NCCL: a world-size-1 NCCL group (``launch.mesh.init_process_group``,
   a file rendezvous) and a 1×1 ("data", "model") ``DeviceMesh``
   (``launch.mesh.make_mesh``), destroyed at the end of the phase.
   (a) 3mm at n = 2048 through ``plan(policy="auto")`` on
   ``MeshBackend`` (placements replicate / fsdp / tp): the winner
   verifies, executes onto the host oracle, the fingerprint carries
   ``meshdata1xmodel1``, a second plan hits the cache with 0
   measurements; (b) attn_step at qwen2.5-14b's attention width tuned and
   executed on ``MeshBackend`` (the kernel block's inputs made whole,
   then flash's SIMT kernel), the loss within 1e-4 of the plain one;
   (c) ``build_cell(qwen2.5-14b, train, mesh=1×1, use_pallas=True)`` at
   full width, fp32, 2 of 48 layers, against the unmeshed cell from the
   same weights: the loss within 1e-5 relative, every gradient leaf
   within 1e-4 normwise, two flash launches per layer and AdamW's two
   kernels once a leaf in each cell, the collectives of a meshed step
   counted; then bf16 steps of 4 layers
   timed unmeshed, meshed and unmeshed again (the DTensor overhead is
   reported, not gated), the meshed first step counted (flash's sm90
   forward twice per layer, its sm90 backward once, AdamW's two kernels
   once a leaf, nothing else), its loss within 1e-5 of the
   unmeshed one and its gradients within MESH_BF16_GRAD_TOL leaf by
   leaf, the drift of later losses reported beside that of a run with
   the plain attention; (d) rwkv6-3b and recurrentgemma-2b fp32 forwards
   at full width cut to 4 layers on the mesh, each kernel on its rank's
   shard under ``local_map``: hidden within 1e-4 of the unmeshed port's
   with kernels, one launch per layer of each kernel's kind; then one
   fp32 train step of each at full width, 2 layers (recurrentgemma-2b:
   3, one (R, R, A) period), B = 1, S = 512, with a policy (each param
   placed where it meets its activation), against the unmeshed step:
   loss within 1e-5 relative, every gradient leaf within 1e-4 normwise,
   through the plain scans (no kernel launch); and ``rms_norm`` and the
   cross-entropy on a last dim split over the one-rank "model" axis,
   their sums as NCCL all-reduces, against the plain functions within
   1e-5; (e)
   offload_mesh: ``build_cell(qwen2.5-14b, train, mesh=1×1,
   use_pallas=True)`` at full width, bf16, 2 of 48 layers, B = 1,
   S = 4096, two Adafactor steps with the state on the card and two with
   ``offload_opt=True`` (each rank's state shards pinned ``PinnedShard``s,
   the update streamed piece by piece, Adafactor's pieces as DTensors)
   from the same params and batch: params and state bitwise equal, the
   offloaded state pinned, flash's sm90 forward twice per layer a step in
   the offloaded run (the forward and its recompute), its sm90 backward
   once, and nothing else,
   each run's peak and step ms; then that state saved by ``CheckpointManager``
   and restored by its offload shardings, bitwise and pinned; (f)
   moe_mesh: qwen3-moe-30b-a3b at full width, bf16, 2 of 48 layers,
   B = 1, S = 4096, ``loss`` with kernels through the MoE layer on the
   mesh (``moe_apply`` with its policy: the dispatch buffer and the
   expert products at the ``moe_buf`` / ``moe_hidden`` placements, the
   routing on the gathered tokens) against the unmeshed loss, within
   FORWARD_BF16_TOL; flash's sm90 kernel once per layer; its ms and the
   device peak.  The 1×1 mesh makes every shard whole, so this proves
   the code path on the card, not a placement;
12. paper_tables: ``benchmarks/port_run.py``'s rows on the card (Table 2,
   Figs. 4–6, train_overlap) at the reference's default sizes, one JSON
   line per row; every Fig. 6 row moves no more with the optimized plan
   than with the naive one, and the train row's final loss is finite;
13. trajectory: ``benchmarks/port_directive_micro.py --tune --quick``
   twice into a temporary directory (two dated ``BENCH_port_*``
   snapshots, each run on a fresh tune cache), then
   ``benchmarks/port_trajectory.py`` over them: two snapshots found and
   no coverage regression; measured regressions and notes printed, not
   gated (two runs on one card differ by noise).

Each kernel's ``launches`` in the kernels line sums the paths that ran it:
attn_step, model_forward, train (a), tuner, mesh and trajectory (the
attn_step gate program's tuning) for flash's SIMT route
(``flash_attention``), model_forward (the zoo's runs included), train
(b), mesh (c)'s bf16 step, mesh (e)'s offloaded step and mesh (f)'s
forward for its sm90 route (``flash_attention_sm90``), train (b), mesh
(c)'s bf16 step and mesh (e)'s offloaded step for the sm90 backward
(``flash_attention_bwd_sm90``, in ``flash_attention_sm90.cu``), wkv6 and
rglru_scan (model_forward and mesh), rmsnorm_path for rmsnorm, train (a)
with kernels, train (b) and mesh (c) (the meshed cells) for AdamW's
``adamw_leaf`` and ``square_sum`` (in ``adamw.cu``); comparison launches
are not counted.
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
import tempfile
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

# train (a): fp32, kernels against the plain path from the same weights:
# the loss relative, each gradient leaf normwise (||Δ|| / ||plain||)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
# train: qwen2.5-14b at full width, B = 1, S = 4096, cut to these depths
# (its params, gradients and fp32 AdamW state fit one 80 GB card)
TRAIN_MODEL = "qwen2.5-14b"
TRAIN_SEQ = 4096
TRAIN_CUT_LAYERS = 2        # (a) fp32 kernel vs plain; (c) offload, bf16
TRAIN_TIMED_LAYERS = 4      # (b) bf16, timed and profiled
TRAIN_TIMED_STEPS = 3       # (b) after one warm step
# mesh (c): the meshed train cell against the unmeshed one, fp32: the loss
# relative and each gradient leaf normwise; (d): the meshed forward's final
# hidden states normwise against the unmeshed port's, both with kernels,
# at this depth, for these archs
MESH_LOSS_RTOL = 1e-5
MESH_GRAD_TOL = 1e-4
MESH_HIDDEN_TOL = 1e-4
MESH_FORWARD_LAYERS = 4
MESH_FORWARD = ("rwkv6-3b", "recurrentgemma-2b")
# mesh (d): then one fp32 train step of each of MESH_FORWARD at these
# depths (griffin's 3: one whole (R, R, A) period; at 2 its period stack
# would be empty) and this sequence (B = 1), meshed against unmeshed,
# within MESH_LOSS_RTOL and MESH_GRAD_TOL; and the norm's and the
# cross-entropy's sums over a split dim as NCCL all-reduces, against the
# plain ones within MESH_SUM_TOL
MESH_TRAIN_LAYERS = {"rwkv6-3b": 2, "recurrentgemma-2b": 3}
MESH_TRAIN_SEQ = 512
MESH_SUM_TOL = 1e-5
MESH_TIMED_STEPS = 3        # (c) timed, after one warm step, per run
MESH_MOE = "qwen3-moe-30b-a3b"   # (f) the MoE layer on the mesh
MESH_MOE_LAYERS = 2
# mesh (c), bf16: the first step's gradient leaves meshed vs unmeshed,
# normwise (the meshed cross-entropy takes its gold logit by a one-hot and
# its log-sum-exp by hand: fp32 rounding apart, which bf16 rounding of the
# backward widens to about two bf16 steps, 7.9e-3, on an H100)
MESH_BF16_GRAD_TOL = 2e-2
OFFLOAD_MESH_STEPS = 2       # offload_mesh: steps a run, the first warms

# time_ms's spin before each timed call: about a millisecond of SM cycles
HOLD_CYCLES = 2_000_000

# the TPU kernel each CUDA kernel replaces
REPLACES = {"flash_attention": "src/repro/kernels/flash_attention.py:80",
            "flash_attention_sm90": "src/repro/kernels/flash_attention.py:80",
            "flash_attention_bwd_sm90": "src/repro/kernels/ops.py:49",
            "wkv6": "src/repro/kernels/wkv6.py:86",
            "rglru_scan": "src/repro/kernels/rglru_scan.py:56",
            "rmsnorm": "src/repro/kernels/rmsnorm.py:22",
            # no TPU kernel: the reference's update is plain jnp
            "adamw_leaf": "src/repro/optim/adamw.py",
            "square_sum": "src/repro/optim/adamw.py"}
# a kernel's source under csrc/, where it is not named after the kernel
SOURCES = {"flash_attention_bwd_sm90": "flash_attention_sm90",
           "adamw_leaf": "adamw", "square_sum": "adamw"}
# adamw: internlm2-20b's train-4k leaves in bf16: the embedding, one
# layer's MLP matrix, and the cell's leaf of them (its 6 layers stacked)
ADAMW_LEAVES = {"embed": (92544, 6144), "mlp": (6144, 16384),
                "mlp_stack": (6, 6144, 16384)}
# serve (a): the fp32 exactness runs' depth, and the one tolerance on the
# tokens: a request may differ from its standalone decode only where that
# decode's top two logits lie within SERVE_TIE x max|logit| of each other
SERVE_EXACT_CUTS = {"rwkv6-3b": 4, "qwen2.5-14b": 2, "recurrentgemma-2b": 8,
                    "qwen3-moe-30b-a3b": 2, "musicgen-large": 2}
SERVE_TIE = 1e-5
# serve (b): the timed bf16 runs' depth (qwen2.5-14b cut to fit 3.76 B
# params, 7.5 GB, beside rwkv6-3b's 3.09 B)
SERVE_TIMED_LAYERS = {"rwkv6-3b": 32, "qwen2.5-14b": 8}
# model_forward's fp32 correctness run keeps this many layers (griffin:
# 2 periods of (R, R, A) plus the 2-layer tail, so the tail path runs)
MODEL_CUTS = {"rwkv6-3b": 4, "recurrentgemma-2b": 8}
# model_forward (c): the rest of the zoo in bf16 at published widths, cut in
# depth only, as (layers, S).  arctic-480b keeps one layer: its init draws
# each stacked expert leaf in fp32 before the cast (17.8 GB a leaf), so one
# layer peaks near 46 GB of the card's 80
ZOO_FORWARD = {"qwen3-moe-30b-a3b": (8, 4096), "arctic-480b": (1, 2048),
               "musicgen-large": (48, 4096), "internlm2-20b": (2, 4096),
               "command-r-35b": (2, 4096), "nemotron-4-15b": (2, 4096),
               "chameleon-34b": (2, 4096)}
ZOO_TIMED = "qwen3-moe-30b-a3b"
# ... whose final hidden states are held to FORWARD_BF16_TOL end to end:
# all but musicgen-large, whose 48 layers without QK-norm amplify any
# difference past 1 (phase_zoo_forward); every arch's layers are held one
# by one
ZOO_END_TO_END = ("qwen3-moe-30b-a3b", "arctic-480b", "internlm2-20b",
                  "command-r-35b", "nemotron-4-15b", "chameleon-34b")
# kernel_vs_plain: flash sm90 at the zoo's GQA shapes, (model, seed)
ZOO_FLASH = (("musicgen-large", 6), ("qwen3-moe-30b-a3b", 7),
             ("arctic-480b", 8))

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

    from repro_torch.kernels import (adamw, flash_attention, rglru_scan,
                                     rmsnorm, wkv6)

    def build(make):
        t = time.perf_counter()
        lib = make()
        return lib._name, time.perf_counter() - t

    makes = {"flash_attention": flash_attention.build,
                "flash_attention_sm90": flash_attention.build_sm90,
                "wkv6": wkv6.build, "rglru_scan": rglru_scan.build,
                "rmsnorm": rmsnorm.build, "adamw": adamw.build}
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
    window 1024), at recurrentgemma-2b's (bf16 and fp32, window 2048,
    the model's own) and, bf16 causal, at the zoo's (``ZOO_FLASH``: G = 1
    at D = 64, G = 8, G = 7).  Returns the kernels line's rows: the fp32
    causal one for the SIMT route, the bf16 causal qwen-width one for the
    sm90 route."""
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
    for model, seed in ZOO_FLASH:
        row = _flash_rows(peaks, model, 1, 4096,
                          [(torch.bfloat16, BF16_TOL, 0)], seed=seed)
        check(row[("bfloat16", 0)]["route"] == "sm90",
              f"flash at {model} width: want the sm90 route in bf16")
    return {"flash_attention": qwen[("float32", 0)],
            "flash_attention_sm90": qwen[("bfloat16", 0)]}


def phase_flash_bwd_kernel(peaks: dict) -> dict:
    """flash's sm90 backward at internlm2-20b's train-4k call (BK 8,
    S = T = 4096, G 6, D 128, causal, bf16) and at D = 64 (G 1): the
    kernels against the plain fp32 backward (normwise, the card tests'
    2e-2; a bk at a time), then the kernels', the plain version's, the
    blockwise recompute's (the other route's backward) and
    scaled_dot_product_attention's backward's times beside the bound of
    2.5 times the forward's causal FLOPs, and the forward's time with and
    without writing the lse.  Returns the train-4k row."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import blockwise_attention

    rows = {}
    for BK, G, D in ((8, 6, 128), (8, 1, 64)):
        S = T = 4096
        rng = np.random.default_rng(BK * G * D)
        q = torch.from_numpy(rng.standard_normal((BK, S, G, D)).astype(
            np.float32) / D ** 0.5).to("cuda", torch.bfloat16)
        k, v = (torch.from_numpy(rng.standard_normal((BK, T, D)).astype(
            np.float32)).to("cuda", torch.bfloat16) for _ in range(2))
        g = torch.from_numpy(rng.standard_normal((BK, S, G, D)).astype(
            np.float32)).to("cuda", torch.bfloat16)
        o, lse = fa.flash_attention_folded(q, k, v, return_lse=True)
        before = fa.launches_bwd_sm90
        got = fa.flash_attention_bwd_folded(q, k, v, o, g, lse)
        torch.cuda.synchronize()
        check(fa.launches_bwd_sm90 == before + 1, "sm90 backward not counted")
        num = [0.0, 0.0, 0.0]
        den = [0.0, 0.0, 0.0]
        for i in range(BK):
            f32 = [x[i:i + 1].float() for x in (q, k, v)]
            of, lsef = fa.flash_attention_plain(*f32, return_lse=True)
            want = fa.flash_attention_bwd_plain(*f32, of, g[i:i + 1].float(),
                                                lsef)
            for j, (a, b) in enumerate(zip(got, want)):
                num[j] += float((a[i:i + 1].float() - b).norm() ** 2)
                den[j] += float(b.norm() ** 2)
            del f32, of, lsef, want
        err = max((n / d) ** 0.5 for n, d in zip(num, den))
        check(err <= BF16_TOL, f"flash sm90 backward vs plain fp32 at D = {D}"
              f", G = {G}: normwise err {err} > {BF16_TOL}")
        kernel_ms = time_ms(lambda: fa.flash_attention_bwd_folded(
            q, k, v, o, g, lse))
        fwd_ms = time_ms(lambda: fa.flash_attention_folded(q, k, v))
        fwd_lse_ms = time_ms(lambda: fa.flash_attention_folded(
            q, k, v, return_lse=True))
        plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, o, g, lse), reps=3, warm=1)
        xs = [x.reshape(1, BK, S, G, D).permute(0, 2, 1, 3, 4) if x is q
              else x.reshape(1, BK, T, D).permute(0, 2, 1, 3)
              for x in (q, k, v)]
        xs = [x.detach().clone().requires_grad_() for x in xs]
        ob = blockwise_attention(*xs)
        gb = g.reshape(1, BK, S, G, D).permute(0, 2, 1, 3, 4)
        blockwise_ms = time_ms(lambda: torch.autograd.grad(
            ob, xs, gb, retain_graph=True), reps=3, warm=1)
        del xs, ob
        qs = q.transpose(1, 2).detach().clone().requires_grad_()
        ks, vs = (x[:, None].detach().clone().requires_grad_()
                  for x in (k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                             scale=1.0, enable_gqa=True)
        gs = g.transpose(1, 2)
        library_ms = time_ms(lambda: torch.autograd.grad(
            out, (qs, ks, vs), gs, retain_graph=True))
        del qs, ks, vs, out
        flops = 2.5 * 4.0 * BK * G * D * (S * (S + 1) // 2)
        nbytes = 2.0 * (4 * BK * S * G * D + 4 * BK * T * D)
        bound_ms, bound_by = _bound_ms(flops, nbytes, peaks["bf16"], peaks)
        row = {"route": "sm90", "dtype": "bfloat16", "BK": BK, "S": S,
               "G": G, "D": D, "max_norm_err": err, "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "blockwise_ms": blockwise_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "roofline_pct":
               100.0 * bound_ms / kernel_ms, "fwd_ms": fwd_ms,
               "fwd_lse_ms": fwd_lse_ms}
        report("kernel_vs_plain", kernel="flash_attention_bwd_sm90", **row)
        rows[(G, D)] = row
        del q, k, v, g, o, lse, got
        torch.cuda.empty_cache()
    return rows[(6, 128)]


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


def phase_adamw_kernel(peaks: dict) -> dict:
    """AdamW's ``adamw_leaf`` and ``square_sum`` at internlm2-20b's
    train-4k leaves in bf16 (``ADAMW_LEAVES``), against the plain slice
    loop (``CHUNK`` slices) and slice sum: the update bitwise, the sum
    within 1e-6 of the fp64 sum.  Bound: 22 bytes a parameter (g, p read;
    m, v read and written; p written) and 2 (g read) over the memory
    rate.  Returns {kernel: the embed row}."""
    import torch

    from repro_torch.kernels import adamw as ka
    from repro_torch.optim.adamw import CHUNK

    hp = dict(b1=0.9, b2=0.95, eps=1e-8, lr=1e-4, weight_decay=0.0,
              chunk=CHUNK)
    rows = {}
    for leaf, shape in ADAMW_LEAVES.items():
        n = math.prod(shape)
        gen = torch.Generator("cuda").manual_seed(5)
        g = torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16)
        p = torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16)
        m = 0.01 * torch.randn(n, generator=gen, device="cuda")
        v = 1e-4 * torch.rand(n, generator=gen, device="cuda")
        step = torch.full((), 3.0, device="cuda")
        ctx = (torch.full((), 0.37, device="cuda"), 1 - torch.pow(0.9, step),
               1 - torch.pow(0.95, step))
        want = [t.clone() for t in (m, v, p)]
        ka.adamw_leaf_plain(g, *want, *ctx, **hp)
        ka.adamw_leaf(g, m, v, p, *ctx, **hp)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip((m, v, p), want))
        check(bitwise, f"adamw_leaf {leaf}: m, v, p differ from the plain "
              "slice loop's")
        del want
        exact = float(g.double().square().sum())
        err = abs(float(ka.square_sum(g, chunk=CHUNK)) - exact) / exact
        plain_err = abs(float(ka.square_sum_plain(g, chunk=CHUNK))
                        - exact) / exact
        check(err <= 1e-6, f"square_sum {leaf}: relative error {err}")
        times = {
            "adamw_leaf": (time_ms(lambda: ka.adamw_leaf(g, m, v, p, *ctx,
                                                         **hp)),
                           time_ms(lambda: ka.adamw_leaf_plain(
                               g, m, v, p, *ctx, **hp)), 22.0 * n),
            "square_sum": (time_ms(lambda: ka.square_sum(g, chunk=CHUNK)),
                           time_ms(lambda: ka.square_sum_plain(
                               g, chunk=CHUNK)), 2.0 * n)}
        for kernel, (kernel_ms, plain_ms, nbytes) in times.items():
            bound_ms, bound_by = _bound_ms(0.0, nbytes, peaks["bf16"], peaks)
            row = {"dtype": "bfloat16", "leaf": leaf, "shape": list(shape),
                   "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                   "library_ms": None, "bound_ms": bound_ms,
                   "bound_by": bound_by, "bytes": nbytes,
                   "bitwise": bitwise, "max_norm_err": err,
                   "plain_norm_err": plain_err}
            report("kernel_vs_plain", kernel=kernel, **row)
            if leaf == "embed":
                rows[kernel] = row
        del g, p, m, v
        torch.cuda.empty_cache()
    return rows


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
    (module, attribute).  Flash counts each route apart, and the sm90
    backward beside them; AdamW counts its two kernels."""
    from repro_torch.kernels import adamw, flash_attention, rglru_scan, wkv6
    return {"wkv6": (wkv6, "launches"),
            "rglru_scan": (rglru_scan, "launches"),
            "flash_attention": (flash_attention, "launches_simt"),
            "flash_attention_sm90": (flash_attention, "launches_sm90"),
            "flash_attention_bwd_sm90": (flash_attention,
                                         "launches_bwd_sm90"),
            "adamw_leaf": (adamw, "launches_leaf"),
            "square_sum": (adamw, "launches_square_sum")}


def _launch_counts() -> dict:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _counters().items()}


def _set_launch_counts(counts: dict) -> None:
    for name, (mod, attr) in _counters().items():
        setattr(mod, attr, counts[name])


def _expected_launches(cfg, dtype, n_forwards: int = 1,
                       n_backwards: int = 0, n_updates: int = 0,
                       params=None, offloaded: bool = False) -> dict:
    """One launch per layer of the kernel's kind; attention layers go to
    the flash route that ``dtype`` and the head dim select, and each of
    ``n_backwards`` backward passes to flash's sm90 backward where
    ``bwd_route`` names it (self-attention: every row sees a key).  Each
    of ``n_updates`` AdamW updates of ``params`` (on the card) launches
    ``square_sum`` once a leaf and ``adamw_leaf`` once a leaf, or
    ``offloaded`` once a piece of at most ``CHUNK`` elements."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.optim.adamw import CHUNK
    sizes = list(_leaf_sizes(params)) if params is not None else []
    pieces = sum(-(-n // CHUNK) for n in sizes) if offloaded else len(sizes)
    kinds = cfg.layer_kinds()
    attn = n_forwards * kinds.count("attn")
    sm90 = fa.route(dtype, cfg.d_head) == "sm90"
    bwd = fa.bwd_route(dtype, cfg.d_head, 1, 1, 0) == "sm90"
    return {"wkv6": n_forwards * kinds.count("rwkv"),
            "rglru_scan": n_forwards * kinds.count("rglru"),
            "flash_attention": 0 if sm90 else attn,
            "flash_attention_sm90": attn if sm90 else 0,
            "flash_attention_bwd_sm90": n_backwards * kinds.count("attn")
            if bwd else 0,
            "adamw_leaf": n_updates * pieces,
            "square_sum": n_updates * len(sizes)}


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


def _zoo_batch(cfg, gen, S: int, B: int = 1) -> dict:
    """Seeded inputs on the card: tokens, or embeds (B, S, d) for an
    ``input_embeds`` arch, and labels (B, S[, n_codebooks])."""
    import torch
    if cfg.input_embeds:
        return {"embeds": torch.randn((B, S, cfg.d_model), generator=gen,
                                      device="cuda"),
                "labels": torch.randint(0, cfg.vocab,
                                        (B, S, cfg.n_codebooks),
                                        generator=gen, device="cuda")}
    return {k: torch.randint(0, cfg.vocab, (B, S), generator=gen,
                             device="cuda") for k in ("tokens", "labels")}


def _layerwise_rel(cfg, params, batch) -> list:
    """Each layer of a full-attention stack fed the plain path's input,
    with kernels and without: the normwise difference of its two outputs
    over the plain output's norm, layer by layer.  Comparisons: their
    launches are not counted."""
    import torch

    from repro_torch.models import Transformer
    from repro_torch.models import transformer as tr
    x = Transformer(cfg)._embed(params, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    rels = []
    with torch.no_grad():
        for i in range(cfg.n_layers):
            lp = tr._index(params["layers"], i)
            y_k = tr._attn_block(lp, x, cfg, positions, 0, True)[0].float()
            y_p = tr._attn_block(lp, x, cfg, positions, 0, False)[0]
            rels.append(((y_k - y_p.float()).norm()
                         / y_p.float().norm()).item())
            x = y_p
    return rels


def phase_zoo_forward(name: str, n_layers: int, S: int, smi: str,
                      reps: int = 3) -> dict:
    """model_forward (c) for one arch of the zoo: bf16, B = 1, published
    width, ``n_layers`` deep, kernels against the plain path.  The timed
    arch (``ZOO_TIMED``) also runs ``reps`` timed forwards and one under
    the profiler.  Returns the kernels' launches.

    Two comparisons: the final hidden states of the whole stack, and each
    layer fed the plain path's input (``_layerwise_rel``).  With these
    seeded weights attention is nearly an argmax (the init's fan-in for
    w_q and w_k is n_heads, so scores have a standard deviation of tens)
    and the stacks without QK-norm amplify any difference layer by layer:
    musicgen-large's fp32 kernels-vs-plain difference grows about six
    times a layer (1.4e-7, 4.6e-6, 3.2e-5, 1.8e-4 over its first four
    layers), and in bf16 it saturates near 1 by the eighth.  So the final
    states are held at ``FORWARD_BF16_TOL`` where the stack is shallow
    enough to measure the kernel (``ZOO_END_TO_END``), and every arch's
    layers are held one by one at the same tolerance."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Transformer

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(name), n_layers=n_layers)
    gen = torch.Generator("cuda").manual_seed(0)
    params = Transformer(cfg).init(gen, dtype=torch.bfloat16)
    n_params = sum(_leaf_sizes(params))
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _perturb_constants(params, gen)
    batch = _zoo_batch(cfg, gen, S)
    kernels, plain = (Transformer(cfg, use_pallas=p) for p in (True, False))
    _set_launch_counts(dict.fromkeys(_counters(), 0))       # run starts
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    loss_k, metrics = kernels.loss(params, batch)
    e1.record()
    torch.cuda.synchronize()
    counts = _launch_counts()                               # ... and ends
    want = _expected_launches(cfg, torch.bfloat16)
    check(counts == want, f"{name} bf16: launches {counts}, want {want}")
    loss_p, _ = plain.loss(params, batch)
    loss_k, loss_p = float(loss_k), float(loss_p)
    # comparisons: their launches are not counted
    h_k, h_p = kernels.hidden(params, batch), plain.hidden(params, batch)
    layer_rel = _layerwise_rel(cfg, params, batch)
    _set_launch_counts(counts)
    h_k, h_p = h_k.float(), h_p.float()
    h_rel = ((h_k - h_p).norm() / h_p.norm()).item()
    check(math.isfinite(loss_k) and h_k.shape == (1, S, cfg.d_model)
          and math.isfinite(h_rel), f"{name} bf16: loss {loss_k}, hidden "
          f"{tuple(h_k.shape)}, normwise err {h_rel}")
    check(name not in ZOO_END_TO_END or h_rel <= FORWARD_BF16_TOL,
          f"{name} bf16 hidden states with kernels vs plain: normwise err "
          f"{h_rel} > {FORWARD_BF16_TOL}")
    check(max(layer_rel) <= FORWARD_BF16_TOL,
          f"{name} bf16 layers fed the same input, kernels vs plain: "
          f"normwise errs {layer_rel} beyond {FORWARD_BF16_TOL}")
    del h_k, h_p
    line = dict(model=name, run="bf16_zoo", n_layers=n_layers,
                of_layers=get_config(name).n_layers, batch=1, seq=S,
                params=n_params, weights_gb=2 * n_params / 1e9,
                loss_kernels=loss_k, loss_plain=loss_p,
                rel_err=abs(loss_k - loss_p) / abs(loss_p),
                router_aux=float(metrics["aux"]) if cfg.is_moe else None,
                hidden_rel_err=h_rel, end_to_end_checked=name in
                ZOO_END_TO_END, layer_rel_err_max=max(layer_rel),
                layer_rel_err=layer_rel if len(layer_rel) <= 8 else
                layer_rel[:4] + layer_rel[-4:],
                tol=FORWARD_BF16_TOL, launches=counts,
                first_forward_ms=e0.elapsed_time(e1),
                init_peak_mem_gb=init_peak_gb)
    if name == ZOO_TIMED:
        times = []
        for _ in range(reps):
            e0, e1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            e0.record()
            kernels.loss(params, batch)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        breakdown = _profile_moe(lambda: kernels.loss(params, batch), cfg)
        counts = _launch_counts()
        want = _expected_launches(cfg, torch.bfloat16, reps + 2)
        check(counts == want, f"{name} bf16 timed: launches {counts}, want "
              f"{want}")
        n_attn = cfg.layer_kinds().count("attn")
        check(breakdown["flash_sm90"][1] == n_attn,
              f"{name} bf16 profile: {breakdown['flash_sm90'][1]} sm90 "
              f"flash launches, want {n_attn}")
        wall_ms = sorted(times)[len(times) // 2]
        line.update(wall_ms=wall_ms, wall_ms_all=times,
                    tokens_per_s=S / wall_ms * 1e3, launches=counts,
                    profile=breakdown)
    line.update(peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                seconds=time.perf_counter() - t_phase, card=smi)
    report("model_forward", **line)
    del params, kernels, plain, batch
    torch.cuda.empty_cache()
    return counts


def _profile_moe(fn, cfg) -> dict:
    """One call of fn under torch.profiler, its device time split as
    {part: [ms, calls]}: the expert products (``aten::bmm`` whose first
    operand has n_experts rows), the other GEMMs (``aten::mm``, ``addmm``,
    ``bmm``), the dispatch and combine (``sort``, ``bincount``, ``cumsum``,
    ``index``, ``index_put_``), each as the device time of the kernels its
    host op launched; flash's sm90 kernel by name; and the device's busy
    time with its largest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    parts = {"expert_bmm": [0.0, 0], "other_gemm": [0.0, 0],
             "dispatch_combine": [0.0, 0]}
    dispatch = {"aten::sort", "aten::bincount", "aten::cumsum",
                "aten::index", "aten::index_put_"}
    for e in prof.key_averages(group_by_input_shape=True):
        if e.device_type != DeviceType.CPU:
            continue
        ms = (getattr(e, "device_time_total", None)
              or getattr(e, "cuda_time_total", 0.0)) / 1e3
        shapes = e.input_shapes or [[]]
        if e.key == "aten::bmm" and shapes[0][:1] == [cfg.n_experts]:
            part = "expert_bmm"
        elif e.key in ("aten::mm", "aten::addmm", "aten::bmm"):
            part = "other_gemm"
        elif e.key in dispatch:
            part = "dispatch_combine"
        else:
            continue
        parts[part][0] += ms
        parts[part][1] += e.count
    rows, busy_ms = _device_rows(prof)
    flash = [r for r in rows or () if "flash_fwd_sm90_kernel<" in r[0]]
    parts["flash_sm90"] = [sum(r[1] for r in flash),
                           sum(r[2] for r in flash)]
    parts["device_busy_ms"] = busy_ms
    parts["top8_device_ms"] = None if rows is None else rows[:8]
    return parts


def _tree_float(v):
    return {k: _tree_float(x) for k, x in v.items()} if isinstance(v, dict) \
        else v.float()


def _profile(fn):
    """One call of fn under torch.profiler: its kernels by device time, as
    [[name, ms, calls], ...] largest first, and their device time in all,
    in ms.  (None, None) where the profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _device_rows(prof)


def _device_rows(prof):
    """A profile's device-side rows, largest first, and their sum (see
    ``_profile``)."""
    from torch.autograd import DeviceType
    from repro_torch.kernels.ops import BACKWARD_RANGE
    from repro_torch.optim.adamw import UPDATE_RANGE
    rows = []
    for e in prof.key_averages():
        # device-side events only: a CPU op also reports its kernels'
        # time, which would count each kernel twice; and kernels only:
        # the port's profiler ranges show on the device's timeline too
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0 \
                and e.key not in (BACKWARD_RANGE, UPDATE_RANGE):
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


def _host_tree(tree):
    """A params tree moved to the host (what the serving runtime uploads
    through its residency layer)."""
    return {k: _host_tree(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


def _serve_params(cfg, seed: int, dtype=None):
    """The port's seeded init drawn on the card (a CUDA generator keeps
    host randn out of the run), constants perturbed, moved to the host."""
    import torch

    from repro_torch.models import Transformer
    gen = torch.Generator("cuda").manual_seed(seed)
    params = Transformer(cfg).init(gen, dtype=dtype)
    _perturb_constants(params, gen)
    host = _host_tree(params)
    del params
    torch.cuda.empty_cache()
    return host


def _standalone_decode(rt, req):
    """A request's greedy decode straight through the model: prefill at
    batch 1 with no padding, then decode_step (zero embeds a step for an
    embeds arch, as the engine steps).  Returns its tokens and each step's
    sampled logits (codebook 0's for a codebook arch; on the card)."""
    import torch
    model, params, cfg = rt.model, rt.params, rt.cfg
    key = "embeds" if cfg.input_embeds else "tokens"
    logits, cache = model.prefill(
        params, {key: torch.from_numpy(req.prompt[None]).cuda()},
        max_seq=rt.max_seq)
    cache = model.quantize_cache(cache)
    first = (lambda lg: lg[..., 0, :]) if cfg.n_codebooks else \
        (lambda lg: lg)
    steps = [first(logits)[0]]
    tok = torch.argmax(first(logits), dim=-1).to(torch.int32)
    out = [tok]
    for i in range(req.max_new_tokens - 1):
        pos = torch.full((1,), req.prompt_len + i, dtype=torch.int32,
                         device="cuda")
        step = ({"embeds": torch.zeros((1, cfg.d_model), device="cuda")}
                if cfg.input_embeds else {"tokens": tok})
        logits, cache = model.decode_step(params, cache, step, pos)
        steps.append(first(logits)[0])
        tok = torch.argmax(first(logits), dim=-1).to(torch.int32)
        out.append(tok)
    return torch.cat(out).cpu().numpy(), steps


def _serve_exact(name: str, cut: int, smi: str) -> None:
    """serve (a) for one model: the engine's tokens against each request's
    standalone decode, fp32, full width, cut depth."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.serve import Engine, Request, ServeRuntime, make_trace

    cfg = dataclasses.replace(get_config(name), n_layers=cut,
                              dtype="float32")
    if cfg.is_moe:
        # C >= T: no bucket, batch or standalone decode drops a token
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    host = _serve_params(cfg, seed=1)
    griffin = cfg.layer_pattern == "griffin"
    # griffin also serves a 2048 + 16 token request: max_seq 2064 holds it
    # and sizes the ring at the full 2048-token window, which the decode
    # steps wrap.  The prompt is 2048, not 2040: griffin's buckets are
    # exact, and the prefill's blockwise attention (the reference's too)
    # needs a prompt over 512 tokens to be a multiple of its 512 chunk
    max_seq = 2064 if griffin else 128
    for kv_quant in (False, True) if name == "qwen2.5-14b" else (False,):
        t = time.perf_counter()
        rt = ServeRuntime(cfg, max_seq=max_seq, params=host,
                          kv_quant=kv_quant)
        rt.tune = None
        reqs = make_trace(cfg, n_requests=16, rate_rps=1e6, seed=0,
                          max_seq=max_seq)
        if griffin:
            rng = np.random.default_rng(1)
            reqs.append(Request(rid=16, prompt=rng.integers(
                0, cfg.vocab, (2048,)).astype(np.int32), max_new_tokens=16))
        eng = Engine(rt, capacity=4)
        rep = eng.run(reqs, respect_arrivals=False)
        check(rep["n_requests"] == len(reqs) and eng.pool.in_use == 0,
              f"serve {name}: {rep['n_requests']} of {len(reqs)} finished")
        ties = []
        for r in eng.completed:
            want, steps = _standalone_decode(rt, r)
            check(r.tokens.shape == want.shape,
                  f"serve {name} rid {r.rid}: {r.tokens.shape} tokens")
            diff = np.flatnonzero(r.tokens != want)
            if len(diff):
                j = int(diff[0])
                top2 = torch.topk(steps[j].float(), 2).values
                gap = float(top2[0] - top2[1])
                bound = SERVE_TIE * float(steps[j].float().abs().max())
                check(gap <= bound,
                      f"serve {name} kv_quant={kv_quant} rid {r.rid}: "
                      f"token {j} is {r.tokens[j]}, the standalone decode's "
                      f"{want[j]}, whose top-two gap {gap} > {bound}")
                ties.append({"rid": r.rid, "step": j, "gap": gap,
                             "bound": bound})
        report("serve", run="fp32_exact", model=name, n_layers=cut,
               kv_quant=kv_quant, max_seq=max_seq, capacity=4,
               capacity_factor=cfg.capacity_factor if cfg.is_moe else None,
               input_embeds=cfg.input_embeds,
               n_requests=len(reqs), steps=rep["steps"],
               gen_tokens=rep["gen_tokens"], tie_tol=SERVE_TIE,
               near_tie_divergences=ties, seconds=time.perf_counter() - t,
               card=smi)
        del rt, eng
        torch.cuda.empty_cache()


def _decode_step_ms(rt, capacity: int, reps: int = 30):
    """Median device time of one whole-batch decode step (CUDA events on
    stream 0 around ``ServeRuntime.decode``), on a full pool at positions
    16.., and the state to profile one more step."""
    import torch

    from repro_torch.serve import KVSlotPool
    pool = KVSlotPool(rt.model, capacity, rt.max_seq)
    i32 = dict(dtype=torch.int32, device="cuda")
    state = (pool.cache, torch.zeros((capacity,), **i32),
             torch.full((capacity,), 16, **i32),
             torch.zeros((capacity, 64), **i32),
             torch.zeros((capacity,), **i32))
    s0 = rt.be.torch_stream(0)
    for _ in range(3):
        rt.decode(*state)
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record(s0)
        rt.decode(*state)
        e1.record(s0)
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return sorted(times)[len(times) // 2], state


def _prefill_ms(rt, lens, reps: int = 3) -> dict:
    """Median time (CUDA events on stream 1) of one prefill per bucket."""
    import numpy as np
    import torch

    from repro_torch.serve import Request
    s1 = rt.be.torch_stream(1)
    out = {}
    for L in lens:
        req = Request(rid=0, prompt=np.zeros((L,), np.int32),
                      max_new_tokens=2)
        padded = rt.bucket_of(L)
        times = []
        for _ in range(reps + 1):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record(s1)
            rt._prefill(req, padded)
            e1.record(s1)
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        out[padded] = sorted(times[1:])[reps // 2]
    return out


def _profile_step(fn):
    """One call of fn under torch.profiler, after one more unprofiled
    call: its device rows and busy ms (``_device_rows``), the host's
    events (aten calls and CUDA runtime calls) by self CPU time as
    [[name, ms, calls], ...], and the profiled call's wall ms (the
    profiler's own cost included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows, busy_ms = _device_rows(prof)
    from torch.autograd import DeviceType
    host = sorted(([e.key[:60], e.self_cpu_time_total / 1e3, e.count]
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU), key=lambda r: -r[1])
    return rows, busy_ms, host, wall_ms


def _serve_timed(name: str, n_layers: int, smi: str) -> None:
    """serve (b) for one model: port_serve_bench's trace at full width in
    bf16, its checks, the decode step timed and profiled, and a second
    runtime on the same bucket cache."""
    import dataclasses
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.serve import Engine, Request, ServeRuntime

    sys.path.insert(0, str(Path(__file__).resolve().parent / "benchmarks"))
    import port_serve_bench as bench

    cfg = dataclasses.replace(get_config(name), n_layers=n_layers)
    host = _serve_params(cfg, seed=2, dtype=torch.bfloat16)
    n_params = sum(_leaf_sizes(host))
    n_bytes = 2 * n_params
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_serve_tc-")
    saved = os.environ.get("REPRO_TORCH_TUNE_CACHE")
    os.environ["REPRO_TORCH_TUNE_CACHE"] = cache_dir
    try:
        torch.cuda.reset_peak_memory_stats()
        rt = ServeRuntime(cfg, max_seq=128, params=host)
        check(rt.weights_bytes == n_bytes,
              f"serve {name}: weights h2d {rt.weights_bytes} B, params "
              f"{n_bytes} B")
        row = bench.bench_runtime(rt, n_requests=48, capacity=8, seed=0,
                                  gate=False)
        cont = row["_reports"]["continuous"]
        step_ms, state = _decode_step_ms(rt, capacity=8)
        rows, busy_ms, host_rows, profiled_ms = _profile_step(
            lambda: rt.decode(*state))
        lens = sorted({r.prompt_len for r in cont["completed"]})
        prefill = _prefill_ms(rt, lens)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        h2d_s = rt.weights_h2d_s
        del rt, state
        torch.cuda.empty_cache()

        # a fresh runtime on the same bucket cache measures nothing
        rt2 = ServeRuntime(cfg, max_seq=128, params=host)
        Engine(rt2, capacity=8).run(
            [Request(rid=i, prompt=np.zeros((L,), np.int32),
                     max_new_tokens=2) for i, L in enumerate(lens)],
            respect_arrivals=False)
        check(rt2.tune_measurements == 0 and rt2.tune_hits == len(lens),
              f"serve {name}: a second runtime measured "
              f"{rt2.tune_measurements} buckets, hit {rt2.tune_hits}")
        second = {"measurements": rt2.tune_measurements,
                  "hits": rt2.tune_hits}
        del rt2
        torch.cuda.empty_cache()
    finally:
        if saved is None:
            os.environ.pop("REPRO_TORCH_TUNE_CACHE", None)
        else:
            os.environ["REPRO_TORCH_TUNE_CACHE"] = saved
        shutil.rmtree(cache_dir, ignore_errors=True)
    del row["_reports"]
    report("serve", run="bf16_timed", model=name, n_layers=n_layers,
           params=n_params, card=smi, **row,
           decode_step_ms=step_ms, decode_steps_per_s=1e3 / step_ms,
           prefill_ms_by_bucket=prefill,
           weights_h2d_bytes=n_bytes, weights_h2d_s=h2d_s,
           weights_h2d_gb_per_s=n_bytes / h2d_s / 1e9,
           peak_mem_gb=peak_gb,
           profiled_step_wall_ms=profiled_ms, device_busy_ms=busy_ms,
           device_busy_share=None if busy_ms is None else busy_ms / step_ms,
           top5_device_ms=None if rows is None else rows[:5],
           top8_host_self_ms=host_rows[:8],
           host_self_ms=sum(r[1] for r in host_rows),
           aten_calls=sum(r[2] for r in host_rows
                          if r[0].startswith("aten::")),
           second_runtime_tune=second)


def phase_serve(smi: str) -> None:
    """The serving path (see the module docstring, 7).  The kernels'
    launch counters must not move: serving runs no Pallas kernel in the
    reference, and none in the port."""
    import torch

    from repro_torch.kernels import rmsnorm as rn
    before = {**_launch_counts(), "rmsnorm": rn.launches}
    t_phase = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, cut in SERVE_EXACT_CUTS.items():
            _serve_exact(name, cut, smi)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    t_exact = time.perf_counter() - t_phase
    for name, n_layers in SERVE_TIMED_LAYERS.items():
        _serve_timed(name, n_layers, smi)
    after = {**_launch_counts(), "rmsnorm": rn.launches}
    check(after == before, f"serve launched a kernel: {before} -> {after}")
    report("serve", run="all", seconds=time.perf_counter() - t_phase,
           exact_seconds=t_exact, launches_unchanged=after, card=smi)


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


def _train_batch(cfg, index: int, seed: int = 0) -> dict:
    """SyntheticLM's batch ``index`` (B = 1, S = TRAIN_SEQ) on the card."""
    import torch

    from repro_torch.data import SyntheticLM
    src = SyntheticLM(cfg, 1, TRAIN_SEQ, seed=seed)
    return {k: torch.from_numpy(v).cuda()
            for k, v in src.batch_at(index).items()}


def _train_kernel_vs_plain(smi: str) -> dict:
    """train (a): qwen2.5-14b at full width, TRAIN_CUT_LAYERS deep, fp32
    (TF32 off): ``build_cell``'s train function with kernels (flash's SIMT
    route) against the plain path from the same weights and batch, the
    loss at TRAIN_LOSS_RTOL, then every gradient leaf at TRAIN_GRAD_TOL
    (``steps.value_and_grad``, a comparison: its launches are not
    counted).  Both cells update with AdamW's kernels, once a leaf each.
    Returns the launches of the cell's run with kernels."""
    import dataclasses

    import torch

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import steps
    from repro_torch.models import Transformer
    from repro_torch.optim import default_optimizer
    from repro_torch.tree import leaves

    t_run = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_MODEL),
                              n_layers=TRAIN_CUT_LAYERS, dtype="float32")
    shape = ShapeSpec("train_cut", "train", TRAIN_SEQ, 1)
    gen = torch.Generator("cuda").manual_seed(0)
    params = Transformer(cfg).init(gen)
    _perturb_constants(params, gen)
    batch = _train_batch(cfg, 0)
    # both sides update with AdamW's kernels; only the model's differ
    update = _expected_launches(cfg, torch.float32, n_forwards=0,
                                n_updates=1, params=params)
    n_attn = cfg.layer_kinds().count("attn")
    want = {True: {**update, "flash_attention": 2 * n_attn}, False: update}
    losses, counts = {}, None
    before = _launch_counts()
    for use_pallas in (True, False):
        cell = steps.build_cell(cfg, shape, use_pallas=use_pallas)
        p = _clone_tree(params)
        state = default_optimizer(cfg).init(p)
        _set_launch_counts(dict.fromkeys(_counters(), 0))      # run starts
        _, _, metrics = cell.fn(p, state, batch)
        losses[use_pallas] = float(metrics["loss"])
        got = _launch_counts()                                 # ... ends
        check(got == want[use_pallas], f"train (a): "
              f"{'kernel' if use_pallas else 'plain'} path launches {got}, "
              f"want {want[use_pallas]} (the forward and the per-layer "
              "recompute with kernels; the update on both)")
        if use_pallas:
            counts = got
        del p, state, metrics, cell
        torch.cuda.empty_cache()
    _set_launch_counts(before)
    rel = abs(losses[True] - losses[False]) / abs(losses[False])
    check(math.isfinite(losses[True]) and rel <= TRAIN_LOSS_RTOL,
          f"train (a): loss with kernels {losses[True]} vs plain "
          f"{losses[False]}: rel err {rel} > {TRAIN_LOSS_RTOL}")
    # the gradients, kernels against plain (comparisons, not counted)
    before = _launch_counts()
    grads = {}
    for use_pallas in (True, False):
        _, _, g = steps.value_and_grad(
            Transformer(cfg, use_pallas=use_pallas), params, batch)
        grads[use_pallas] = leaves(g)
        del g
    _set_launch_counts(before)
    errs = [((a - b).norm() / b.norm()).item()
            for a, b in zip(grads[True], grads[False])]
    check(all(math.isfinite(e) and e <= TRAIN_GRAD_TOL for e in errs),
          f"train (a): gradient leaves with kernels vs plain: normwise "
          f"errs up to {max(errs)} > {TRAIN_GRAD_TOL}")
    report("train", run="fp32_kernel_vs_plain", model=TRAIN_MODEL,
           n_layers=TRAIN_CUT_LAYERS, batch=1, seq=TRAIN_SEQ,
           params=sum(_leaf_sizes(params)), loss_kernels=losses[True],
           loss_plain=losses[False], loss_rel_err=rel,
           loss_tol=TRAIN_LOSS_RTOL, grad_leaves=len(errs),
           grad_rel_err_max=max(errs), grad_tol=TRAIN_GRAD_TOL,
           launches=counts, seconds=time.perf_counter() - t_run, card=smi)
    del params, grads, batch
    torch.cuda.empty_cache()
    return counts


def _train_breakdown(prof) -> dict:
    """A profiled train step's device time by part, as {part: [ms,
    calls]}: flash's sm90 forward kernel by name (the forward and the
    recompute), flash's backward (the sm90 backward's kernels, or the
    ``blockwise_attention`` recompute and its gradient: everything under
    ``ops.BACKWARD_RANGE``), the
    optimizer update (under ``adamw.UPDATE_RANGE``), the other GEMMs
    (``mm``, ``addmm``, ``bmm`` outside those two ranges), and the rest
    of the device's busy time; with the largest kernels."""
    from torch.autograd import DeviceType

    from repro_torch.kernels.ops import BACKWARD_RANGE
    from repro_torch.optim.adamw import UPDATE_RANGE

    def under(e, name):
        while e is not None:
            if e.name == name:
                return True
            e = e.cpu_parent
        return False

    parts = {"flash_backward": [0.0, 0], "optimizer_update": [0.0, 0],
             "other_gemm": [0.0, 0]}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        if e.name == BACKWARD_RANGE:
            part, ms = "flash_backward", e.device_time_total
        elif e.name == UPDATE_RANGE:
            part, ms = "optimizer_update", e.device_time_total
        elif e.name in ("aten::mm", "aten::addmm", "aten::bmm") and not (
                under(e, BACKWARD_RANGE) or under(e, UPDATE_RANGE)):
            part, ms = "other_gemm", e.self_device_time_total
        else:
            continue
        parts[part][0] += ms / 1e3
        parts[part][1] += 1
    rows, busy_ms = _device_rows(prof)
    flash = [r for r in rows or () if "flash_fwd_sm90_kernel<" in r[0]]
    parts["flash_forward_sm90"] = [sum(r[1] for r in flash),
                                   sum(r[2] for r in flash)]
    parts["rest"] = None if busy_ms is None else busy_ms - sum(
        v[0] for v in parts.values() if isinstance(v, list))
    parts["device_busy_ms"] = busy_ms
    parts["top8_device_ms"] = None if rows is None else rows[:8]
    return parts


def _train_timed(smi: str, peaks: dict) -> dict:
    """train (b): qwen2.5-14b at full width, TRAIN_TIMED_LAYERS deep, bf16,
    flash's sm90 route, AdamW, batches from ``PrefetchIterator`` over
    ``SyntheticLM``: one warm step, TRAIN_TIMED_STEPS timed with CUDA
    events, one more under torch.profiler.  Returns the launches of all
    five steps (the main path)."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import PrefetchIterator, SyntheticLM
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import Transformer
    from repro_torch.optim import adamw

    t_run = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_MODEL),
                              n_layers=TRAIN_TIMED_LAYERS)
    gen = torch.Generator("cuda").manual_seed(1)
    params = Transformer(cfg).init(gen, dtype=torch.bfloat16)
    n_params = sum(_leaf_sizes(params))
    n_leaves = len(list(_leaf_sizes(params)))
    opt = adamw()
    state = opt.init(params)
    step = make_train_step(Transformer(cfg, use_pallas=True), opt)
    it = PrefetchIterator(SyntheticLM(cfg, 1, TRAIN_SEQ, seed=0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _set_launch_counts(dict.fromkeys(_counters(), 0))       # run starts
    losses, times = [], []
    try:
        params, state, m = step(params, state, next(it))    # warm
        losses.append(m["loss"])
        for _ in range(TRAIN_TIMED_STEPS):
            batch = next(it)
            e0, e1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            e0.record()
            params, state, m = step(params, state, batch)
            e1.record()
            losses.append(m["loss"])
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        batch = next(it)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            params, state, m = step(params, state, batch)
            torch.cuda.synchronize()
        losses.append(m["loss"])
    finally:
        it.close()
    counts = _launch_counts()                               # ... ends
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_steps = TRAIN_TIMED_STEPS + 2
    want = {**dict.fromkeys(_counters(), 0),
            "flash_attention_sm90": 2 * TRAIN_TIMED_LAYERS * n_steps,
            "flash_attention_bwd_sm90": TRAIN_TIMED_LAYERS * n_steps,
            "adamw_leaf": n_leaves * n_steps,
            "square_sum": n_leaves * n_steps}
    check(counts == want, f"train (b): launches {counts}, want {want}")
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses),
          f"train (b): losses {losses}")
    parts = _train_breakdown(prof)
    check(parts["flash_forward_sm90"][1] == 2 * TRAIN_TIMED_LAYERS,
          f"train (b) profile: {parts['flash_forward_sm90'][1]} sm90 flash "
          f"launches in a step, want {2 * TRAIN_TIMED_LAYERS}")
    step_ms = sorted(times)[len(times) // 2]
    # the card's least time for the step: GEMM FLOPs 6·N·T over the
    # matmul params (the embedding is a gather) plus the per-layer
    # recompute's 2·N_layers·T, attention's causal pairs (forward, its
    # recompute, and the backward's recompute and gradient: 5 forwards'
    # worth), over the bf16 peak; AdamW's bytes (p, g read; m, v read and
    # written, p written) over the memory rate
    n_layer = (n_params - cfg.vocab * cfg.d_model * 2 - cfg.d_model) \
        // TRAIN_TIMED_LAYERS
    n_matmul = n_params - cfg.vocab * cfg.d_model
    T = TRAIN_SEQ
    attn = 2.0 * T * T * cfg.d_head * cfg.n_heads * TRAIN_TIMED_LAYERS
    flops = 6.0 * n_matmul * T + 2.0 * n_layer * TRAIN_TIMED_LAYERS * T \
        + 5 * attn
    opt_bytes = n_params * (2 + 2 + 4 * 4 + 2)
    bound_ms = flops / peaks["bf16"] * 1e3 + opt_bytes / peaks["bytes"] * 1e3
    busy = parts["device_busy_ms"]
    report("train", run="bf16_timed", model=TRAIN_MODEL,
           n_layers=TRAIN_TIMED_LAYERS, batch=1, seq=T, params=n_params,
           optimizer=opt.name, step_ms=step_ms, step_ms_all=times,
           tokens_per_s=T / step_ms * 1e3, peak_mem_gb=peak_gb,
           device_busy_ms=busy,
           device_busy_share=None if busy is None else busy / step_ms,
           breakdown_ms=parts, losses=losses, losses_finite=True,
           launches=counts,
           sm90_launches_per_step=counts["flash_attention_sm90"] / n_steps,
           sm90_bwd_launches_per_step=counts["flash_attention_bwd_sm90"]
           / n_steps,
           adamw_leaf_launches_per_step=counts["adamw_leaf"] / n_steps,
           square_sum_launches_per_step=counts["square_sum"] / n_steps,
           n_leaves=n_leaves,
           bound_ms=bound_ms, bound_flops=flops, bound_opt_bytes=opt_bytes,
           seconds=time.perf_counter() - t_run, card=smi)
    del params, state, m, step
    torch.cuda.empty_cache()
    return counts


def _train_offload(smi: str) -> None:
    """train (c): qwen2.5-14b at full width, TRAIN_CUT_LAYERS deep, bf16
    (the model's plain path: no model kernel), two steps of
    ``offloaded_optimizer(adamw())`` against ``adamw()`` from the same
    start and batches: the params bitwise equal, the offloaded state in
    pinned host memory, each run's device peak over what was resident
    before its ``init`` (so the state on the card counts).  AdamW's
    kernels launch once a leaf a step on the card, and ``adamw_leaf``
    once a piece offloaded."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import Transformer
    from repro_torch.optim import adamw, offloaded_optimizer
    from repro_torch.tree import leaves

    t_run = time.perf_counter()
    meminfo = Path("/proc/meminfo").read_text().splitlines()
    mem_total = next(line for line in meminfo if line.startswith("MemTotal"))
    cfg = dataclasses.replace(get_config(TRAIN_MODEL),
                              n_layers=TRAIN_CUT_LAYERS)
    gen = torch.Generator("cuda").manual_seed(2)
    start = Transformer(cfg).init(gen, dtype=torch.bfloat16)
    batches = [_train_batch(cfg, i, seed=1) for i in range(2)]
    model = Transformer(cfg)
    before = _launch_counts()
    runs = {}
    for opt in (adamw(), offloaded_optimizer(adamw())):
        want = _expected_launches(cfg, torch.bfloat16, n_forwards=0,
                                  n_updates=len(batches), params=start,
                                  offloaded="offload" in opt.name)
        _set_launch_counts(dict.fromkeys(_counters(), 0))  # the run starts
        params = _clone_tree(start)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        state = opt.init(params)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        step = make_train_step(model, opt)
        times = []
        for b in batches:
            e0, e1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            e0.record()
            params, state, _ = step(params, state, b)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        got = _launch_counts()                             # ... and ends
        check(got == want, f"train (c) {opt.name}: launches {got}, want "
              f"{want}")
        arrays = [x for x in leaves(state) if x.ndim]
        runs[opt.name] = dict(
            params=params, init_s=init_s, step_ms=times, launches=got,
            resident_before_gb=base / 1e9,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            peak_over_resident_gb=(torch.cuda.max_memory_allocated()
                                   - base) / 1e9,
            state_gb=sum(x.numel() * x.element_size() for x in arrays) / 1e9,
            state_pinned=all(x.device.type == "cpu" and x.is_pinned()
                             for x in arrays),
            state_on_card=all(x.is_cuda for x in arrays))
        del state, step, arrays
        torch.cuda.empty_cache()
    _set_launch_counts(before)
    plain, off = runs["adamw"], runs["adamw+offload"]
    check(plain["state_on_card"] and off["state_pinned"],
          "train (c): want the plain state on the card and the offloaded "
          "state in pinned host memory")
    bitwise = all(torch.equal(a, b) for a, b in
                  zip(leaves(plain.pop("params")), leaves(off.pop("params"))))
    check(bitwise, "train (c): offloaded params differ from the plain "
          "optimizer's")
    drop = plain["peak_over_resident_gb"] - off["peak_over_resident_gb"]
    check(drop > 0, f"train (c): the offloaded peak is not lower ({drop} "
          "GB)")
    report("train", run="bf16_offload", model=TRAIN_MODEL,
           n_layers=TRAIN_CUT_LAYERS, batch=1, seq=TRAIN_SEQ,
           params=sum(_leaf_sizes(start)), params_bitwise_equal=bitwise,
           plain=plain, offload=off, peak_drop_gb=drop,
           host_mem_total=mem_total, seconds=time.perf_counter() - t_run,
           card=smi)
    del start, batches
    torch.cuda.empty_cache()


def phase_train(smi: str, peaks: dict) -> dict:
    """Training (module docstring, 8): (a) kernel vs plain, fp32; (b)
    timed, bf16; (c) offloaded optimizer.  TF32 off for (a), as the
    phase found it after.  Returns the launches of (a) and (b)."""
    import torch
    t_phase = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        counts = _train_kernel_vs_plain(smi)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    timed = _train_timed(smi, peaks)
    _train_offload(smi)
    report("train", run="all", seconds=time.perf_counter() - t_phase,
           card=smi)
    return {k: counts[k] + timed[k] for k in counts}


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
    """The plan-space tuner on the card (see the module docstring, 9).
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


# ---------------------------------------------------------------------------
# mesh: the sharded entry points on a 1×1 DeviceMesh of one NCCL rank
# ---------------------------------------------------------------------------

def _mesh_params(model, params, mesh, kind: str):
    """``params`` placed on ``mesh`` by the sharding rules of ``kind``
    (copies: the originals stay as they are), and the rules."""
    from repro_torch.distributed.sharding import (make_rules, place,
                                                  tree_shardings)
    rules = make_rules(mesh, kind)
    return place(params, tree_shardings(rules, params,
                                        model.logical_axes())), rules


def _mesh_3mm(mesh, smi: str) -> None:
    """mesh (a): 3mm at n = 2048 tuned on ``MeshBackend``: the winner
    verifies, executes through the mesh backend onto the host oracle, the
    fingerprint names the mesh, and a second plan hits the cache."""
    import numpy as np

    from repro_torch.core import (TuneCache, execute, plan, run_host_oracle,
                                  verify_plan)
    from repro_torch.core.tunecache import backend_fingerprint
    from repro_torch.distributed.mesh_backend import MeshBackend
    from repro_torch.polybench import build_3mm

    t = time.perf_counter()
    be = MeshBackend(mesh=mesh)
    fp = backend_fingerprint(be)
    check(fp.endswith(":meshdata1xmodel1"), f"mesh (a): fingerprint {fp}")
    cache_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_tc-"))
    try:
        tc = TuneCache(cache_dir)
        p3, _ = build_3mm(n=2048)
        pl = plan(p3, policy="auto", backend=be, cache=tc, reps=TUNE_REPS)
        rep = verify_plan(pl)
        check(rep.ok, f"mesh (a): the winner does not verify: "
              f"{rep.summary()}")
        out, _ = execute(pl, backend=be)
        oracle = run_host_oracle(p3)
        err = float(np.abs(np.asarray(out["out"]) - oracle["out"]).max()
                    / np.abs(oracle["out"]).max())
        check(err <= POLY_RTOL, f"mesh (a): 3mm off the host oracle by "
              f"{err} of its scale > {POLY_RTOL}")
        again = plan(build_3mm(n=2048)[0], policy="auto", backend=be,
                     cache=tc, reps=TUNE_REPS)
        info = again.meta["tuning_cache"]
        check(info["hit"] and info["measurements"] == 0,
              f"mesh (a): second plan {info}, want a hit, 0 measurements")
        tuning = pl.meta["tuning"]
        report("mesh", run="3mm_mesh_backend", n=2048,
               chosen=tuning["chosen"],
               placement=(pl.meta.get("mesh") or {}).get("placement"),
               measurements=pl.meta["tuning_cache"]["measurements"],
               normwise_err=err, tol=POLY_RTOL, fingerprint=fp,
               seconds=time.perf_counter() - t, card=smi)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)


def _mesh_attn_step(mesh, smi: str) -> dict:
    """mesh (b): attn_step at qwen2.5-14b's attention width tuned and
    executed on ``MeshBackend`` (its kernel block's inputs made whole,
    then flash's SIMT kernel), the loss against the plain version.
    Returns the launches of the tune and the winner's run."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import TuneCache, execute, plan
    from repro_torch.distributed.mesh_backend import MeshBackend
    from repro_torch.optim import attention_step_program

    t = time.perf_counter()
    cfg = get_config("qwen2.5-14b")
    shapes = (1, 4096, 4096, cfg.n_kv_heads,
              cfg.n_heads // cfg.n_kv_heads, cfg.d_head)
    prog = attention_step_program(2, shapes=shapes)
    be = MeshBackend(mesh=mesh)
    cache_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_tc-"))
    try:
        _set_launch_counts(dict.fromkeys(_counters(), 0))  # the run starts
        pl = plan(prog, policy="auto", backend=be, cache=TuneCache(cache_dir),
                  reps=1)
        out, _ = execute(pl, backend=be)
        launches = _launch_counts()                        # ... and ends
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    check(launches["flash_attention"] > 0
          and launches["flash_attention_sm90"] == 0,
          f"mesh (b): launches {launches}")
    want = _attn_step_plain_loss(prog)
    got = np.asarray(out["final_loss"])
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    check(rel <= LOSS_RTOL, f"mesh (b): attn_step loss {got} vs plain "
          f"{want}: rel err {rel} > {LOSS_RTOL}")
    report("mesh", run="attn_step_mesh_backend", shapes=list(shapes),
           chosen=pl.meta["tuning"]["chosen"],
           measurements=pl.meta["tuning_cache"]["measurements"],
           rel_err=rel, tol=LOSS_RTOL, launches=launches,
           seconds=time.perf_counter() - t, card=smi)
    return launches


def _mesh_train(mesh, smi: str) -> dict:
    """mesh (c): ``build_cell(qwen2.5-14b, train, mesh=1×1,
    use_pallas=True)`` at full width, fp32, TRAIN_CUT_LAYERS deep, against
    the unmeshed cell from the same weights: the loss within
    MESH_LOSS_RTOL, every gradient leaf within MESH_GRAD_TOL normwise, two
    flash launches per layer and AdamW's ``adamw_leaf`` and
    ``square_sum`` once a leaf in each cell; then one bf16 step of
    TRAIN_TIMED_LAYERS layers, meshed against unmeshed
    (``_mesh_train_bf16``).  Returns the meshed cells' launches."""
    import dataclasses

    import torch

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.distributed.sharding import (MeshPolicy, batch_specs,
                                                  place)
    from repro_torch.launch import steps
    from repro_torch.models import Transformer
    from repro_torch.optim import default_optimizer
    from repro_torch.roofline.analysis import collective_trace
    from repro_torch.tree import leaves

    t_run = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_MODEL),
                              n_layers=TRAIN_CUT_LAYERS, dtype="float32")
    shape = ShapeSpec("train_cut", "train", TRAIN_SEQ, 1)
    gen = torch.Generator("cuda").manual_seed(0)
    params = Transformer(cfg).init(gen)
    _perturb_constants(params, gen)
    batch = _train_batch(cfg, 0)
    n_attn = cfg.layer_kinds().count("attn")
    want = {**_expected_launches(cfg, torch.float32, n_forwards=0,
                                 n_updates=1, params=params),
            "flash_attention": 2 * n_attn}
    losses, counts = {}, None
    for meshed in (False, True):
        cell = steps.build_cell(cfg, shape, mesh if meshed else None,
                                use_pallas=True)
        p = _clone_tree(params)
        args = cell.place(p, default_optimizer(cfg).init(p), batch)
        before = _launch_counts()
        _set_launch_counts(dict.fromkeys(_counters(), 0))  # the run starts
        _, _, metrics = cell.fn(*args)
        got = _launch_counts()                             # ... and ends
        loss = metrics["loss"]
        losses[meshed] = float(loss.full_tensor() if meshed else loss)
        check(got == want, f"mesh (c): {'meshed' if meshed else 'unmeshed'}"
              f" cell launches {got}, want {want}")
        if meshed:
            counts = got
        else:
            _set_launch_counts(before)     # the unmeshed cell compares
        del p, args, metrics, cell
        torch.cuda.empty_cache()
    rel = abs(losses[True] - losses[False]) / abs(losses[False])
    check(math.isfinite(losses[True]) and rel <= MESH_LOSS_RTOL,
          f"mesh (c): meshed loss {losses[True]} vs unmeshed "
          f"{losses[False]}: rel err {rel} > {MESH_LOSS_RTOL}")
    # the gradients, meshed against unmeshed (comparisons, not counted),
    # and the meshed step's collectives on the 1×1 mesh
    before = _launch_counts()
    model = Transformer(cfg, use_pallas=True)
    _, _, g = steps.value_and_grad(model, _clone_tree(params), batch)
    plain = leaves(g)
    del g
    dp, rules = _mesh_params(model, params, mesh, "train")
    policy = MeshPolicy(rules, cfg)
    dbatch = place(batch, batch_specs(rules, cfg, "train", batch))
    trace = collective_trace()
    with trace:
        _, _, g = steps.value_and_grad(model, dp, dbatch, policy=policy)
    _set_launch_counts(before)
    errs = [float((a.full_tensor() - b).norm() / b.norm())
            for a, b in zip(leaves(g), plain)]
    check(all(math.isfinite(e) and e <= MESH_GRAD_TOL for e in errs),
          f"mesh (c): gradient leaves meshed vs unmeshed: normwise errs "
          f"up to {max(errs)} > {MESH_GRAD_TOL}")
    report("mesh", run="train_fp32_meshed_vs_unmeshed", model=TRAIN_MODEL,
           n_layers=TRAIN_CUT_LAYERS, batch=1, seq=TRAIN_SEQ,
           loss_meshed=losses[True], loss_unmeshed=losses[False],
           loss_rel_err=rel, loss_tol=MESH_LOSS_RTOL, grad_leaves=len(errs),
           grad_rel_err_max=max(errs), grad_tol=MESH_GRAD_TOL,
           launches=counts, collectives=len(trace.records),
           comm_counts={str(k): v for k, v in
                        trace.get_comm_counts().items()},
           seconds=time.perf_counter() - t_run, card=smi)
    del params, dp, dbatch, g, plain
    torch.cuda.empty_cache()
    bf16 = _mesh_train_bf16(mesh, smi)
    return {k: counts[k] + bf16[k] for k in counts}


def _mesh_train_bf16(mesh, smi: str) -> dict:
    """mesh (c), bf16: AdamW steps of TRAIN_TIMED_LAYERS layers from the
    same weights and batch, unmeshed, meshed and unmeshed again (the
    order brackets drift), then unmeshed with the plain attention (the
    rounding control).  Each run takes a first step, then
    MESH_TIMED_STEPS steps timed by CUDA events (the median kept; the
    DTensor overhead is the meshed median over the mean of the two
    unmeshed ones, reported, not gated).  The meshed first step is the
    main path's: its launches are counted and must be flash's sm90
    kernel twice per attention layer (the forward and the backward's
    recompute), its sm90 backward once, AdamW's two kernels once a leaf,
    and nothing else; its loss, taken before any update, must be within
    MESH_LOSS_RTOL of the unmeshed one.  The first step's
    gradients, meshed against unmeshed, must agree leaf by leaf within
    MESH_BF16_GRAD_TOL normwise; the plain attention's against the
    kernel's are reported beside them.  Returns the counted launches."""
    import dataclasses

    import torch

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.distributed.sharding import (MeshPolicy, batch_specs,
                                                  place)
    from repro_torch.launch import steps
    from repro_torch.models import Transformer
    from repro_torch.optim import default_optimizer
    from repro_torch.tree import flatten_with_paths, leaves

    t = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_MODEL),
                              n_layers=TRAIN_TIMED_LAYERS)
    shape = ShapeSpec("train_timed", "train", TRAIN_SEQ, 1)
    gen = torch.Generator("cuda").manual_seed(1)
    params = Transformer(cfg).init(gen)
    batch = _train_batch(cfg, 1)
    want = _expected_launches(cfg, torch.bfloat16, n_forwards=2,
                              n_backwards=1, n_updates=1, params=params)
    runs, counts = [], None
    before = _launch_counts()
    for label, meshed, kernels in (("unmeshed", False, True),
                                   ("meshed", True, True),
                                   ("unmeshed", False, True),
                                   ("unmeshed_plain_attention", False,
                                    False)):
        cell = steps.build_cell(cfg, shape, mesh if meshed else None,
                                use_pallas=kernels)
        p = _clone_tree(params)
        args = cell.place(p, default_optimizer(cfg).init(p), batch)
        if meshed:
            _set_launch_counts(dict.fromkeys(_counters(), 0))  # starts
        _, _, metrics = cell.fn(*args)                     # first step
        torch.cuda.synchronize()
        if meshed:
            counts = _launch_counts()                      # ... and ends
        losses = [metrics["loss"]]
        times = []
        for _ in range(MESH_TIMED_STEPS):
            e0, e1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            e0.record()
            _, _, metrics = cell.fn(*args)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
            losses.append(metrics["loss"])
        losses = [float(v.full_tensor() if meshed else v) for v in losses]
        runs.append({"run": label, "step_ms": times,
                     "step_ms_median": sorted(times)[len(times) // 2],
                     "losses": losses})
        del p, args, metrics, cell
        torch.cuda.empty_cache()
    check(counts == want, f"mesh (c) bf16: meshed first step launches "
          f"{counts}, want {want}")
    plain, meshed_run, _, control = runs
    check(all(math.isfinite(v) for r in runs for v in r["losses"]),
          f"mesh (c) bf16: losses {[r['losses'] for r in runs]}")
    loss_err = (abs(meshed_run["losses"][0] - plain["losses"][0])
                / abs(plain["losses"][0]))
    check(loss_err <= MESH_LOSS_RTOL, f"mesh (c) bf16: first-step loss "
          f"meshed {meshed_run['losses'][0]} vs unmeshed "
          f"{plain['losses'][0]}: rel err {loss_err} > {MESH_LOSS_RTOL}")

    # the first step's gradients: meshed and plain attention against the
    # unmeshed kernel's (comparisons, not counted)
    model = Transformer(cfg, use_pallas=True)
    _, _, g = steps.value_and_grad(model, _clone_tree(params), batch)
    ref = [x.float() for x in leaves(g)]
    del g
    dp, rules = _mesh_params(model, params, mesh, "train")
    dbatch = place(batch, batch_specs(rules, cfg, "train", batch))
    _, _, g = steps.value_and_grad(model, dp, dbatch,
                                   policy=MeshPolicy(rules, cfg))
    names = [k for k, _ in flatten_with_paths(g)]
    mesh_errs = [float((a.full_tensor().float() - b).norm() / b.norm())
                 for a, b in zip(leaves(g), ref)]
    del g, dp, dbatch
    _, _, g = steps.value_and_grad(Transformer(cfg), _clone_tree(params),
                                   batch)
    control_errs = [float((a.float() - b).norm() / b.norm())
                    for a, b in zip(leaves(g), ref)]
    del g, ref
    _set_launch_counts(before)
    check(all(math.isfinite(e) and e <= MESH_BF16_GRAD_TOL
              for e in mesh_errs),
          f"mesh (c) bf16: gradient leaves meshed vs unmeshed: normwise "
          f"errs up to {max(mesh_errs)} > {MESH_BF16_GRAD_TOL}")
    unmeshed_ms = [r["step_ms_median"] for r in runs[:3] if r is not
                   meshed_run]
    last = plain["losses"][-1]
    report("mesh", run="train_bf16_step_ms", model=TRAIN_MODEL,
           n_layers=TRAIN_TIMED_LAYERS, batch=1, seq=TRAIN_SEQ,
           runs=runs, launches=counts,
           first_loss_rel_err=loss_err, first_loss_tol=MESH_LOSS_RTOL,
           grad_rel_err=dict(zip(names, mesh_errs)),
           grad_rel_err_max=max(mesh_errs), grad_tol=MESH_BF16_GRAD_TOL,
           grad_rel_err_plain_attention=dict(zip(names, control_errs)),
           last_loss_rel_drift=abs(meshed_run["losses"][-1] - last) / last,
           last_loss_rel_drift_plain_attention=abs(
               control["losses"][-1] - last) / last,
           dtensor_overhead_ms=meshed_run["step_ms_median"]
           - sum(unmeshed_ms) / len(unmeshed_ms),
           seconds=time.perf_counter() - t, card=smi)
    del params, batch
    torch.cuda.empty_cache()
    return counts


def _mesh_forward(mesh, name: str, smi: str) -> dict:
    """mesh (d): ``Transformer.hidden`` of ``name`` at full width, fp32,
    MESH_FORWARD_LAYERS deep, B = 1, S = 4096, with kernels on the 1×1
    mesh (each kernel on its rank's shard, under ``local_map``) against
    the unmeshed port with kernels: within MESH_HIDDEN_TOL normwise, one
    launch per layer of each kernel's kind.  Returns the meshed run's
    launches."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import MeshPolicy, distribute
    from repro_torch.models import Transformer

    t = time.perf_counter()
    cfg = dataclasses.replace(get_config(name),
                              n_layers=MESH_FORWARD_LAYERS, dtype="float32")
    gen = torch.Generator("cuda").manual_seed(0)
    model = Transformer(cfg, use_pallas=True)
    params = model.init(gen)
    _perturb_constants(params, gen)
    tokens = torch.randint(0, cfg.vocab, (1, 4096), generator=gen,
                           device="cuda", dtype=torch.int32)
    before = _launch_counts()
    want = model.hidden(params, {"tokens": tokens})       # compares
    dp, rules = _mesh_params(model, params, mesh, "prefill")
    dtok = distribute(tokens, mesh, ("data", None))
    _set_launch_counts(dict.fromkeys(_counters(), 0))     # the run starts
    got = model.hidden(dp, {"tokens": dtok}, MeshPolicy(rules, cfg))
    counts = _launch_counts()                             # ... and ends
    _set_launch_counts(before)
    got = got.full_tensor()
    err = float((got - want).norm() / want.norm())
    expect = _expected_launches(cfg, torch.float32)
    check(counts == expect, f"mesh (d) {name}: launches {counts}, want "
          f"{expect}")
    check(math.isfinite(err) and err <= MESH_HIDDEN_TOL,
          f"mesh (d) {name}: hidden meshed vs unmeshed {err} > "
          f"{MESH_HIDDEN_TOL}")
    report("mesh", run="forward_fp32_meshed_vs_unmeshed", model=name,
           n_layers=MESH_FORWARD_LAYERS, batch=1, seq=4096,
           hidden_rel_err=err, tol=MESH_HIDDEN_TOL, launches=counts,
           seconds=time.perf_counter() - t, card=smi)
    del params, dp, want, got
    torch.cuda.empty_cache()
    return counts


def _mesh_train_recurrent(mesh, name: str, smi: str) -> dict:
    """mesh (d): the gradient of one fp32 train step of ``name`` at full
    width, MESH_TRAIN_LAYERS[name] deep, B = 1, S = MESH_TRAIN_SEQ, on the
    1×1 mesh with a policy (each param placed where it meets its activation,
    the norms and the cross-entropy on the rank's shards under
    ``local_map``) against the unmeshed step: the loss within
    MESH_LOSS_RTOL, every gradient leaf within MESH_GRAD_TOL normwise.
    The step trains through the plain scans, as both packages do (wkv6
    and rglru_scan have no backward), so it launches no kernel.  Then
    ``_mesh_sums``.  Returns the meshed step's launches."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed.sharding import (MeshPolicy, batch_specs,
                                                  place)
    from repro_torch.launch import steps
    from repro_torch.models import Transformer
    from repro_torch.tree import leaves

    t = time.perf_counter()
    cfg = dataclasses.replace(get_config(name),
                              n_layers=MESH_TRAIN_LAYERS[name],
                              dtype="float32")
    gen = torch.Generator("cuda").manual_seed(0)
    model = Transformer(cfg)
    params = model.init(gen)
    _perturb_constants(params, gen)
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLM(
        cfg, 1, MESH_TRAIN_SEQ, seed=0).batch_at(0).items()}
    before = _launch_counts()
    loss_u, _, g = steps.value_and_grad(model, _clone_tree(params), batch)
    plain = leaves(g)
    dp, rules = _mesh_params(model, params, mesh, "train")
    dbatch = place(batch, batch_specs(rules, cfg, "train", batch))
    del params, g
    _set_launch_counts(dict.fromkeys(_counters(), 0))     # the run starts
    loss_m, _, g = steps.value_and_grad(model, dp, dbatch,
                                        policy=MeshPolicy(rules, cfg))
    counts = _launch_counts()                             # ... and ends
    _set_launch_counts(before)
    loss_m, loss_u = float(loss_m.full_tensor()), float(loss_u)
    rel = abs(loss_m - loss_u) / abs(loss_u)
    errs = [float((a.full_tensor() - b).norm() / b.norm())
            for a, b in zip(leaves(g), plain)]
    check(not any(counts.values()), f"mesh (d) {name} train: launches "
          f"{counts}, want none (the plain scans train)")
    check(math.isfinite(loss_m) and rel <= MESH_LOSS_RTOL,
          f"mesh (d) {name} train: meshed loss {loss_m} vs unmeshed "
          f"{loss_u}: rel err {rel} > {MESH_LOSS_RTOL}")
    check(all(math.isfinite(e) and e <= MESH_GRAD_TOL for e in errs),
          f"mesh (d) {name} train: gradient leaves meshed vs unmeshed: "
          f"normwise errs up to {max(errs)} > {MESH_GRAD_TOL}")
    del dp, dbatch, g, plain
    torch.cuda.empty_cache()
    sums = _mesh_sums(mesh, cfg)
    report("mesh", run="train_fp32_recurrent_meshed_vs_unmeshed",
           model=name, n_layers=cfg.n_layers, batch=1,
           seq=MESH_TRAIN_SEQ, loss_meshed=loss_m, loss_unmeshed=loss_u,
           loss_rel_err=rel, loss_tol=MESH_LOSS_RTOL, grad_leaves=len(errs),
           grad_rel_err_max=max(errs), grad_tol=MESH_GRAD_TOL,
           split_sums=sums, sum_tol=MESH_SUM_TOL, launches=counts,
           seconds=time.perf_counter() - t, card=smi)
    return counts


def _mesh_sums(mesh, cfg) -> dict:
    """``rms_norm`` and the cross-entropy on DTensors whose last dim is
    split over the one-rank "model" axis (``Shard`` on an axis of one:
    the model path never places one so), so their sums over that dim run
    through ``sharding.psum`` / ``pmax`` as NCCL all-reduces, forward
    and backward: outputs and input gradients against the plain
    functions, normwise, within MESH_SUM_TOL."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.models.layers import cross_entropy, rms_norm
    from repro_torch.models.transformer import _cross_entropy

    gen = torch.Generator("cuda").manual_seed(1)
    split = (Replicate(), Shard(2))
    out = {}
    for what, shape in (("rms_norm", (1, 256, cfg.d_model)),
                        ("cross_entropy", (1, 256, cfg.vocab))):
        x = torch.randn(shape, generator=gen, device="cuda")
        w = 1.0 + 0.1 * torch.randn(shape[-1:], generator=gen, device="cuda")
        labels = torch.randint(0, shape[-1], shape[:2], generator=gen,
                               device="cuda", dtype=torch.int32)
        xs = x.clone().requires_grad_(True)
        xp = x.clone().requires_grad_(True)
        ds = DTensor.from_local(xs, mesh, split, run_check=False)
        if what == "rms_norm":
            got = rms_norm(ds, DTensor.from_local(w, mesh, (Replicate(),
                                                            Replicate())))
            got = got.to_local()
            want = rms_norm(xp, w)
            (gs,), (gp,) = (torch.autograd.grad((y * y).sum(), v)
                            for y, v in ((got, xs), (want, xp)))
        else:
            got = _cross_entropy(ds, labels).full_tensor()
            want = cross_entropy(xp, labels)
            (gs,), (gp,) = (torch.autograd.grad(y, v)
                            for y, v in ((got, xs), (want, xp)))
        errs = [float((a - b).norm() / b.norm())
                for a, b in ((got.detach(), want.detach()), (gs, gp))]
        check(all(math.isfinite(e) and e <= MESH_SUM_TOL for e in errs),
              f"mesh (d): {what} split over a one-rank axis vs plain: "
              f"normwise errs (output, gradient) {errs} > {MESH_SUM_TOL}")
        out[what] = errs
    return out


def _mesh_offload(mesh, smi: str) -> dict:
    """offload_mesh (module docstring, 11 (e)): qwen2.5-14b's train cell
    on the mesh at full width, bf16, TRAIN_CUT_LAYERS deep,
    OFFLOAD_MESH_STEPS steps with Adafactor's state on the card and as
    many with it offloaded (``build_cell(offload_opt=True)``: each rank's
    shards pinned, the update's pieces streamed, the non-elementwise rule
    on DTensors), from the same params and batch (the first step of each
    run warms it; the second is the one to compare).  (a) Params and
    state bitwise equal, every offloaded array a pinned ``PinnedShard``,
    the offloaded steps counted (flash's sm90 kernel once per layer in
    each forward and once in its recompute, its sm90 backward once per
    layer a step, nothing else), each run's
    peak and step ms; (b) the
    offloaded state saved with ``CheckpointManager`` and restored by its
    offload shardings: bitwise, pinned.  Returns the counted launches."""
    import dataclasses

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.distributed.sharding import PinnedShard, local_shard
    from repro_torch.launch import steps
    from repro_torch.models import Transformer
    from repro_torch.optim import adafactor
    from repro_torch.tree import leaves

    t = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_MODEL),
                              n_layers=TRAIN_CUT_LAYERS)
    shape = ShapeSpec("train_offload", "train", TRAIN_SEQ, 1)
    params = Transformer(cfg).init(torch.Generator("cuda").manual_seed(3))
    batch = _train_batch(cfg, 2)
    want = {**dict.fromkeys(_counters(), 0),
            **_expected_launches(cfg, torch.bfloat16,
                                 n_forwards=2 * OFFLOAD_MESH_STEPS,
                                 n_backwards=OFFLOAD_MESH_STEPS)}
    before = _launch_counts()
    runs, out, counts = {}, {}, None
    default_optimizer = steps.default_optimizer
    steps.default_optimizer = lambda cfg: adafactor()
    try:
        for offload in (False, True):
            cell = steps.build_cell(cfg, shape, mesh, use_pallas=True,
                                    offload_opt=offload)
            p = _clone_tree(params)
            args = cell.place(p, adafactor().init(p), batch)
            del p
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            if offload:
                _set_launch_counts(dict.fromkeys(_counters(), 0))
            times = []
            for _ in range(OFFLOAD_MESH_STEPS):
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                new_p, new_s, metrics = cell.fn(*args)
                e1.record()
                torch.cuda.synchronize()
                times.append(e0.elapsed_time(e1))
            if offload:
                counts = _launch_counts()
            name = cell.meta["optimizer"]
            arrays = [x for x in leaves(new_s) if x.ndim]
            runs[name] = dict(
                step_ms=times,
                loss=float(metrics["loss"].full_tensor()),
                resident_before_gb=base / 1e9,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                peak_over_resident_gb=(torch.cuda.max_memory_allocated()
                                       - base) / 1e9,
                state_gb=sum(x.numel() * x.element_size()
                             for x in arrays) / 1e9,
                state_pinned=all(isinstance(x, PinnedShard)
                                 and x.is_pinned() for x in arrays))
            out[name] = (cell, new_p, new_s)
            del args, metrics, arrays
    finally:
        steps.default_optimizer = default_optimizer
    check(counts == want, f"offload_mesh: the offloaded step launched "
          f"{counts}, want {want}")
    (_, p_card, s_card), (cell, p_off, s_off) = (out["adafactor"],
                                                 out["adafactor+offload"])
    check(runs["adafactor+offload"]["state_pinned"],
          "offload_mesh: an offloaded state array is not a pinned "
          "PinnedShard")
    params_equal = all(torch.equal(a.to_local(), b.to_local())
                       for a, b in zip(leaves(p_off), leaves(p_card)))
    state_equal = all(torch.equal(local_shard(a).cpu(),
                                  local_shard(b).cpu())
                      for a, b in zip(leaves(s_off), leaves(s_card)))
    check(params_equal and state_equal, f"offload_mesh: offloaded "
          f"Adafactor differs from the on-card step (params "
          f"{params_equal}, state {state_equal})")
    del out, p_card, s_card, p_off
    torch.cuda.empty_cache()

    # (b) the offloaded state through a checkpoint and back onto the mesh
    t_ckpt = time.perf_counter()
    store = tempfile.mkdtemp(prefix="chip_smoke_ckpt-")
    try:
        mgr = CheckpointManager(store)
        mgr.save(1, s_off, blocking=True)
        back, _ = mgr.restore(1, s_off, shardings=cell.in_shardings[1])
    finally:
        shutil.rmtree(store, ignore_errors=True)
    restored = all(type(a) is type(b) and torch.equal(
        local_shard(a).cpu(), local_shard(b).cpu())
        for a, b in zip(leaves(back), leaves(s_off)))
    pinned = all(isinstance(x, PinnedShard) and x.is_pinned()
                 for x in leaves(back) if x.ndim)
    check(restored and pinned, f"offload_mesh: restored state bitwise "
          f"{restored}, pinned {pinned}")
    _set_launch_counts(before)
    report("offload_mesh", model=TRAIN_MODEL, n_layers=TRAIN_CUT_LAYERS,
           batch=1, seq=TRAIN_SEQ, optimizer="adafactor",
           params=sum(_leaf_sizes(params)), runs=runs,
           params_bitwise_equal=params_equal,
           state_bitwise_equal=state_equal, launches=counts,
           checkpoint={"restored_bitwise": restored, "pinned": pinned,
                       "seconds": time.perf_counter() - t_ckpt},
           seconds=time.perf_counter() - t, card=smi)
    del params, batch, s_off, back, cell
    torch.cuda.empty_cache()
    return counts


def _mesh_moe(mesh, smi: str) -> dict:
    """mesh (f): ``Transformer.loss`` of MESH_MOE at full width, bf16,
    MESH_MOE_LAYERS deep, B = 1, S = 4096, with kernels, its params and
    batch placed by the train rules and the MoE layer run with its policy
    on the mesh, against the unmeshed loss: within FORWARD_BF16_TOL,
    flash's sm90 kernel once per layer.  A second meshed forward and a
    second unmeshed one are timed (CUDA events; the difference is
    DTensor's host dispatch, reported, not gated).  Returns the first
    meshed run's launches."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import MeshPolicy, distribute
    from repro_torch.models import Transformer

    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(MESH_MOE), n_layers=MESH_MOE_LAYERS)
    gen = torch.Generator("cuda").manual_seed(0)
    model = Transformer(cfg, use_pallas=True)
    params = model.init(gen, dtype=torch.bfloat16)
    _perturb_constants(params, gen)
    batch = _zoo_batch(cfg, gen, 4096)
    before = _launch_counts()
    with torch.no_grad():
        want, want_m = model.loss(params, batch)           # compares
        want, want_aux = float(want), float(want_m["aux"])
        dp, rules = _mesh_params(model, params, mesh, "train")
        db = {k: distribute(v, mesh, ("data", None)) for k, v in
              batch.items()}
        policy = MeshPolicy(rules, cfg)
        _set_launch_counts(dict.fromkeys(_counters(), 0))  # the run starts
        got, got_m = model.loss(dp, db, policy)
        torch.cuda.synchronize()
        counts = _launch_counts()                           # ... and ends
        ms = {}
        for run, fn in (("meshed", lambda: model.loss(dp, db, policy)),
                        ("unmeshed", lambda: model.loss(params, batch))):
            e0, e1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            e0.record()
            fn()                                            # timed
            e1.record()
            torch.cuda.synchronize()
            ms[run] = e0.elapsed_time(e1)
    _set_launch_counts(before)
    got, aux = float(got.full_tensor()), float(got_m["aux"].full_tensor())
    err = abs(got - want) / abs(want)
    expect = _expected_launches(cfg, torch.bfloat16)
    check(counts == expect, f"mesh (f) {MESH_MOE}: launches {counts}, "
          f"want {expect}")
    check(math.isfinite(got) and err <= FORWARD_BF16_TOL,
          f"mesh (f) {MESH_MOE}: loss meshed {got} vs unmeshed {want}, "
          f"normwise {err} > {FORWARD_BF16_TOL}")
    report("mesh", run="moe_bf16_meshed_vs_unmeshed", model=MESH_MOE,
           n_layers=MESH_MOE_LAYERS, of_layers=get_config(MESH_MOE).n_layers,
           batch=1, seq=4096, loss_meshed=got, loss_unmeshed=want,
           loss_rel_err=err, router_aux_meshed=aux,
           router_aux_unmeshed=want_aux, tol=FORWARD_BF16_TOL,
           launches=counts, meshed_forward_ms=ms["meshed"],
           unmeshed_forward_ms=ms["unmeshed"],
           peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
           seconds=time.perf_counter() - t, card=smi)
    del params, dp, batch, db
    torch.cuda.empty_cache()
    return counts


def phase_mesh(smi: str) -> dict:
    """The mesh on the card (see the module docstring, 11): a world-size-1
    NCCL group, a 1×1 ("data", "model") ``DeviceMesh`` through
    ``launch.mesh.make_mesh``, parts (a)–(f), the group destroyed at the
    end.  Returns the launches of the parts' main-path runs."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group, make_mesh

    t = time.perf_counter()
    store = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh-"))
    launches = dict.fromkeys(_counters(), 0)
    init_process_group("cuda", 0, 1, str(store))
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        _mesh_3mm(mesh, smi)
        parts = [_mesh_attn_step(mesh, smi), _mesh_train(mesh, smi)]
        parts += [_mesh_forward(mesh, name, smi) for name in MESH_FORWARD]
        parts += [_mesh_train_recurrent(mesh, name, smi)
                  for name in MESH_FORWARD]
        parts.append(_mesh_offload(mesh, smi))
        parts.append(_mesh_moe(mesh, smi))
        for part in parts:
            for kernel, n in part.items():
                launches[kernel] += n
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    report("mesh", run="all", launches=launches,
           seconds=time.perf_counter() - t, card=smi)
    return launches


def phase_paper_tables(smi: str) -> None:
    """paper_tables (module docstring, 12): ``benchmarks/port_run.py`` on
    the card, each row a JSON line; every Fig. 6 row moves no more with
    the optimized plan than with the naive one, and the train row's loss
    is finite."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "benchmarks"))
    import port_run

    t = time.perf_counter()
    rows = port_run.rows("cuda")
    for name, us, derived in rows:
        report("paper_tables", name=name, us_per_call=int(us),
               derived=port_run.parse_derived(derived))
    fig6 = {name: port_run.parse_derived(d)["transfers"]
            for name, _, d in rows if name.startswith("fig6_")}
    check(len(fig6) == 10, f"paper_tables: fig6 rows {sorted(fig6)}")
    for name, tr in fig6.items():
        opt, naive = (int(x) for x in tr.split("/"))
        check(opt <= naive, f"paper_tables: {name} moves {tr}")
    train = port_run.parse_derived(rows[-1][2])
    check(rows[-1][0] == "train_overlap"
          and math.isfinite(float(train["final_loss"])),
          f"paper_tables: train row {rows[-1]}")
    report("paper_tables", run="all", rows=len(rows), sizes="default",
           seconds=time.perf_counter() - t, card=smi)


def phase_trajectory(smi: str) -> dict:
    """trajectory (module docstring, 13): ``port_directive_micro --tune
    --quick`` twice into a temporary directory, each run on its own fresh
    tune cache (so both measure), the first snapshot named a day before
    the second so the two sort as previous and current; then
    ``port_trajectory`` over that directory.  Gated: two snapshots found,
    no coverage regression.  Measured regressions between two runs on one
    card are printed, not gated.  Returns flash's launches (the attn_step
    gate program's tuning)."""
    import datetime
    import io
    import os
    from contextlib import redirect_stdout

    sys.path.insert(0, str(Path(__file__).resolve().parent / "benchmarks"))
    import port_directive_micro as dm
    import port_trajectory

    t = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_trajectory-"))
    today = datetime.date.today()
    saved = (dm.N, dm.ITERS, dm.REPS, dm.BACKEND,
             os.environ.get("REPRO_TORCH_TUNE_CACHE"))
    before = _launch_counts()
    _set_launch_counts(dict.fromkeys(_counters(), 0))
    try:
        runs = []
        for i, day in enumerate((today - datetime.timedelta(days=1),
                                 today)):
            os.environ["REPRO_TORCH_TUNE_CACHE"] = str(tmp / f"tc{i}")
            t_run = time.perf_counter()
            with redirect_stdout(io.StringIO()):
                dm.main(["--tune", "--quick", "--report",
                         str(tmp / f"report{i}.json"), "--snapshot",
                         str(tmp / f"BENCH_port_{day:%Y%m%d}.json")])
            runs.append(time.perf_counter() - t_run)
        counts = _launch_counts()
        snaps = port_trajectory.find_snapshots(str(tmp))
        prev, curr = (json.loads(Path(x).read_text()) for x in snaps[-2:])
        regressions, notes = port_trajectory.diff(prev, curr)
        with redirect_stdout(io.StringIO()) as text:
            code = port_trajectory.main(["--root", str(tmp)])
    finally:
        dm.N, dm.ITERS, dm.REPS, dm.BACKEND = saved[:4]
        if saved[4] is None:
            os.environ.pop("REPRO_TORCH_TUNE_CACHE", None)
        else:
            os.environ["REPRO_TORCH_TUNE_CACHE"] = saved[4]
        _set_launch_counts(before)
        shutil.rmtree(tmp, ignore_errors=True)
    check(len(snaps) == 2, f"trajectory: {len(snaps)} snapshots")
    coverage = [r for r in regressions if "missing now" in r]
    check(not coverage and code == 0, f"trajectory: {coverage}, exit {code}")
    report("trajectory", snapshots=[Path(x).name for x in snaps],
           programs=sorted(curr["programs"]), regressions=regressions,
           notes=notes, output=text.getvalue().splitlines(),
           measured_ms={k: [prev["programs"][k]["measured_ms"],
                            curr["programs"][k]["measured_ms"]]
                        for k in sorted(curr["programs"])},
           run_seconds=runs, launches=counts,
           seconds=time.perf_counter() - t, card=smi)
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    smi = phase_environment()
    peaks = card_peaks(torch.cuda.get_device_name(0))
    phase_build()
    rows = {**phase_kernel(peaks),
            "flash_attention_bwd_sm90": phase_flash_bwd_kernel(peaks),
            "wkv6": phase_wkv6_kernel(peaks),
            "rglru_scan": phase_rglru_kernel(peaks),
            "rmsnorm": phase_rmsnorm_kernel(peaks),
            **phase_adamw_kernel(peaks)}
    phase_polybench()
    launches = phase_attn_step()
    for name, cut in MODEL_CUTS.items():
        for kernel, n in phase_model_forward(name, cut).items():
            launches[kernel] += n
    t = time.perf_counter()
    for name, (n_layers, S) in ZOO_FORWARD.items():
        for kernel, n in phase_zoo_forward(name, n_layers, S, smi).items():
            launches[kernel] += n
    report("model_forward", run="zoo_all", seconds=time.perf_counter() - t)
    phase_serve(smi)
    for kernel, n in phase_train(smi, peaks).items():
        launches[kernel] += n
    launches["rmsnorm"] = phase_rmsnorm_path()
    launches["flash_attention"] += phase_tuner()
    for kernel, n in phase_mesh(smi).items():
        launches[kernel] += n
    phase_paper_tables(smi)
    for kernel, n in phase_trajectory(smi).items():
        launches[kernel] += n
    for name in rows:
        check(launches[name] > 0, f"the main path never launched {name}")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{SOURCES.get(name, name)}"
        ".cu", "replaces": REPLACES[name], "launches": launches[name],
        **{k: row[k] for k in ("max_abs_err", "max_norm_err") if k in row},
        "ms": row["kernel_ms"],
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
