"""The mesh on the CPU: 8 gloo ranks stand in for the reference's 8 forced
host devices (``tests/test_distributed_subprocess.py``,
``tests/test_mesh_plan.py``).

Each group of checks runs once, in a subprocess that spawns 8 ranks
(``torch.multiprocessing``) with a ``FileStore`` rendezvous under
``tmp_path`` (no TCP port), a 60 s group timeout and a
``subprocess.run`` timeout; rank 0 writes what it measured as JSON and
the tests here compare.  The reference's side runs in its own subprocess
with 8 forced devices and dumps its numbers the same way.  The dry-run
runs in one process on a fake group of 8 ranks.

Held here, on a (2, 4) ("data", "model") mesh unless said otherwise:
  * 3mm on ``MeshBackend``: ``plan(policy="auto")`` chooses a placement,
    verifies clean, executes within rtol 2e-3 of the host oracle, a warm
    repeat takes 0 measurements, and the (2, 4) and (1, 8) fingerprints
    differ; per placement, the per-device FLOPs and ``h2d_factor`` equal
    the reference's ``mesh_cost_terms``, and gemm's collective bytes are
    the ring volumes worked out by hand below;
  * the tune cache read on rank 0 alone (each rank its own cache, only
    rank 0's calibrated): every rank prices, measures and chooses alike,
    and a repeat hits everywhere; attn_step's kernel-tagged block with
    its inputs sharded, made whole before the kernel's plain version;
  * ``build_cell`` of reduced internlm2-20b: the sharded train step's
    loss within 1e-4 relative of the port's unsharded loss and within
    5e-3 of the reference's sharded loss (the reference's own bound);
    the gradients synced to their params' placements, and every param
    and optimizer-state leaf after one AdamW and one Adafactor step, leaf
    by leaf against the unsharded step and the reference's sharded one;
  * reduced rwkv6-3b and recurrentgemma-2b: the ``loss`` with a policy
    within 1e-4 of the unsharded loss, ``hidden`` with the kernels'
    plain versions on the shards (``use_pallas``) within 1e-4, and the
    gradients of two accumulated micro-batches synced to their params'
    placements, leaf by leaf against the unsharded ones;
  * decode of reduced qwen2.5-14b, recurrentgemma-2b and rwkv6-3b with
    the cache sharded (its sequence over "model"), within 1e-5 of the
    unsharded logits;
  * the MoE layer without ``moe_ep`` (reduced qwen3-moe-30b-a3b and
    arctic-480b, from the reference's weights): loss, router aux and every
    gradient against the unsharded layer and the reference's sharded one,
    and no rank holding a whole expert-weight leaf;
  * EP MoE: reduced qwen3-moe-30b-a3b at capacity factor 1000 with
    ``moe_ep`` within 5e-3 of the dense MoE loss, its gradients finite
    and nonzero (the reference's ``test_ep_moe_matches_gspmd_moe``);
  * on (4, 2) ("pod", "data"): the GPipe forward within 1e-5 of its
    sequential oracle; ``psum_compressed``'s int8 codes and shared scale
    equal to the reference's formulas on the same input and its result
    within 1e-6 of the reference's; error feedback within 5e-3 of exact
    SGD;
  * the cross-pod gradient average (``grad_sync``), exact and int8;
    ``PrefetchIterator(shardings=)`` placing each batch by its spec;
  * elastic re-mesh: saved under (4, 2), restored under (2, 4) with
    other placements, values equal and files byte-identical to the
    reference's;
  * the dry-run of four reduced archs × train / decode on a fake (2, 4)
    group: records written, ``dropped`` equal to the reference cell's;
    one cell on ``make_production_mesh``'s 16×16 mesh over a fake group
    of 256 ranks.
"""
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
DRY_ARCHS = ("internlm2-20b", "qwen3-moe-30b-a3b", "recurrentgemma-2b",
             "rwkv6-3b")
MOE_ARCHS = ("qwen3-moe-30b-a3b", "arctic-480b")
N = 64                     # the polybench size of the 3mm / gemm checks
# each subprocess's limit: alone the reference's side takes ~20 s, the two
# spawns ~15 s and ~45 s and the dry-run ~60 s, but they share the
# machine with the rest of the suite (173 s for all four in a full run
# with 6 workers, against 96 s alone)
JOB_TIMEOUT = 600
# a calibration only rank 0's tune cache holds (far from the defaults)
CALIBRATION = {"pcie_bw": 1.0e6, "launch_overhead_s": 1.0e-3,
               "sync_overhead_s": 1.0e-3}
# normwise per leaf, after one step: fp32 sums taken in another order put
# the state 3e-5 from the unsharded step and 7e-5 from the reference's (a
# sum taken as a mean, or a leaf left unreduced, is off by 0.5 or more);
# "ref" is the port-to-reference state bound of tests/test_torch_train.py
OPT_TOL = {"plain": 1e-4, "ref": 1e-3}


def _normwise(a, b) -> float:
    """‖a − b‖ / ‖b‖ in float64 (0 where both are 0)."""
    a, b = (np.asarray(x, np.float64) for x in (a, b))
    den = np.linalg.norm(b)
    num = np.linalg.norm(a - b)
    return float(num / den) if den else float(num)


# ---------------------------------------------------------------------------
# The reference's side: 8 forced host devices, in its own subprocess
# ---------------------------------------------------------------------------

_REF = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config, reduced, ShapeSpec
from repro.core.analysis import analyze
from repro.distributed.collectives import psum_compressed
from repro.distributed.mesh_backend import (MeshBackend, mesh_cost_terms,
                                            placement_specs)
from repro.launch.mesh import make_mesh
from repro.launch.steps import build_cell
from repro.models import Transformer
from repro.optim import default_optimizer
from repro.polybench import build
from repro.checkpoint import CheckpointManager
out_dir = sys.argv[1]
res = {}

# mesh_cost_terms of 3mm, per placement
be = MeshBackend(shape=(2, 4))
p, _ = build("3mm", n=%(N)d)
an = analyze(p)
res["cost"] = {}
for pol in ("replicate", "fsdp", "tp"):
    specs, _ = placement_specs(an.shapes, be.mesh, pol)
    c = mesh_cost_terms(p, an.shapes, be, specs)
    res["cost"][pol] = {"flops": {str(k): v for k, v in
                                  c["flops_by_block"].items()},
                        "h2d": c["h2d_factor"]}

# the sharded train step of reduced internlm2-20b
cfg = reduced(get_config("internlm2-20b"))
mesh = make_mesh((2, 4), ("data", "model"))
cell = build_cell(cfg, ShapeSpec("t", "train", 32, 8), mesh)
with mesh:
    fn = cell.jitted()
model = Transformer(cfg)
params = model.init(jax.random.key(0))
opt_state = default_optimizer(cfg).init(params)
rng = np.random.default_rng(0)
batch = {"tokens": rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32)}
np.savez(os.path.join(out_dir, "ref_batch.npz"), **batch)
flat = jax.tree_util.tree_flatten_with_path(params)[0]
np.savez(os.path.join(out_dir, "ref_params.npz"),
         **{"/".join(k.key for k in path): np.asarray(v)
            for path, v in flat})


def dump(name, tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    np.savez(os.path.join(out_dir, name),
             **{"/".join(str(k.key) for k in path): np.asarray(v)
                for path, v in flat})


jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
with mesh:
    new_p, new_s, metrics = fn(params, opt_state, jbatch)
res["sharded_loss"] = float(metrics["loss"])
dump("ref_adamw.npz", {"params": new_p, "opt": new_s})

# the same sharded step with Adafactor (arctic-480b's optimizer)
import repro.launch.steps as ref_steps
from repro.optim import adafactor
ref_steps.default_optimizer = lambda cfg: adafactor()
cell = build_cell(cfg, ShapeSpec("t", "train", 32, 8), mesh)
with mesh:
    fn = cell.jitted()
params = model.init(jax.random.key(0))     # the first copy was donated
with mesh:
    new_p, new_s, _ = fn(params, adafactor().init(params), jbatch)
dump("ref_adafactor.npz", {"params": new_p, "opt": new_s})

# psum_compressed over "pod" of a (4, 2) mesh, and its codes and scale
pmesh = make_mesh((4, 2), ("pod", "data"))
g = np.random.default_rng(1).standard_normal((4, 256)).astype(np.float32)
with pmesh:
    summed = shard_map(lambda x: psum_compressed(x, "pod"), mesh=pmesh,
                       in_specs=(P("pod"),), out_specs=P("pod"),
                       check_rep=False)(jnp.asarray(g))
scale = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(g))) / 127.0, 1e-12)
q = jnp.clip(jnp.round(jnp.asarray(g) / scale), -127, 127).astype(jnp.int8)
np.savez(os.path.join(out_dir, "ref_psum.npz"), summed=np.asarray(summed),
         codes=np.asarray(q), scale=np.asarray(scale))

# a checkpoint saved under (4, 2)
mesh_a = make_mesh((4, 2), ("data", "model"))
tree = {"w": jax.device_put(jnp.arange(64, dtype=jnp.float32).reshape(8, 8),
                            NamedSharding(mesh_a, P("data", "model")))}
CheckpointManager(os.path.join(out_dir, "ckpt_ref")).save(1, tree,
                                                          blocking=True)

# the MoE layer on the mesh (no moe_ep): loss, router aux and gradients
# of reduced qwen3-moe-30b-a3b and arctic-480b, sharded by the train rules
from repro.distributed.sharding import (MeshPolicy, batch_specs, make_rules,
                                        tree_shardings)
res["moe"] = {}
for arch in %(MOE)r:
    c = reduced(get_config(arch))
    m = Transformer(c)
    prm = m.init(jax.random.key(0))
    rules = make_rules(mesh, "train")
    pol = MeshPolicy(rules, c)
    mrng = np.random.default_rng(2)
    b = {k: mrng.integers(0, c.vocab, (8, 32)).astype(np.int32)
         for k in ("tokens", "labels")}
    f = jax.jit(lambda p, bb: jax.value_and_grad(m.loss, has_aux=True)(
        p, bb, pol), in_shardings=(tree_shardings(rules, prm,
                                                  m.logical_axes()),
                                   batch_specs(rules, c, "train", b)))
    with mesh:
        (loss, met), grads = f(prm, {k: jnp.asarray(v) for k, v in b.items()})
    dump(f"ref_moe_{arch}.npz", {"params": prm, "grads": grads})
    np.savez(os.path.join(out_dir, f"ref_moe_{arch}_batch.npz"), **b)
    res["moe"][arch] = {"loss": float(loss), "aux": float(met["aux"])}

# the dropped records of the dry-run's cells
res["dropped"] = {}
for arch in %(DRY)r:
    c = reduced(get_config(arch))
    for sh in (ShapeSpec("t", "train", 64, 8), ShapeSpec("d", "decode", 64, 8)):
        cell = build_cell(c, sh, mesh)
        res["dropped"][arch + "/" + sh.kind] = [list(d) for d in
                                               cell.meta["dropped"]]
json.dump(res, open(os.path.join(out_dir, "ref.json"), "w"))
"""


def _run(name, args, timeout, env_extra=None):
    """Start one side of the checks (``name`` says which in a failure):
    its own environment, the caller's ``TMPDIR``, one thread per
    process.  ``timeout`` counts from this start."""
    env = {"PYTHONPATH": SRC, "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", "/tmp"), "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1", **(env_extra or {})}
    if "TMPDIR" in os.environ:
        env["TMPDIR"] = os.environ["TMPDIR"]
    return (name, subprocess.Popen(args, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True,
                                   env=env, start_new_session=True),
            time.monotonic() + timeout)


def _wait(job):
    name, proc, deadline = job
    t0 = time.monotonic()
    try:
        out, err = proc.communicate(timeout=max(deadline - t0, 1.0))
    except subprocess.TimeoutExpired:
        # the whole session: a spawn's ranks hold the pipes open too
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"the {name} side timed out (its limit counts "
                             f"from its start):\n{out[-3000:]}\n"
                             f"{err[-6000:]}")
    assert proc.returncode == 0, (
        f"the {name} side exited {proc.returncode}:\nstdout:\n"
        f"{out[-3000:]}\nstderr:\n{err[-6000:]}")
    return out


@pytest.fixture(scope="module")
def gloo():
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_gloo_available()):
        pytest.skip("this torch has no gloo backend: the multi-rank gate "
                    "cannot run here")


@pytest.fixture(scope="module")
def runs(gloo, tmp_path_factory):
    """Every group of checks, run once: the reference's side first (the
    port's train cell reads its weights), then the two 8-rank spawns and
    the dry-run side by side."""
    tmp = tmp_path_factory.mktemp("mesh")
    _wait(_run("reference", [sys.executable, "-c",
                             _REF % {"N": N, "DRY": DRY_ARCHS,
                                     "MOE": MOE_ARCHS}, str(tmp)],
               JOB_TIMEOUT))
    jobs = [_run(case, [sys.executable, __file__, case, str(tmp)],
                 JOB_TIMEOUT,
                 {"REPRO_TORCH_TUNE_CACHE": str(tmp / f"tc_{case}")})
            for case in ("dm", "pd", "dry")]
    for job in jobs:
        _wait(job)
    return {"dir": tmp, "ref": json.loads((tmp / "ref.json").read_text()),
            **{c: json.loads((tmp / f"{c}.json").read_text())
               for c in ("dm", "pd", "dry")}}


# ---------------------------------------------------------------------------
# The port's side: the 8 ranks of one spawn
# ---------------------------------------------------------------------------

def _case_dm(rank, tmp, out):
    """(2, 4) ("data", "model"): the mesh backend, the sharded cells."""
    import dataclasses

    import torch
    from repro_torch.configs import ShapeSpec, get_config, reduced
    from repro_torch.core import execute, plan, run_host_oracle, verify_plan
    from repro_torch.core.analysis import analyze
    from repro_torch.core.tunecache import backend_fingerprint
    from repro_torch.distributed.mesh_backend import (
        DEFAULT_PLACEMENTS, MeshBackend, mesh_cost_terms, placement_specs)
    from repro_torch.distributed.sharding import (MeshPolicy, distribute,
                                                  make_rules, tree_shardings,
                                                  NamedSharding)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_cell
    import torch.distributed as dist
    from repro_torch.distributed.sharding import (batch_specs, is_dtensor,
                                                  local_shard, place)
    from repro_torch.launch import steps
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import Transformer, params_from_numpy
    from repro_torch.optim import adafactor, adamw, default_optimizer
    from repro_torch.optim.adamw import synced
    from repro_torch.polybench import build
    from repro_torch.tree import flatten_with_paths, leaves, unflatten

    # -- 3mm on the mesh backend --------------------------------------------
    be = MeshBackend(device="cpu")
    p, _ = build("3mm", n=N)
    tuned = plan(p, policy="auto", backend=be, reps=1)
    mesh_rec = tuned.meta.get("mesh") or {}
    got, _ = execute(tuned, backend=be)
    oracle = run_host_oracle(p)
    p2, _ = build("3mm", n=N)
    warm = plan(p2, policy="auto", backend=be, reps=1)
    be18 = MeshBackend(device="cpu", shape=(1, 8))
    out["3mm"] = {
        "placement": mesh_rec.get("placement"),
        "verify_ok": verify_plan(tuned).ok,
        "close": bool(np.allclose(np.asarray(got["out"]), oracle["out"],
                                  rtol=2e-3)),
        "warm": warm.meta["tuning_cache"],
        "warm_mesh_same": warm.meta.get("mesh") == tuned.meta.get("mesh"),
        "fp": [backend_fingerprint(be), backend_fingerprint(be18)],
    }
    an = analyze(p)
    out["cost"] = {}
    for pol in DEFAULT_PLACEMENTS:
        specs, _ = placement_specs(an.shapes, be.mesh, pol)
        c = mesh_cost_terms(p, an.shapes, be, specs)
        out["cost"][pol] = {"flops": {str(k): v for k, v in
                                      c["flops_by_block"].items()},
                            "h2d": c["h2d_factor"]}
    g, _ = build("gemm", n=N, iters=2)
    gan = analyze(g)
    out["gemm_coll"] = {}
    for pol in ("fsdp", "tp"):
        specs, _ = placement_specs(gan.shapes, be.mesh, pol)
        out["gemm_coll"][pol] = mesh_cost_terms(
            g, gan.shapes, be, specs)["coll_by_block"][0]

    mesh = be.mesh

    def placed(model, params, kind="train"):
        rules = make_rules(mesh, kind)
        sh = tree_shardings(rules, params, model.logical_axes())
        flat = leaves(sh, is_leaf=lambda x: isinstance(x, NamedSharding))
        return unflatten(params, [distribute(t, mesh, s.spec) for t, s
                                  in zip(leaves(params), flat)]), rules

    def batch_of(cfg, B=8, S=32, seed=1):
        gen = torch.Generator().manual_seed(seed)
        tok = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                            dtype=torch.int32)
        lab = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                            dtype=torch.int32)
        return {"tokens": tok, "labels": lab}

    # -- the sharded train cell of reduced internlm2-20b ---------------------
    cfg = reduced(get_config("internlm2-20b"))
    ref = np.load(os.path.join(tmp, "ref_params.npz"))
    tree = {}
    for key in ref.files:
        node = tree
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = ref[key]
    params = params_from_numpy(tree, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             np.load(os.path.join(tmp, "ref_batch.npz")).items()}
    cell = build_cell(cfg, ShapeSpec("t", "train", 32, 8), mesh)
    opt = default_optimizer(cfg)
    args = cell.place(params, opt.init(params), batch)
    unsharded = float(Transformer(cfg).loss(params, batch)[0])
    _, _, metrics = cell.fn(*args)
    out["train"] = {"sharded": float(metrics["loss"].full_tensor()),
                    "unsharded": unsharded,
                    "dropped": [list(d) for d in cell.meta["dropped"]]}

    # the gradients at their params' placements (the data-parallel sync)
    # against the unsharded ones, leaf by leaf
    model = Transformer(cfg)
    dp, rules = placed(model, params_from_numpy(tree, "cpu"))
    db = place(batch, batch_specs(rules, cfg, "train", batch))
    _, _, g = value_and_grad(model, dp, db, policy=MeshPolicy(rules, cfg))
    gs = synced(leaves(g), leaves(dp))
    _, _, gu = value_and_grad(model, params_from_numpy(tree, "cpu"), batch)
    out["grads"] = {
        "placed": all(tuple(a.placements) == tuple(p.placements)
                      for a, p in zip(gs, leaves(dp))),
        "errs": [_normwise(a.full_tensor().numpy(), b.numpy())
                 for a, b in zip(gs, leaves(gu))]}

    # one step of each optimizer, sharded and unsharded, from the same
    # weights: params and state after it, for the tests to hold leaf by
    # leaf against each other and against the reference's sharded step
    for name, make in (("adamw", adamw), ("adafactor", adafactor)):
        steps.default_optimizer = lambda cfg, make=make: make()
        for meshed in (True, False):
            cell = build_cell(cfg, ShapeSpec("t", "train", 32, 8),
                              mesh if meshed else None)
            p = params_from_numpy(tree, "cpu")
            new_p, new_s, _ = cell.fn(*cell.place(p, make().init(p), batch))
            got = {k: (v.full_tensor() if is_dtensor(v) else v).detach().numpy()
                   for k, v in flatten_with_paths({"params": new_p,
                                                   "opt": new_s})}
            if rank == 0:
                np.savez(os.path.join(
                    tmp, f"port_{name}_{'sharded' if meshed else 'plain'}"
                    ".npz"), **got)

    # the offloaded optimizer on the mesh: each rank's state as its own
    # host shards (PinnedShards in host memory, as offload leaves them on
    # a card), the update's pieces run with plain copies for the streams
    from torch.distributed.tensor import Shard
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.sharding import PinnedShard
    from repro_torch.optim.offload import _sharded_state
    from repro_torch.tree import tree_map

    def host(sh):
        return tree_map(lambda s: dataclasses.replace(
            s, memory_kind="pinned_host"), sh,
            is_leaf=lambda x: isinstance(x, NamedSharding))

    def as_cell(got, want):
        """The leaves of the offloaded init whose placement differs from
        the cell's offloaded state's: local and global shape, placements,
        memory kind, zeros."""
        bad = []
        for (k, a), b in zip(flatten_with_paths(got), leaves(want)):
            if isinstance(b, PinnedShard):
                ok = isinstance(a, PinnedShard) and (
                    a.shape, a.global_shape, a.placements,
                    a.sharding.memory_kind) == (
                    b.shape, b.global_shape, b.placements,
                    b.sharding.memory_kind)
            else:
                ok = is_dtensor(a) and a.placements == b.placements
            if not (ok and torch.equal(local_shard(a), local_shard(b))):
                bad.append(k)
        return bad

    def host_step(c, make, seed_tree=None, b=batch):
        """One offloaded step from the offloaded init's host shards."""
        steps.default_optimizer = lambda cfg, make=make: make()
        cell = build_cell(c, ShapeSpec("t", "train", 32, 8), mesh,
                          offload_opt=True)
        p = params_from_numpy(seed_tree, "cpu") if seed_tree is not None \
            else Transformer(c).init(torch.Generator().manual_seed(0),
                                     device="cpu")
        o_sh = host(cell.in_shardings[1])
        pp, _, pb = cell.place(p, make().init(p), b)
        state = _sharded_state(make(), pp)
        init_bad = as_cell(state, place(make().init(p), o_sh))
        new_p, new_s, m = cell.fn(pp, state, pb)
        return cell, new_p, new_s, m, o_sh, init_bad

    out["offload"] = {}
    for name, make in (("adamw", adamw), ("adafactor", adafactor)):
        cell, new_p, new_s, _, o_sh, init_bad = host_step(cfg, make, tree)
        arrays = [t for t in leaves(new_s) if t.ndim]
        got = {k: (v.full_tensor() if is_dtensor(v) else v.full()
                   if isinstance(v, PinnedShard) else v).detach().numpy()
               for k, v in flatten_with_paths({"params": new_p,
                                               "opt": new_s})}
        out["offload"][name] = {
            "optimizer": cell.meta["optimizer"], "init_bad": init_bad,
            "host_shards": all(isinstance(t, PinnedShard) for t in arrays),
            "local": [tuple(t.shape) != tuple(t.global_shape)
                      for t in arrays if any(isinstance(pl, Shard)
                                             for pl in t.placements)]}
        if rank == 0:
            np.savez(os.path.join(tmp, f"port_{name}_offload.npz"), **got)

        # a checkpoint of the host shards against the same values saved
        # unsharded: rank 0 writes both, every rank gets its shard back
        if name == "adafactor":
            whole = tree_map(lambda t: t.full() if isinstance(
                t, PinnedShard) else t.full_tensor(), new_s)
            shards = place(whole, o_sh)
            mgr = CheckpointManager(os.path.join(tmp, "ckpt_shards"))
            mgr.save(1, shards, blocking=True)
            if rank == 0:
                CheckpointManager(os.path.join(tmp, "ckpt_whole")).save(
                    1, whole, blocking=True)
            dist.barrier()
            back, _ = mgr.restore(1, shards, shardings=o_sh)
            again, _ = mgr.restore(1, shards)
            same = []
            for a, b, c2 in zip(leaves(shards), leaves(back), leaves(again)):
                # a target PinnedShard places itself; the step's DTensor
                # needs the shardings
                for x in (b, c2) if isinstance(a, PinnedShard) else (b,):
                    same.append(type(x) is type(a) and torch.equal(
                        local_shard(x), local_shard(a)) and (
                        not isinstance(a, PinnedShard)
                        or (x.global_shape == a.global_shape
                            and x.sharding == a.sharding)))
            every = [None] * 8
            dist.all_gather_object(every, all(same))
            out["offload_ckpt"] = {
                "restored": every,
                "global_shapes": {k: list(v.shape) for k, v in
                                  flatten_with_paths(whole)}}

    # arctic-480b's own optimizer (Adafactor: the published config's
    # parameter count; the reduced one's would give AdamW) offloaded on
    # the mesh through build_cell, on its reduced config
    from repro_torch.optim import default_optimizer as dflt
    arctic = get_config("arctic-480b")
    ca = reduced(arctic)
    cell, new_p, new_s, m, _, init_bad = host_step(
        ca, lambda: dflt(arctic), b=batch_of(ca))
    out["offload_arctic"] = {
        "optimizer": cell.meta["optimizer"], "init_bad": init_bad,
        "loss": float(m["loss"].full_tensor()),
        "finite": all(bool(torch.isfinite(t.full_tensor()).all())
                      for t in leaves(new_p)),
        "host_shards": all(isinstance(t, PinnedShard)
                           for t in leaves(new_s) if t.ndim)}
    steps.default_optimizer = default_optimizer

    # the tune cache read on rank 0 alone: each rank its own cache, only
    # rank 0's holding a calibration; every rank must price, measure and
    # choose alike, and a repeat hits on every rank
    from repro_torch.core import TuneCache
    from repro_torch.core.tunecache import device_class_key
    from repro_torch.core.tuner import HW
    tc = TuneCache(os.path.join(tmp, f"tc_rank{rank}"))
    if rank == 0:
        tc.store_calibration(device_class_key(be), HW, CALIBRATION)
    runs = []
    for _ in range(2):
        pl = plan(build("3mm", n=N)[0], policy="auto", backend=be, cache=tc,
                  reps=1, top_k=2)
        t = pl.meta["tuning"]
        runs.append({"hw": {k: t["hw"][k] for k in CALIBRATION},
                     "chosen": t["chosen"],
                     "order": [r["label"] for r in t["candidates"]],
                     "measured": [r["measured_s"] for r in t["candidates"]],
                     **{k: pl.meta["tuning_cache"][k]
                        for k in ("hit", "measurements")}})
    every = [None] * 8
    dist.all_gather_object(every, runs)
    out["rank0_cache"] = every

    # a kernel-tagged block on the mesh: attn_step with q, k, v sharded
    # along the sequence, made whole before flash's plain version runs
    from repro_torch.optim import attention_step_program
    prog = attention_step_program(1)
    seq = {v: (None, "model") for v in ("q", "k", "v")}
    res, _ = execute(plan(prog), backend=be.with_placement(seq))
    want = run_host_oracle(prog)["final_loss"]
    out["attn_step"] = float(np.abs(np.asarray(res["final_loss"]) - want).max()
                             / np.abs(want).max())

    # -- rwkv6-3b and recurrentgemma-2b under a policy -------------------------
    out["recurrent"] = {}
    for name in ("rwkv6-3b", "recurrentgemma-2b"):
        c = reduced(get_config(name))
        model = Transformer(c)
        prm = model.init(torch.Generator().manual_seed(0), device="cpu")
        dp, rules = placed(model, prm)
        b = batch_of(c)
        db = {k: distribute(v, mesh, ("data", None)) for k, v in b.items()}
        pol = MeshPolicy(rules, c)
        want = float(model.loss(prm, b)[0])
        got = float(model.loss(dp, db, pol)[0].full_tensor())
        kern = Transformer(c, use_pallas=True)
        hd = kern.hidden(dp, db, pol).full_tensor()
        hw = kern.hidden(prm, b)
        # the gradients of two accumulated micro-batches, synced to their
        # params' placements, against the unsharded ones, leaf by leaf,
        # from weights moved off the init (whose zero leaves would leave
        # the low-rank and conv gradients zero)
        gen = torch.Generator().manual_seed(2)
        perturbed = unflatten(prm, [t + 0.02 * torch.randn(
            t.shape, generator=gen) for t in leaves(prm)])
        gp, _ = placed(model, perturbed)
        _, _, g = value_and_grad(model, gp, db, grad_accum=2, policy=pol)
        gs = synced(leaves(g), leaves(gp))
        _, _, gu = value_and_grad(model, unflatten(prm, [
            t.detach().clone() for t in leaves(perturbed)]), b, grad_accum=2)
        out["recurrent"][name] = {
            "loss": got, "unsharded": want,
            "hidden_err": float((hd - hw).abs().max()
                                / hw.abs().max()),
            "grads_placed": all(tuple(a.placements) == tuple(p.placements)
                                for a, p in zip(gs, leaves(gp))),
            "grad_errs": {k: _normwise(a.full_tensor().numpy(), u.numpy())
                          for (k, u), a in zip(flatten_with_paths(gu), gs)}}

    # -- decode on the mesh: the cache sharded, its sequence over "model" ----
    from repro_torch.distributed.sharding import cache_shardings, place
    out["decode"] = {}
    for name in ("qwen2.5-14b", "recurrentgemma-2b", "rwkv6-3b"):
        c = reduced(get_config(name))
        model = Transformer(c)
        prm = model.init(torch.Generator().manual_seed(0), device="cpu")
        dp, rules = placed(model, prm, "decode")
        cache = model.init_cache(8, 64, device="cpu")
        dcache = place(model.init_cache(8, 64, device="cpu"),
                       cache_shardings(rules, cache))
        pol = MeshPolicy(rules, c)
        gen = torch.Generator().manual_seed(1)
        err = 0.0
        for t in range(5):
            tok = torch.randint(0, c.vocab, (8,), generator=gen,
                                dtype=torch.int32)
            pos = torch.full((8,), t, dtype=torch.int32)
            want, cache = model.decode_step(prm, cache, {"tokens": tok}, pos)
            got, dcache = model.decode_step(
                dp, dcache, {"tokens": distribute(tok, mesh, ("data",))},
                distribute(pos, mesh, ("data",)), pol)
            err = max(err, float((got.full_tensor() - want).abs().max()
                                 / want.abs().max()))
        out["decode"][name] = err

    # -- the prefetch iterator with shardings ----------------------------------
    from repro_torch.data import PrefetchIterator, SyntheticLM
    from repro_torch.distributed.sharding import batch_specs
    src = SyntheticLM(cfg, 8, 32, seed=3)
    it = PrefetchIterator(src, shardings=batch_specs(
        make_rules(mesh, "train"), cfg, "train", src.batch_at(0)))
    try:
        got = next(it)
    finally:
        it.close()
    want = src.batch_at(0)
    out["prefetch"] = {
        "equal": all(np.array_equal(got[k].full_tensor().numpy(), want[k])
                     for k in want),
        "local_rows": [int(got[k].to_local().shape[0]) for k in sorted(got)]}

    # -- the MoE layer on the mesh (no moe_ep): its dispatch buffer split by
    # experts over "model", the expert weights at their own placements ------
    out["moe"] = {}
    for name in MOE_ARCHS:
        c = reduced(get_config(name))
        model = Transformer(c)
        ref = np.load(os.path.join(tmp, f"ref_moe_{name}.npz"))
        mtree = {}
        for key in ref.files:
            if not key.startswith("params/"):
                continue
            node = mtree
            *path, leaf = key.split("/")[1:]
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = ref[key]
        b = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(
            tmp, f"ref_moe_{name}_batch.npz")).items()}
        dp, rules = placed(model, params_from_numpy(mtree, "cpu"))
        db = place(b, batch_specs(rules, c, "train", b))
        loss, met, g = value_and_grad(model, dp, db,
                                      policy=MeshPolicy(rules, c))
        lu, mu, gu = value_and_grad(model, params_from_numpy(mtree, "cpu"), b)
        n_model = mesh.size(mesh.mesh_dim_names.index("model"))
        local = [list(local_shard(t).shape) for k, t in
                 flatten_with_paths({"params": dp, "grads": g})
                 if "/experts/" in k]
        every = [None] * 8
        dist.all_gather_object(every, local)
        E = c.n_experts
        out["moe"][name] = {
            "loss": float(loss.full_tensor()), "unsharded": float(lu),
            "aux": float(met["aux"].full_tensor()),
            "aux_unsharded": float(mu["aux"]),
            # every rank holds E / n_model experts of each expert leaf (the
            # layers dim first, then the experts)
            "experts_split": all(sh[1] == E // n_model for r in every
                                 for sh in r) and len(every[0]) == 6}
        for tag, tree in (("sharded", g), ("plain", gu)):
            # every rank gathers (a collective), rank 0 writes
            got = {k: (v.full_tensor() if is_dtensor(v) else v)
                   .detach().numpy() for k, v in flatten_with_paths(tree)}
            if rank == 0:
                np.savez(os.path.join(tmp, f"port_moe_{name}_{tag}.npz"),
                         **got)

    # -- expert-parallel MoE ---------------------------------------------------
    c = dataclasses.replace(reduced(get_config("qwen3-moe-30b-a3b")),
                            capacity_factor=1000.0)
    ep = Transformer(c, moe_ep=True)
    prm = ep.init(torch.Generator().manual_seed(0), device="cpu")
    dp, rules = placed(ep, prm)
    for t in leaves(dp):
        t.requires_grad_(True)
    b = batch_of(c)
    db = {k: distribute(v, mesh, ("data", None)) for k, v in b.items()}
    loss, _ = ep.loss(dp, db, MeshPolicy(rules, c))
    grads = torch.autograd.grad(loss, leaves(dp))
    norms = [float(g.full_tensor().norm()) for g in grads]
    out["ep"] = {"loss": float(loss.full_tensor()),
                 "dense": float(Transformer(c).loss(prm, b)[0]),
                 "grads_finite": bool(np.all(np.isfinite(norms))),
                 "grads_nonzero": sum(n > 0 for n in norms),
                 "n_grads": len(norms)}


def _case_pd(rank, tmp, out):
    """(4, 2) ("pod", "data"): the pipeline, the compressed sum, error
    feedback; and the elastic re-mesh between (4, 2) and (2, 4)."""
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.collectives import (ErrorFeedback,
                                                     compress_codes,
                                                     dequantize_int8,
                                                     psum_compressed,
                                                     quantize_int8)
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.distributed.sharding import (NamedSharding, distribute,
                                                  placements)
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((4, 2), ("pod", "data"), device="cpu")
    pod = mesh.get_local_rank("pod")

    rng = np.random.default_rng(0)
    W = torch.from_numpy(
        (rng.standard_normal((4, 16, 16)) * 0.3).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    y = pipeline_forward(mesh, lambda w, mb: torch.tanh(mb @ w), 4)(W, x)
    want = x
    for i in range(4):
        want = torch.tanh(want @ W[i])
    out["pipeline_err"] = float((y - want).abs().max())

    g = np.random.default_rng(1).standard_normal((4, 256)).astype(np.float32)
    grp = mesh.get_group("pod")
    codes, scale = compress_codes(torch.from_numpy(g[pod]), grp)
    summed = psum_compressed(torch.from_numpy(g[pod]), grp)
    np.savez(os.path.join(tmp, f"pd_rank{rank}.npz"), pod=pod,
             codes=codes.numpy(), scale=scale.numpy(),
             summed=summed.numpy())

    if rank == 0:
        def compress(t):
            q, s = quantize_int8(t)
            return dequantize_int8(q, s)
        w = torch.ones(64) * 5.0
        w_exact = torch.ones(64) * 5.0
        err = ErrorFeedback.init({"w": w})
        for _ in range(200):
            comp, err = ErrorFeedback.apply({"w": 2 * w}, err, compress)
            w = w - 0.01 * comp["w"]
            w_exact = w_exact - 0.01 * (2 * w_exact)
        out["ef_gap"] = float((w - w_exact).abs().max())

    from repro_torch.distributed.collectives import grad_sync
    gs = np.random.default_rng(2).standard_normal((4, 32)).astype(np.float32)
    synced = {c: grad_sync(mesh, compressed=c)(
        {"g": torch.from_numpy(gs[pod])})["g"].numpy() for c in (True, False)}
    out["grad_sync"] = {
        "exact_err": float(np.abs(synced[False] - gs.mean(0)).max()),
        "compressed_err": float(np.abs(synced[True] - gs.mean(0)).max()
                                / np.abs(gs).max())}

    mesh_a = make_mesh((4, 2), ("data", "model"), device="cpu")
    full = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    tree = {"w": distribute(full, mesh_a, ("data", "model"))}
    mgr = CheckpointManager(os.path.join(tmp, "ckpt_port"))
    mgr.save(1, tree, blocking=True)
    mesh_b = make_mesh((2, 4), ("data", "model"), device="cpu")
    sh_b = {"w": NamedSharding(mesh_b, ("model", None))}
    restored, _ = mgr.restore(1, tree, shardings=sh_b)
    out["elastic"] = {
        "equal": bool(torch.equal(restored["w"].full_tensor(), full)),
        "placements": repr(restored["w"].placements),
        "want": repr(placements(mesh_b, ("model", None))),
        "mesh": list(restored["w"].device_mesh.mesh.shape)}


def _worker(rank, case, tmp):
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_process_group
    init_process_group("cpu", rank, 8, os.path.join(tmp, "store_" + case))
    import torch.distributed as dist
    out = {}
    try:
        {"dm": _case_dm, "pd": _case_pd}[case](rank, tmp, out)
        if rank == 0:
            Path(tmp, f"{case}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _dry(tmp):
    """The dry-run on a fake (2, 4) group, in this one process."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.dryrun import run_cell
    recs = {}
    for arch in DRY_ARCHS:
        for sh in (ShapeSpec("t", "train", 64, 8),
                   ShapeSpec("d", "decode", 64, 8)):
            rec = run_cell(arch, sh, "2x4", Path(tmp, "dry"), small=True)
            recs[arch + "/" + sh.kind] = rec
    # a cell on the production mesh: make_production_mesh's DeviceMesh
    # over a fake group of its 256 ranks
    from repro_torch.launch.mesh import make_production_mesh
    rec = run_cell("internlm2-20b", ShapeSpec("t", "train", 64, 64),
                   "single", Path(tmp, "dry"), small=True)
    mesh = make_production_mesh(device="cpu")
    prod = {"status": rec["status"], "n_devices": rec["n_devices"],
            "mesh": type(mesh).__name__, "shape": list(mesh.mesh.shape),
            "axes": list(mesh.mesh_dim_names)}
    written = sorted(p.name for p in Path(tmp, "dry").glob("*.json"))
    Path(tmp, "dry.json").write_text(json.dumps(
        {"records": recs, "written": written, "production": prod},
        default=str))


if __name__ == "__main__":
    case, tmp = sys.argv[1], sys.argv[2]
    if case == "dry":
        _dry(tmp)
    else:
        import torch.multiprocessing as mp
        mp.spawn(_worker, args=(case, tmp), nprocs=8)


# ---------------------------------------------------------------------------
# The checks
# ---------------------------------------------------------------------------

def test_3mm_plan_on_the_mesh_backend(runs):
    r = runs["dm"]["3mm"]
    assert r["placement"] in ("replicate", "fsdp", "tp")
    assert r["verify_ok"] and r["close"]
    assert r["warm"]["hit"] is True and r["warm"]["measurements"] == 0
    assert r["warm_mesh_same"]


def test_mesh_fingerprint_separates_mesh_shapes(runs):
    fp24, fp18 = runs["dm"]["3mm"]["fp"]
    assert fp24 != fp18
    assert fp24.endswith(":meshdata2xmodel4")
    assert fp18.endswith(":meshdata1xmodel8")


@pytest.mark.parametrize("policy", ["replicate", "fsdp", "tp"])
def test_placement_cost_terms_match_reference(runs, policy):
    """Per-device FLOPs of each block and the PCIe factors of each
    variable equal the reference's ``mesh_cost_terms`` (read off its
    partitioned HLO)."""
    assert runs["dm"]["cost"][policy] == runs["ref"]["cost"][policy]


def test_gemm_collective_bytes_are_the_ring_volume(runs):
    """gemm's block ``0.5·(A@B) + 0.9·C`` on (2, 4), N×N fp32.  tp (the
    last dim over "model"): A is gathered over the 4 "model" ranks, an
    all-gather of the whole A, (4−1)/4 · 4N² bytes on the wire.  fsdp
    (dim 0 over "data"): DTensor keeps A's rows, takes B's columns over
    "model" (a local slice) and gathers B's rows over the 2 "data" ranks:
    an all-gather of an N × N/4 block, (2−1)/2 · 4N²/4 bytes."""
    coll = runs["dm"]["gemm_coll"]
    assert coll["tp"] == 3 / 4 * 4 * N * N
    assert coll["fsdp"] == 1 / 2 * 4 * N * N / 4


def test_sharded_train_step_matches_unsharded_and_reference(runs):
    r = runs["dm"]["train"]
    assert abs(r["sharded"] - r["unsharded"]) <= 1e-4 * abs(r["unsharded"])
    assert abs(r["sharded"] - runs["ref"]["sharded_loss"]) < 5e-3


def test_synced_gradients_match_unsharded(runs):
    """The sharded gradients reduced to their params' placements (an
    all-reduce over "data" for a replicated param, a reduce-scatter for a
    sharded one) equal the unsharded gradients, leaf by leaf: a sum taken
    as a mean, or a leaf left unreduced, is off by a factor here."""
    r = runs["dm"]["grads"]
    assert r["placed"] and max(r["errs"]) <= OPT_TOL["plain"]


def _leaf_errs(a, b):
    assert sorted(a.files) == sorted(b.files)
    return {k: _normwise(a[k], b[k]) for k in b.files}


@pytest.mark.parametrize("other", ["plain", "ref"])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_sharded_optimizer_step(runs, name, other):
    """One train step of reduced internlm2-20b on (2, 4) from the
    reference's weights: every param and every optimizer-state leaf
    (AdamW's m, v and step; Adafactor's factored vr, vc) after it, held
    leaf by leaf against the port's unsharded step and against the
    reference's sharded step.  The clip norm, the gradient sync and the
    per-shard update all feed these values."""
    d = runs["dir"]
    got = np.load(d / f"port_{name}_sharded.npz")
    want = np.load(d / (f"port_{name}_plain.npz" if other == "plain"
                        else f"ref_{name}.npz"))
    errs = _leaf_errs(got, want)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= OPT_TOL[other], (worst, errs[worst])


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_offloaded_host_shard_step_matches_on_device_step(runs, name):
    """One step of reduced internlm2-20b on (2, 4) through
    ``build_cell(offload_opt=True)`` with each rank's optimizer state as
    its own host shards (``PinnedShard``s: the offloaded update's pieces,
    Adafactor's as DTensors at the state's placements) against the same
    step with the state on the device: params within 1e-6 and state
    within 5e-5 normwise, leaf by leaf; the state stays host shards of
    local shape.  The step starts from the offloaded init's shards,
    which are the cell's offloaded state leaf by leaf (local and global
    shape, placements, memory kind, zeros)."""
    r = runs["dm"]["offload"][name]
    assert r["optimizer"] == name + "+offload"
    assert r["init_bad"] == []
    assert r["host_shards"] and r["local"] and all(r["local"])
    d = runs["dir"]
    errs = _leaf_errs(np.load(d / f"port_{name}_offload.npz"),
                      np.load(d / f"port_{name}_sharded.npz"))
    for prefix, tol in (("params/", 1e-6), ("opt/", 5e-5)):
        part = {k: v for k, v in errs.items() if k.startswith(prefix)}
        worst = max(part, key=part.get)
        assert part[worst] <= tol, (worst, part[worst])


def test_offloaded_shards_checkpoint_as_the_whole_tree(runs):
    """The host shards of an offloaded Adafactor state saved on 8 ranks:
    the files are byte-identical to those of the same values saved whole,
    the manifest holds the global shapes, and a restore (by
    ``shardings=``, or by the target's own shards) gives every rank its
    shard back bit for bit, with its global shape and sharding."""
    r = runs["dm"]["offload_ckpt"]
    assert r["restored"] == [True] * 8
    a = runs["dir"] / "ckpt_shards" / "step_0000000001"
    b = runs["dir"] / "ckpt_whole" / "step_0000000001"
    names = sorted(p.name for p in b.iterdir())
    assert names == sorted(p.name for p in a.iterdir())
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    manifest = json.loads((a / "manifest.json").read_text())
    assert {e["key"]: e["shape"] for e in manifest["leaves"]} \
        == r["global_shapes"]


def test_offloaded_adafactor_cell_of_arctic_steps(runs):
    """``build_cell(reduced arctic-480b, mesh, offload_opt=True)`` with
    arctic-480b's optimizer (Adafactor) and its state as host shards
    builds and steps from the offloaded init, placed as the cell's state:
    a finite loss, finite params, the state still host shards."""
    r = runs["dm"]["offload_arctic"]
    assert r["optimizer"] == "adafactor+offload"
    assert r["init_bad"] == []
    assert np.isfinite(r["loss"]) and r["finite"] and r["host_shards"]


def test_tuner_ranks_price_by_rank0_cache(runs):
    """Each rank has its own tune cache and only rank 0's holds a
    calibration: every rank prices with it, ranks and measures the same
    candidates, and chooses the same winner; the repeat hits on every
    rank though only rank 0's cache holds the table."""
    every = runs["dm"]["rank0_cache"]
    assert all(r == every[0] for r in every)
    first, again = every[0]
    assert first["hw"] == CALIBRATION
    assert not first["hit"] and first["measurements"] > 0
    assert again["hit"] and again["measurements"] == 0
    assert again["chosen"] == first["chosen"]


def test_kernel_block_on_the_mesh_runs_whole(runs):
    """attn_step's kernel-tagged block with q, k, v sharded along the
    sequence: made whole on every rank before the kernel's plain version
    runs, the loss equal to the host oracle's."""
    assert runs["dm"]["attn_step"] <= 1e-5


@pytest.mark.parametrize("name", ["rwkv6-3b", "recurrentgemma-2b"])
def test_recurrent_loss_with_policy_matches_unsharded(runs, name):
    r = runs["dm"]["recurrent"][name]
    assert abs(r["loss"] - r["unsharded"]) <= 1e-4 * abs(r["unsharded"])
    assert r["hidden_err"] <= 1e-4


@pytest.mark.parametrize("name", ["rwkv6-3b", "recurrentgemma-2b"])
def test_recurrent_synced_gradients_match_unsharded(runs, name):
    """Two accumulated micro-batches of the sharded step with a policy:
    every gradient, reduced to its param's placement, against the
    unsharded one, leaf by leaf (as ``test_synced_gradients_match_
    unsharded`` holds reduced internlm2-20b's).  Each param meets its
    activation at a placement of its own here (``at_use``), so a
    gradient left partial, or reduced twice, is off by a factor."""
    r = runs["dm"]["recurrent"][name]
    worst = max(r["grad_errs"].items(), key=lambda kv: kv[1])
    assert r["grads_placed"] and worst[1] <= OPT_TOL["plain"], worst


@pytest.mark.parametrize("name", ["qwen2.5-14b", "recurrentgemma-2b",
                                  "rwkv6-3b"])
def test_decode_on_the_mesh_matches_unsharded(runs, name):
    """Five decode steps with the cache placed by ``cache_shardings`` (the
    KV sequence over "model": sequence-parallel attention, its softmax
    combined across the ranks): the logits within 1e-5 of the largest."""
    assert runs["dm"]["decode"][name] <= 1e-5


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_sharded_moe_matches_unsharded_and_reference(runs, name):
    """The MoE layer without ``moe_ep`` on (2, 4), from the reference's
    weights (arctic-480b with its dense residual branch): its dispatch
    buffer split by experts over "model" and the expert weights at their
    own placements, the routing on the gathered tokens.  The loss and the
    router's aux within the train cell's bounds of the port's unsharded
    values (1e-4 relative) and of the reference's sharded ones (5e-3);
    every gradient leaf within ``OPT_TOL`` of the unsharded and of the
    reference's sharded gradients, normwise."""
    r, ref = runs["dm"]["moe"][name], runs["ref"]["moe"][name]
    for got, plain, want in ((r["loss"], r["unsharded"], ref["loss"]),
                             (r["aux"], r["aux_unsharded"], ref["aux"])):
        assert abs(got - plain) <= 1e-4 * abs(plain), (got, plain)
        assert abs(got - want) < 5e-3, (got, want)
    d = runs["dir"]
    got = np.load(d / f"port_moe_{name}_sharded.npz")
    ref_g = np.load(d / f"ref_moe_{name}.npz")
    ref_g = {k[len("grads/"):]: ref_g[k] for k in ref_g.files
             if k.startswith("grads/")}
    for other, want in (("plain", np.load(
            d / f"port_moe_{name}_plain.npz")), ("ref", ref_g)):
        keys = sorted(want.files if other == "plain" else want)
        assert sorted(got.files) == keys
        errs = {k: _normwise(got[k], want[k]) for k in keys}
        worst = max(errs, key=errs.get)
        assert errs[worst] <= OPT_TOL[other], (other, worst, errs[worst])


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_sharded_moe_keeps_expert_weights_split(runs, name):
    """No rank holds a whole expert-weight leaf: on every rank each of
    ``w_gate``, ``w_up``, ``w_down`` and its gradient holds
    ``n_experts / 4`` experts (the reference's ``moe_buf`` /
    ``moe_hidden`` placement; the old path gathered them whole)."""
    assert runs["dm"]["moe"][name]["experts_split"]


def test_ep_moe_matches_dense_moe(runs):
    r = runs["dm"]["ep"]
    assert abs(r["loss"] - r["dense"]) < 5e-3
    assert r["grads_finite"] and r["grads_nonzero"] == r["n_grads"]


def test_pipeline_forward_oracle(runs):
    assert runs["pd"]["pipeline_err"] < 1e-5


def test_compressed_psum_matches_reference(runs):
    ref = np.load(runs["dir"] / "ref_psum.npz")
    for rank in range(8):
        got = np.load(runs["dir"] / f"pd_rank{rank}.npz")
        pod = int(got["pod"])
        np.testing.assert_array_equal(got["codes"], ref["codes"][pod])
        assert float(got["scale"]) == float(ref["scale"])
        np.testing.assert_allclose(got["summed"], ref["summed"][pod],
                                   rtol=0, atol=1e-6)


def test_grad_sync_averages_over_pods(runs):
    """The cross-pod average: exact to fp32 rounding, and within one int8
    step of the shared scale (1/127 of max |g|) compressed."""
    r = runs["pd"]["grad_sync"]
    assert r["exact_err"] < 1e-6 and r["compressed_err"] <= 1 / 127


def test_prefetch_iterator_places_batches_by_shardings(runs):
    r = runs["dm"]["prefetch"]
    assert r["equal"] and r["local_rows"] == [4, 4]


def test_error_feedback_tracks_exact_sgd(runs):
    assert runs["pd"]["ef_gap"] < 5e-3


def test_elastic_remesh_checkpoint_restore(runs):
    r = runs["pd"]["elastic"]
    assert r["equal"] and r["placements"] == r["want"]
    assert r["mesh"] == [2, 4]
    ref_dir = runs["dir"] / "ckpt_ref" / "step_0000000001"
    port_dir = runs["dir"] / "ckpt_port" / "step_0000000001"
    names = sorted(p.name for p in ref_dir.iterdir())
    assert names == sorted(p.name for p in port_dir.iterdir())
    for name in names:
        assert (ref_dir / name).read_bytes() == (port_dir / name).read_bytes()


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", DRY_ARCHS)
def test_small_dryrun_records_and_drops(runs, arch, kind):
    """Each check names its field and both values when it fails."""
    rec = runs["dry"]["records"][f"{arch}/{kind}"]
    assert rec["status"] == "OK", ("status", rec["status"])
    assert rec["compile_s"] is None, ("compile_s", rec["compile_s"])
    want = runs["ref"]["dropped"][f"{arch}/{kind}"]
    assert rec["dropped_shardings"] == want, (
        "dropped_shardings", rec["dropped_shardings"], want)
    assert rec["memory"]["param_bytes"] > 0, ("param_bytes", rec["memory"])
    assert rec["flops_per_device"] > 0, ("flops_per_device",
                                         rec["flops_per_device"])
    name = f"{arch}__{'t' if kind == 'train' else 'd'}__2x4__baseline.json"
    assert name in runs["dry"]["written"], ("written", name,
                                            runs["dry"]["written"])


def test_dryrun_cell_on_the_production_mesh(runs):
    """``--mesh single`` builds ``make_production_mesh``'s 16×16
    ``DeviceMesh`` over a fake group of 256 ranks, and its cell traces.
    Each check names its field when it fails."""
    r = runs["dry"]["production"]
    for field, want in (("status", "OK"), ("n_devices", 256),
                        ("mesh", "DeviceMesh"), ("shape", [16, 16]),
                        ("axes", ["data", "model"])):
        assert r[field] == want, (field, r[field], want)


def test_dryrun_cli_help_runs():
    """The CLI parses without a group (no fake group is made for
    ``--help``)."""
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          "--help"], capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": SRC})
    assert res.returncode == 0 and "--reduced" in res.stdout

