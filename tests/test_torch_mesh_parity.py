"""Per-device work on the mesh, the port's dry-run against the
reference's: on a (2, 4) ("data", "model") mesh at reduced configs, each
cell's per-device FLOPs, collective bytes and argument bytes.

The port's side is ``launch/dryrun.py::run_cell`` on a fake group of 8
ranks (``roofline.hlo_flops_per_device``: the products of each rank's
local tensors, counted by ``collective_trace``; ``roofline.collectives``;
``memory``).  The reference's ``run_cell`` takes only the production
meshes and full configs, so its side builds the same record as that
function does, on 8 forced CPU devices: ``build_cell`` on
``make_mesh((2, 4))``, ``lower().compile()``, ``roofline_terms`` of the
compiled, partitioned HLO (its dot FLOPs and collectives) and
``memory_analysis().argument_size_in_bytes``.  Both sides run in their
own subprocesses, side by side.  ``PYTHONPATH=src python
tests/test_torch_mesh_parity.py table`` prints both sides' numbers.

Cells: the four archs of the ``tests/test_torch_mesh.py`` dry-run gate ×
train:64:8 / decode:64:8 (qwen3-moe-30b-a3b without ``moe_ep``);
arctic-480b train with its own optimizer (Adafactor; the reduced
config's count would pick AdamW) and its dense residual branch; and
internlm2-20b with a vocab of 256 (the reduced 257 does not divide the
4 "model" ranks, so only this cell splits the embedding and the head by
vocab rows).  Train cells take ``grad_accum`` 4 (``ACCUM``), the port's dry-run
default and the reference's.

What each side counts, and the bounds:

* **Argument bytes** are exact: the params, the optimizer state or the
  cache, and the batch (tokens, labels, positions), each rank's shards,
  sum to the reference's ``argument_bytes``, less an argument the step
  never reads, which ``jax.jit`` prunes from the reference's executable
  (``keep_unused=False``): rwkv6-3b's decode step reads no positions.
* **FLOPs** count the same products on both sides: the reference's HLO
  dots (projections, attention scores and values, experts, router, head;
  its remat recompute included, as the port's per-layer recompute is)
  against every matmul of the port's local tensors.  One difference is
  structural and taken out exactly: in a decode step whose vocab does
  not divide "model", the port's head contracts d split over "model"
  and sums the logits (1/n of the head's products per rank), where the
  reference gathers d and computes the whole head on every rank; the
  port's count gets the other (n−1)/n added.  What remains are the
  per-product strategies DTensor's propagation and GSPMD's partitioner
  pick, which split the same work in other ways except on small products
  one of them replicates: the train head's weight gradient (the port's
  is half the reference's, −3.5 % of internlm2-20b's train cell), the
  routers' gathered input (+2.4 % at qwen3-moe decode), rwkv6-3b's
  mixing products (−2.6 %; +6.2 % while they were gathered over
  "data").  Hence
  ``FLOPS_RTOL`` = 0.10.  A product that one side replicates over the 4
  "model" ranks and the other splits lies far outside: replicated
  experts read +196 % to +258 % (the MoE cells before their dispatch
  buffer was split by experts), attention heads replicated where K does
  not divide "model" +17 % to +50 %.
* **Collective bytes** are both sides' ring volumes of what each runs.
  The port places each param where it meets its activation
  (``distributed/sharding.py::at_use``: gathered over "data" only, split
  as the activation splits the dim they share), gathers an activation's
  d once where a projection into a "model"-split dim reads it, and
  reduces the partial sums of a product that contracts a split dim
  straight to the next placement; row statistics over a split dim (the
  norms, the cross-entropy) are summed inside ``local_map``.  It then
  runs the collectives GSPMD runs, if by other ops for the same
  placements: GSPMD all-reduces partial sums and permutes, DTensor
  reduce-scatters them or gathers.  Per op they do not compare; the
  per-device total does: at most ``COLL_FACTOR`` = 1.5 times the
  reference's, and at least the reference's over ``COLL_FLOOR`` = 2.
  The floor is wider because the port moves less where it reduce-
  scatters what GSPMD all-reduces (half the ring volume) and in the MoE
  layer's dispatch, which GSPMD routes with sorts and all-reduces over
  "data" (qwen3-moe-30b-a3b train, 0.64×); a cell far under it skips a
  collective the step needs.  An activation gathered where its weight
  should have been lies outside (rwkv6-3b train, 2.7×, before the params
  were placed at their point of use), and so does a gather of the whole
  expert weights on every rank (qwen3-moe decode, 8.8×).
"""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
MESH = (2, 4)
ARCHS = ("internlm2-20b", "qwen3-moe-30b-a3b", "recurrentgemma-2b",
         "rwkv6-3b")
# (arch, kind, vocab in place of the reduced config's, or None)
CELLS = ([(a, k, None) for a in ARCHS for k in ("train", "decode")]
         + [("arctic-480b", "train", None),
            ("internlm2-20b", "train", 256), ("internlm2-20b", "decode", 256)])
ACCUM = 4
FLOPS_RTOL = 0.10
COLL_FACTOR = 1.5
COLL_FLOOR = 2.0
# the collective kinds the table shows apart (the rest: permutes and
# all-to-alls)
TABLE_OPS = ("all-gather", "reduce-scatter", "all-reduce")


def _key(arch, kind, vocab):
    return f"{arch}-{kind}" + (f"-vocab{vocab}" if vocab else "")


_REF = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
from repro.configs import get_config, reduced, ShapeSpec
from repro.launch.mesh import make_mesh
import repro.launch.steps as steps
from repro.optim import default_optimizer
from repro.roofline import roofline_terms
mesh = make_mesh(%(MESH)r, ("data", "model"))
out = {}
for arch, kind, vocab in %(CELLS)r:
    full = get_config(arch)
    cfg = reduced(full)
    if vocab:
        cfg = dataclasses.replace(cfg, vocab=vocab)
    # arctic-480b's own optimizer, as the published config's size picks it
    steps.default_optimizer = lambda c, full=full: default_optimizer(full)
    shape = ShapeSpec(kind[0], kind, 64, 8)
    accum = %(ACCUM)d if kind == "train" else 1
    cell = steps.build_cell(cfg, shape, mesh, grad_accum=accum)
    with mesh:
        compiled = cell.lower().compile()
    roof = roofline_terms(cfg, shape, 8, compiled.as_text(),
                          grad_accum=accum)
    key = arch + "-" + kind + ("-vocab%%d" %% vocab if vocab else "")
    out[key] = {
        "flops": roof["hlo_flops_per_device"],
        "collectives": roof["collectives"],
        "argument_bytes": compiled.memory_analysis().argument_size_in_bytes,
        "optimizer": cell.meta.get("optimizer")}
json.dump(out, open(os.path.join(sys.argv[1], "ref.json"), "w"))
"""


def _port(out_dir):
    """The port's records, on a fake group (this process only)."""
    import dataclasses

    from repro_torch.configs import ShapeSpec, get_config, reduced
    from repro_torch.launch import dryrun, steps
    from repro_torch.optim import default_optimizer
    out = {}
    for arch, kind, vocab in CELLS:
        full = get_config(arch)
        cfg = reduced(full)
        if vocab:
            cfg = dataclasses.replace(cfg, vocab=vocab)
        # this process only: the cell's config and arctic-480b's optimizer
        dryrun.reduced = lambda c, cfg=cfg: cfg
        steps.default_optimizer = lambda c, full=full: default_optimizer(full)
        key = _key(arch, kind, vocab)
        out[key] = dryrun.run_cell(arch, ShapeSpec(kind[0], kind, 64, 8),
                                   "x".join(map(str, MESH)),
                                   Path(out_dir, "dry"), small=True,
                                   variant=key)
    Path(out_dir, "port.json").write_text(json.dumps(out, default=str))


def _start(args):
    env = {"PYTHONPATH": SRC, "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", "/tmp"), "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}
    if "TMPDIR" in os.environ:
        env["TMPDIR"] = os.environ["TMPDIR"]
    return subprocess.Popen(args, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            start_new_session=True)


def _records(tmp):
    """Both sides' records, each side in its own subprocess, side by
    side: ``{"ref": {cell: ...}, "port": {cell: run_cell's record}}``."""
    src = _REF % {"MESH": MESH, "CELLS": CELLS, "ACCUM": ACCUM}
    jobs = {"reference": _start([sys.executable, "-c", src, str(tmp)]),
            "port": _start([sys.executable, __file__, "port", str(tmp)])}
    for name, proc in jobs.items():
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, err = proc.communicate()
            raise AssertionError(f"the {name}'s side timed out after 600 "
                                 f"s:\n{err[-4000:]}")
        assert proc.returncode == 0, (
            f"the {name}'s side exited {proc.returncode}:\n{err[-6000:]}")
    return {side: json.loads((Path(tmp) / f"{side}.json").read_text())
            for side in ("ref", "port")}


@pytest.fixture(scope="module")
def recs(tmp_path_factory):
    return _records(tmp_path_factory.mktemp("parity"))


def _ids(cells):
    return [_key(*c) for c in cells]


@pytest.mark.parametrize("cell", CELLS, ids=_ids(CELLS))
def test_argument_bytes_equal_reference(recs, cell):
    """Params + optimizer state or cache + batch, each rank's shards,
    equal to the reference's ``argument_bytes`` byte for byte (a leaf
    replicated where the reference shards it, or the reverse, is off by
    its size)."""
    key = _key(*cell)
    port, ref = recs["port"][key], recs["ref"][key]
    mem = port["memory"]
    got = {k: mem[k] for k in ("param_bytes", "opt_bytes", "cache_bytes",
                               "batch_bytes")}
    # the positions (B,) int32 over the batch axis, unread by rwkv6's step
    arch, kind, _ = cell
    unread = 4 * 8 // MESH[0] if (kind, arch) == ("decode", "rwkv6-3b") \
        else 0
    assert port["optimizer"] == ref["optimizer"]
    assert sum(got.values()) - unread == ref["argument_bytes"], (got, ref)


def _head_flops_split(arch, kind, vocab):
    """The (n−1)/n of the head's products the port's decode step leaves
    to the other "model" ranks where the vocab does not divide them (see
    the module docstring); 0 elsewhere."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config(arch))
    if vocab:
        cfg = dataclasses.replace(cfg, vocab=vocab)
    n_data, n_model = MESH
    if kind != "decode" or cfg.vocab % n_model == 0:
        return 0.0
    rows = 8 // n_data
    head = 2.0 * rows * cfg.d_model * cfg.vocab * max(cfg.n_codebooks, 1)
    return head * (n_model - 1) / n_model


@pytest.mark.parametrize("cell", CELLS, ids=_ids(CELLS))
def test_flops_per_device_match_reference(recs, cell):
    key = _key(*cell)
    got = recs["port"][key]["roofline"]["hlo_flops_per_device"]
    want = recs["ref"][key]["flops"]
    adj = got + _head_flops_split(*cell)
    assert abs(adj - want) <= FLOPS_RTOL * want, {
        "port": got, "port_adjusted": adj, "reference": want,
        "ratio": adj / want}


@pytest.mark.parametrize("cell", CELLS, ids=_ids(CELLS))
def test_collective_bytes_per_device_match_reference(recs, cell):
    key = _key(*cell)
    port = recs["port"][key]["roofline"]["collectives"]
    ref = recs["ref"][key]["collectives"]
    got = sum(v["bytes"] for v in port.values())
    want = sum(v["bytes"] for v in ref.values())
    by_op = {op: (port[op]["bytes"], ref[op]["bytes"]) for op in ref}
    assert want / COLL_FLOOR <= got <= want * COLL_FACTOR, {
        "port": got, "reference": want, "ratio": got / want,
        "by_op (port, reference)": by_op}


def _by_op(colls) -> dict:
    """Ring-volume bytes of ``TABLE_OPS`` and of the rest ("other")."""
    out = {op: colls.get(op, {}).get("bytes", 0.0) for op in TABLE_OPS}
    out["other"] = sum(v["bytes"] for op, v in colls.items()
                       if op not in TABLE_OPS)
    return out


def _table(recs) -> str:
    """A markdown table of both sides' per-device numbers, cell by cell:
    FLOPs, collective bytes by op (port / reference) and in total,
    argument bytes."""
    cols = [*TABLE_OPS, "other"]
    rows = ["| cell | FLOPs port | FLOPs ref | port (+head) / ref | "
            + " | ".join(f"{op} port / ref" for op in cols)
            + " | coll. bytes port | coll. bytes ref | port / ref | "
            "arg. bytes port | arg. bytes ref |",
            "|" + " --- |" * (10 + len(cols))]
    for cell in CELLS:
        key = _key(*cell)
        port, ref = recs["port"][key], recs["ref"][key]
        f = port["roofline"]["hlo_flops_per_device"]
        pc, rc = (_by_op(x) for x in (port["roofline"]["collectives"],
                                      ref["collectives"]))
        c, r = sum(pc.values()), sum(rc.values())
        arg = sum(port["memory"][k] for k in (
            "param_bytes", "opt_bytes", "cache_bytes", "batch_bytes"))
        rows.append(f"| {key} | {f:.0f} | {ref['flops']:.0f} | "
                    f"{(f + _head_flops_split(*cell)) / ref['flops']:.3f} | "
                    + " | ".join(f"{pc[op]:.0f} / {rc[op]:.0f}"
                                 for op in cols)
                    + f" | {c:.0f} | {r:.0f} | {c / r:.2f} | {arg} | "
                    f"{ref['argument_bytes']} |")
    return "\n".join(rows)


if __name__ == "__main__":
    # ``port DIR``: the port's side, for the tests' fixture; ``table``:
    # both sides, printed as a markdown table
    if sys.argv[1] == "port":
        _port(sys.argv[2])
    else:
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            print(_table(_records(tmp)))
