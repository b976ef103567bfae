"""Multi-pod dry-run: build every (architecture × input shape × mesh) cell
on the production mesh(es) and record its sharding, memory, collective
and roofline artifacts, without a device.

The port of ``src/repro/launch/dryrun.py``.  The reference forces 512
host devices and compiles each cell with XLA.  Here the mesh is a
``DeviceMesh`` over a *fake* process group of 256 / 512 ranks
(``torch.testing._internal.distributed.fake_pg``: collectives return at
once), the arguments are ``meta`` DTensors, and ``CellArtifacts.lower``
runs the step once under ``collective_trace``: per-device bytes, FLOPs
and collectives come from that run.  There is no compile step, which the
record says (``"compile_s": null``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \
        --shape all --mesh both --outdir artifacts/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        --arch internlm2-20b --reduced --mesh 2x4 --shape train_4k
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

from ..configs import SHAPES, ShapeSpec, get_config, list_archs, reduced
from ..roofline.analysis import roofline_terms
from .mesh import PRODUCTION_SHAPES, make_mesh, make_production_mesh
from .steps import build_cell

__all__ = ["run_cell", "fake_group", "parse_mesh", "main"]

DEFAULT_TRAIN_ACCUM = 4   # the reference's: fits every train cell in HBM


def parse_mesh(spec: str) -> Tuple[Tuple[int, ...], Tuple[str, ...], str]:
    """``"single"`` / ``"multi"`` (the production meshes) or a shape such
    as ``"2x4"`` ((data, model)) or ``"2x2x2"`` ((pod, data, model)).
    Returns (shape, axes, name)."""
    if spec in ("single", "multi"):
        shape, axes = PRODUCTION_SHAPES[spec == "multi"]
        return shape, axes, spec
    shape = tuple(int(s) for s in spec.split("x"))
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}[len(shape)]
    return shape, axes, spec


def fake_group(world_size: int) -> None:
    """(Re)initialise the default process group as a fake one of
    ``world_size`` ranks (this process is rank 0)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size \
                and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _write(outdir: Path, rec: Dict, variant: str) -> None:
    outdir.mkdir(parents=True, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}__{variant}.json"
    (outdir / name).write_text(json.dumps(rec, indent=2, default=str))


def run_cell(arch: str, shape: ShapeSpec, mesh_spec: str, outdir: Path, *,
             small: bool = False, variant: str = "baseline",
             overrides: Optional[Dict] = None) -> Dict:
    """Build and trace one cell on a fake group of the mesh's size;
    writes and returns its record.  ``small``: the reduced config."""
    cfg = get_config(arch)
    if small:
        cfg = reduced(cfg)
    shape_dims, axes, mesh_name = parse_mesh(mesh_spec)
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
               "status": "SKIP",
               "reason": "pure full-attention arch; long_500k requires "
                         "sub-quadratic attention (DESIGN.md §6)"}
        _write(outdir, rec, variant)
        return rec
    n = 1
    for s in shape_dims:
        n *= s
    fake_group(n)
    if mesh_spec in ("single", "multi"):
        mesh = make_production_mesh(multi_pod=mesh_spec == "multi",
                                    device="cpu")
    else:
        mesh = make_mesh(shape_dims, axes, device="cpu")
    kwargs = dict(overrides or {})
    if shape.kind == "train":
        kwargs.setdefault("grad_accum", DEFAULT_TRAIN_ACCUM)
    grad_accum = kwargs.get("grad_accum", 1)
    t0 = time.time()
    cell = build_cell(cfg, shape, mesh, **kwargs)
    low = cell.lower()
    t_lower = time.time() - t0
    roof = roofline_terms(cfg, shape, n, low, grad_accum=grad_accum,
                          kv_bytes=1 if kwargs.get("kv_quant") else 2)
    rec = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "mesh_shape": dict(zip(axes, shape_dims)),
        "status": "OK",
        "variant": variant,
        "kind": shape.kind,
        "reduced": small,
        "optimizer": cell.meta.get("optimizer"),
        "grad_accum": grad_accum,
        "dropped_shardings": [list(d) for d in cell.meta.get("dropped", [])],
        "lower_s": round(t_lower, 1),
        "compile_s": None,        # no compile step: one traced run
        "flops_per_device": low["flops"],
        "memory": {
            "param_bytes": low["param_bytes"],
            "opt_bytes": low["opt_bytes"],
            "opt_on_host": low["opt_on_host"],
            "cache_bytes": low["cache_bytes"],
            "batch_bytes": low["batch_bytes"],
        },
        "roofline": roof,
        "n_devices": n,
    }
    _write(outdir, rec, variant)
    coll_mb = sum(v["bytes"] for v in roof["collectives"].values()) / 1e6
    print(f"OK    {arch} × {shape.name} × {mesh_name} [{variant}] "
          f"lower={t_lower:.1f}s terms(c/m/n)={roof['compute_s']:.3g}/"
          f"{roof['memory_s']:.3g}/{roof['collective_s']:.3g}s "
          f"bottleneck={roof['bottleneck']} coll={coll_mb:.1f}MB")
    return rec


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all",
                    help="a SHAPES name, 'all', or kind:seq:batch "
                         "(e.g. train:64:8)")
    ap.add_argument("--mesh", default="both",
                    help="single | multi | both | a shape such as 2x4")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced (smoke) configs")
    ap.add_argument("--outdir", default="artifacts/dryrun_torch")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--offload-opt", action="store_true")
    ap.add_argument("--moe-ep", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--fsdp-layers", action="store_true")
    ap.add_argument("--seq-shard", action="store_true")
    args = ap.parse_args(argv)

    archs = list(list_archs()) if args.arch == "all" else [args.arch]
    if args.shape == "all":
        shapes = list(SHAPES.values())
    elif args.shape in SHAPES:
        shapes = [SHAPES[args.shape]]
    else:
        kind, seq, batch = args.shape.split(":")
        shapes = [ShapeSpec(args.shape.replace(":", "_"), kind, int(seq),
                            int(batch))]
    meshes = (["single", "multi"] if args.mesh == "both" else [args.mesh])
    overrides = {k: True for k in ("offload_opt", "moe_ep", "kv_quant",
                                   "fsdp_layers", "seq_shard")
                 if getattr(args, k)}
    if args.grad_accum is not None:
        overrides["grad_accum"] = args.grad_accum

    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                try:
                    run_cell(arch, shape, mesh, Path(args.outdir),
                             small=args.reduced, variant=args.variant,
                             overrides=overrides)
                except Exception as e:      # noqa: BLE001 - listed below
                    failures.append((arch, shape.name, mesh, repr(e)))
                    print(f"FAIL  {arch} × {shape.name} × {mesh}: {e!r}")
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nALL CELLS OK")


if __name__ == "__main__":
    main()
