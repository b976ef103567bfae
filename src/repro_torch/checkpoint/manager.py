"""Checkpointing with async (delegatestore-style) saves, in the reference's
format, so a checkpoint written by either package restores in the other.

The port of ``src/repro/checkpoint/manager.py``.  One directory per step:

    step_{step:010d}/manifest.json   — step, extra, treedef, leaves
                                       (key, file, shape, dtype)
    step_{step:010d}/{i:05d}.npy     — one file per leaf

Leaves are numbered in JAX's flattening order (dict keys sorted at every
level) and keyed by their ``/``-joined paths, as the reference numbers
and keys them; ``treedef`` is written as ``jax.tree_util`` prints a tree
of dicts.  ``save`` copies every leaf to the host at once (a snapshot:
the optimizer updates the tensors in place afterwards); a thread writes
the files into a temporary directory and publishes it with
``os.replace``; ``wait()`` is the barrier; ``keep`` old steps stay.

A bf16 leaf is written as the reference writes one (``np.save`` of an
``ml_dtypes`` array: the 2-byte payload under ``descr '<V2'``, manifest
dtype ``"bfloat16"``) and read back through the manifest's dtype, the
payload viewed as int16 and then as bf16.  The reference's own
``restore`` cannot read such a leaf (numpy gives ``|V2``, which JAX
refuses), so without this the port could not resume a bf16 model.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..tree import flatten_with_paths, treedef_str, unflatten

__all__ = ["CheckpointManager"]

_BF16_DESCR = "<V2"


def _host_array(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A snapshot of ``t`` on the host as numpy, and its dtype's name as
    the reference's manifest spells it.  bf16 travels as its int16 bits."""
    t = t.detach()
    host = t.cpu() if t.device.type != "cpu" else t.clone()
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy(), "bfloat16"
    arr = host.numpy()
    return arr, str(arr.dtype)


def _save_npy(path: Path, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _load_npy(path: Path, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pending: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, *, extra: Optional[Dict] = None,
             blocking: bool = False) -> None:
        """delegatestore: device→host now, disk write on a background
        thread."""
        self.wait()   # previous save must land first (ordering)
        if torch.cuda.is_initialized():
            # pinned host leaves may still be the target of stream copies
            torch.cuda.synchronize()
        host_leaves = [(k, *_host_array(v))
                       for k, v in flatten_with_paths(tree)]
        manifest = {
            "step": step,
            "extra": extra or {},
            "treedef": treedef_str(tree),
            "leaves": [
                {"key": k, "file": f"{i:05d}.npy",
                 "shape": list(v.shape), "dtype": dt}
                for i, (k, v, dt) in enumerate(host_leaves)
            ],
        }

        def write():
            tmp = self.dir / f".tmp_step_{step:010d}"
            final = self.dir / f"step_{step:010d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            for i, (_, v, dt) in enumerate(host_leaves):
                _save_npy(tmp / f"{i:05d}.npy", v, dt)
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)      # atomic publish
            self._gc()

        t = threading.Thread(target=write, daemon=True)
        t.start()
        self._pending = t
        if blocking:
            self.wait()

    def wait(self) -> None:
        """synchronize: barrier for the in-flight save."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree: Any, device=None
                ) -> Tuple[Any, Dict]:
        """Restore into the structure of ``target_tree``: each leaf on
        ``device``, or where the target's leaf lives (pinned if it is
        pinned) when ``device`` is None; a ``meta`` target gives CPU
        tensors.  Shapes must match the target's."""
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        by_key = {e["key"]: e for e in manifest["leaves"]}
        out = []
        for key, tgt in flatten_with_paths(target_tree):
            ent = by_key.get(key)
            if ent is None:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            t = _load_npy(d / ent["file"], ent["dtype"])
            want = tuple(getattr(tgt, "shape", t.shape))
            if tuple(t.shape) != want:
                raise ValueError(
                    f"leaf {key!r}: checkpoint shape {tuple(t.shape)} != "
                    f"target {want}")
            out.append(self._place(t, tgt, device))
        return unflatten(target_tree, out), manifest["extra"]

    @staticmethod
    def _place(t: torch.Tensor, tgt, device) -> torch.Tensor:
        if device is None and isinstance(tgt, torch.Tensor):
            if tgt.device.type == "cpu" and tgt.is_pinned():
                return t.pin_memory()
            device = tgt.device if tgt.device.type != "meta" else "cpu"
        return t if device is None else t.to(device)

    def restore_latest(self, target_tree: Any, device=None):
        step = self.latest_step()
        if step is None:
            return None
        tree, extra = self.restore(step, target_tree, device)
        return step, tree, extra
