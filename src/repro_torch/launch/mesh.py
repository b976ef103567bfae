"""Mesh construction.

The port of ``src/repro/launch/mesh.py``.  FUNCTIONS, not module
constants: importing this module touches no process group.

``make_mesh(shape, axes, device=)`` builds a ``DeviceMesh`` over the
ranks of the default process group, which the caller (or
``init_process_group`` here) has initialised: NCCL for ``"cuda"``, gloo
for ``"cpu"``, or the ``"fake"`` backend of the dry-run.  Nothing falls
back: a card that is missing, a group of another size or a backend that
does not serve the device raises.

The production shapes are the reference's TPU pods, 16×16 ("data",
"model") and 2×16×16 with a leading "pod" axis.  The port builds them as
``AbstractMesh``es (shapes and names only: enough for the sharding
rules), or as ``DeviceMesh``es over a fake group of 256 / 512 ranks
(``launch/dryrun.py``).
"""
from __future__ import annotations

import datetime
import os
from typing import Sequence

import torch

from ..distributed.sharding import abstract_mesh

__all__ = ["make_mesh", "make_production_mesh", "init_process_group",
           "PRODUCTION_SHAPES"]

PRODUCTION_SHAPES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}

# the backends that serve each device type
_BACKENDS = {"cuda": ("nccl", "fake"), "cpu": ("gloo", "fake")}


def init_process_group(device: str, rank: int, world_size: int,
                       store_dir: str, *, timeout_s: float = 60.0) -> None:
    """Initialise the default group for ``device``: NCCL on ``"cuda"``
    (this rank's card is ``cuda:rank``), gloo on ``"cpu"``, with the
    rendezvous in a file under ``store_dir`` (no TCP port)."""
    import torch.distributed as dist
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_process_group: no CUDA device is "
                               "available (pass device='cpu' for gloo)")
        torch.cuda.set_device(rank % torch.cuda.device_count())
        backend = "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device {device!r}: have 'cuda' or 'cpu'")
    os.makedirs(store_dir, exist_ok=True)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(store_dir, 'store')}",
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over every rank of
    the default group, whose size must be the mesh's."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device is available (pass "
                           "device='cpu' for a gloo mesh)")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; initialise one "
                           "first (launch.mesh.init_process_group)")
    backend = dist.get_backend()
    if backend not in _BACKENDS.get(device, ()):
        raise RuntimeError(f"make_mesh: a {backend!r} group cannot serve a "
                           f"{device!r} mesh (needs one of "
                           f"{_BACKENDS.get(device)})")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise RuntimeError(f"make_mesh: mesh {shape} needs {n} ranks, the "
                           f"group has {dist.get_world_size()}")
    return DeviceMesh(device, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The production mesh: a ``DeviceMesh`` on ``device`` when the
    default group has exactly its 256 / 512 ranks (a real group, or the
    dry-run's fake one with ``device="cpu"``), else an ``AbstractMesh``
    of its shape and names."""
    import torch.distributed as dist
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    n = 1
    for s in shape:
        n *= s
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() == n:
        return make_mesh(shape, axes, device=device)
    return abstract_mesh(shape, axes)
