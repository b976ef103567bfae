"""Runtime device-residency tracker — the ``noupdate``/``mapbyname`` machinery
used by the training-loop substrates (data pipeline, optimizer offload,
async checkpointing) outside the block-program executor.

A ``DeviceResidency`` owns named buffers that may have a host copy, a device
copy, or both, and performs transfers lazily with the paper's policy:
uploads as early as the caller schedules them (``prefetch`` = advancedload),
downloads as late as possible (``fetch`` only when the host actually reads =
delegatestore), and no transfer at all when the requested space already holds
a valid copy (noupdate).  All movement is instrumented.

Transfers go through a pluggable ``Backend`` (``repro_torch.core.backend``),
so prefetches are enqueued asynchronously on a per-entry transfer stream
and ``wait()`` is a real synchronization point (HMPP ``synchronize``).
``DeviceResidency(device)`` builds a ``TorchDeviceBackend`` on that
device; with neither ``device`` nor ``backend`` it takes the default
backend (the torch one on ``cuda:0``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np

from .backend import Backend, get_backend
from .dtypes import numpy_dtype

__all__ = ["DeviceResidency", "ResidencyStats", "plan_peak_device_bytes"]


@dataclasses.dataclass
class ResidencyStats:
    h2d_transfers: int = 0
    h2d_bytes: int = 0
    d2h_transfers: int = 0
    d2h_bytes: int = 0
    elided: int = 0
    h2d_time: float = 0.0
    d2h_time: float = 0.0


@dataclasses.dataclass
class _Entry:
    host: Optional[np.ndarray] = None
    device: Optional[Any] = None
    valid_host: bool = False
    valid_device: bool = False
    stream: int = 0


def _leaf_bytes(x) -> int:
    return int(np.prod(np.shape(x))) * numpy_dtype(
        getattr(x, "dtype", np.float32)).itemsize


class DeviceResidency:
    def __init__(self, device=None, *, backend: Any = None):
        self._entries: Dict[str, _Entry] = {}
        self.stats = ResidencyStats()
        if backend is None and device is not None:
            from .backend import TorchDeviceBackend
            backend = TorchDeviceBackend(device)
        self._backend: Backend = get_backend(backend)
        self._next_stream = 1

    # -- host side ---------------------------------------------------------
    def put_host(self, name: str, value: np.ndarray) -> None:
        """A host write: invalidates any device copy (paper: CPU write ⇒
        re-advancedload needed)."""
        e = self._entries.setdefault(name, _Entry())
        if e.stream == 0:
            e.stream = self._next_stream
            self._next_stream += 1
        e.host = np.asarray(value)
        e.valid_host, e.valid_device = True, False

    def fetch(self, name: str) -> np.ndarray:
        """Host read — delegatestore happens here, as late as possible."""
        e = self._entries[name]
        if e.valid_host:
            self.stats.elided += 1
            return e.host
        t = time.perf_counter()
        e.host = self._backend.download(e.device, stream=e.stream)
        self.stats.d2h_time += time.perf_counter() - t
        self.stats.d2h_transfers += 1
        self.stats.d2h_bytes += _leaf_bytes(e.host)
        e.valid_host = True
        return e.host

    # -- device side -------------------------------------------------------
    def put_device(self, name: str, value) -> None:
        """A device write (kernel output): invalidates the host copy."""
        e = self._entries.setdefault(name, _Entry())
        e.device = value
        e.valid_device, e.valid_host = True, False

    def prefetch(self, name: str) -> None:
        """advancedload: enqueue the upload now (async, on this entry's
        transfer stream) so it overlaps whatever runs next; no-op if
        already resident."""
        e = self._entries[name]
        if e.valid_device:
            self.stats.elided += 1
            return
        t = time.perf_counter()
        e.device = self._backend.upload(e.host, stream=e.stream)
        self.stats.h2d_time += time.perf_counter() - t
        self.stats.h2d_transfers += 1
        self.stats.h2d_bytes += _leaf_bytes(e.host)
        e.valid_device = True

    def device_value(self, name: str):
        """Device read; uploads on demand (the *unoptimized* path — callers
        that care should have prefetched)."""
        e = self._entries[name]
        if not e.valid_device:
            self.prefetch(name)
        return e.device

    def wait(self, name: Optional[str] = None) -> None:
        """Block until outstanding async transfers complete (HMPP
        ``synchronize``): one entry's stream, or every stream."""
        if name is None:
            self._backend.sync()
        else:
            self._backend.sync(self._entries[name].stream)

    def resident(self, name: str) -> bool:
        e = self._entries.get(name)
        return bool(e and e.valid_device)

    def release(self, name: Optional[str] = None) -> None:
        names = [name] if name else list(self._entries)
        for n in names:
            e = self._entries[n]
            if e.device is not None:
                self._backend.free(e.device)
            e.device = None
            e.valid_device = False


# ---------------------------------------------------------------------------
# Static peak-residency walk — the tuner's peak-memory objective.
# ---------------------------------------------------------------------------

def _plan_group_vars(pl, group: int) -> set:
    """Vars a ``Release`` of ``group`` frees: the group's ``mapbyname``
    declaration plus everything its member codelets read or write.  Local
    mirror of ``executor.group_vars`` — the executor pulls in the whole
    backend stack, which this static walk does not need."""
    from .ir import GroupDecl
    names: set = set()
    for d in pl.directives(GroupDecl):
        if d.group == group:
            names.update(d.mapbyname)
    for bi in pl.groups.get(group, ()):
        blk = pl.program.blocks[bi]
        names.update(blk.reads)
        names.update(blk.writes)
    return names


def _kernel_workset_bytes(blk, kernel_variants, shapes) -> float:
    """On-chip tile working set of a kernel-tagged block under the
    candidate's chosen tile ``params`` (``kernel_variants`` maps kernel
    name -> params; registry defaults otherwise).  0 when shapes are
    unavailable or the tile does not validate — the walk then ranks on
    HBM residency alone, which is the plan-dependent part anyway."""
    if not getattr(blk, "kernel", None) or not shapes:
        return 0.0
    try:
        from ..kernels.variants import KERNELS, kernel_workset
        sds = [shapes[v] for v in blk.reads]
        op_shapes = [tuple(s.shape) for s in sds]
        itemsizes = [int(np.dtype(s.dtype).itemsize) for s in sds]
        params = (kernel_variants or {}).get(blk.kernel)
        if params is None:
            params = KERNELS[blk.kernel]["defaults"]
        return float(kernel_workset(blk.kernel, dict(params), op_shapes,
                                    itemsizes))
    except Exception:
        return 0.0


def plan_peak_device_bytes(pl, *, donate: bool = False,
                           kernel_variants: Optional[Dict] = None,
                           shapes: Optional[Dict] = None) -> float:
    """Peak device bytes of one walk over the plan's ops — the tuner's
    third objective (time × energy × **memory**).

    The walk tracks the set of device-allocated buffers exactly as the
    executor would create them: ``AdvancedLoad`` allocates its var,
    an offload block allocates any not-yet-resident actual read plus its
    outputs, ``Release`` frees its group's vars (``mapbyname`` + member
    reads/writes).  ``DelegateStore`` does NOT free — HMPP keeps the
    device copy valid until the group releases.

    At each offload callsite the peak candidate additionally charges:

    * **transients** — dummy device zeros for declared-but-unread
      operands, and output double-buffering for every written var whose
      old device buffer cannot be reused (not resident, or resident but
      ``donate=False``): briefly both the old input and the new output
      exist, which is why donation is a memory knob, not just a time one;
    * **kernel tile working set** — ``kernel_workset`` of the block's
      kernel under the candidate's tile choice (``kernel_variants``),
      so the kernel axis moves this objective: bigger tiles run faster
      (fewer passes over HBM) but hold a larger slice on-chip.

    ``shapes`` is the analyzer's var -> ShapeDtype map (for kernel
    operand shapes); byte sizes come from ``pl.meta["var_nbytes"]``.
    Returns bytes (float); vars with unknown size count 0.
    """
    from .ir import AdvancedLoad, BlockKind, Release
    nb: Dict[str, float] = dict(pl.meta.get("var_nbytes") or {})
    resident: Dict[str, float] = {}
    peak = 0.0
    for op in pl.ops:
        if op.kind == "directive":
            d = op.directive
            if isinstance(d, AdvancedLoad):
                resident.setdefault(d.var, float(nb.get(d.var, 0)))
            elif isinstance(d, Release):
                for v in _plan_group_vars(pl, d.group):
                    resident.pop(v, None)
            continue
        if op.kind != "block":
            continue
        blk = pl.program.blocks[op.block_idx]
        if blk.kind is not BlockKind.OFFLOAD:
            continue
        actual = set(blk.effective_reads())
        transient = 0.0
        for v in blk.reads:
            if v not in actual:        # dummy zeros arg, freed after launch
                transient += float(nb.get(v, 0))
            else:                      # upload-on-demand stays resident
                resident.setdefault(v, float(nb.get(v, 0)))
        for w in blk.writes:           # output double-buffer unless donated
            if w not in resident or not donate:
                transient += float(nb.get(w, 0))
        transient += _kernel_workset_bytes(blk, kernel_variants, shapes)
        peak = max(peak, sum(resident.values()) + transient)
        for w in blk.writes:
            resident[w] = float(nb.get(w, 0))
    return max(peak, sum(resident.values()))
