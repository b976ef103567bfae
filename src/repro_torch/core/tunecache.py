"""Persistent plan-space tuning cache.

The tuner re-measures the full candidate grid on every
``plan(p, policy="auto")`` call unless the result is kept.  The sequel
paper (arXiv:1506.02833) makes the point that the exploration must be
cheap and *repeatable* to be usable: this module keys each tuning result
on a content fingerprint of everything the result depends on —

    program ops        block bodies (bytecode), reads/writes, loop nest,
                       input shapes/dtypes, declared outputs
    backend identity   class, registered name, stream count, donation
                       flag, device (and on CUDA the card's name)
    candidate grid     the exact config list plus the measurement
                       protocol (top_k, reps)
    cost model         ``COST_MODEL_VERSION`` + the default hardware
                       constants the predictions were priced with

— so a repeated ``policy="auto"`` call returns the cached winner (and
the byte-identical ranked table) without re-measuring, while ANY change
to the program, the backend, the grid, or the cost model misses.

Entries are one JSON file per (program name, backend, grid+protocol)
slot — distinct grids/protocols of the same program coexist instead of
evicting each other — while the FULL fingerprint is stored inside the
entry and checked on lookup, so a genuinely stale entry (program edited
in place, cost-model version bumped) is evicted rather than reused.
``tune(refresh=True)`` bypasses lookup and overwrites.

The cache also owns a per-DEVICE-CLASS store (``device_class_key`` —
stream count and donation flag deliberately excluded, they are candidate
knobs, not silicon): the *measured calibration* of the cost model
(fitted ``pcie_bw`` / ``launch_overhead_s`` / ``sync_overhead_s``, see
``repro_torch.roofline.analysis.fit_offload_constants``), every program's
measured candidate rows, and the cross-program cold-start predictor
fitted from them — so constants and rankings learned while tuning one
program price the next, never-measured one.

Location: the ``REPRO_TORCH_TUNE_CACHE`` env var (empty/"off"/"0"
disables caching), else ``$XDG_CACHE_HOME/repro_torch/tunecache``; the
entry cap is ``REPRO_TORCH_TUNE_CACHE_MAX``.  The JAX reference package
keeps its own cache (``REPRO_TUNE_CACHE``): the two never read each
other's slots.  This module is stdlib-only (it asks torch for a card's
name only when a CUDA backend is keyed).
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import re
import tempfile
from typing import Any, Dict, Optional, Sequence

__all__ = [
    "COST_MODEL_VERSION", "TuneCache", "default_cache",
    "program_fingerprint", "backend_fingerprint", "grid_fingerprint",
    "tuning_fingerprint", "calibration_fingerprint", "device_class_key",
]

# Bump whenever predict_cost / offload_cost_terms semantics change: every
# cached table and every fitted calibration is invalidated by the bump
# (bumping also clears the per-device-class store: calibration + measured
# rows + predictor).  v1: the port's first cost model — the reference's
# v5 model priced with the H100 table and FlopCounterMode block FLOPs.
COST_MODEL_VERSION = 1

_ENV_VAR = "REPRO_TORCH_TUNE_CACHE"
_MAX_ENV_VAR = "REPRO_TORCH_TUNE_CACHE_MAX"
_DISABLED = ("", "0", "off", "none")
_DEFAULT_MAX_ENTRIES = 256


def _sha(obj: Any) -> str:
    blob = json.dumps(obj, sort_keys=True, default=repr).encode()
    return hashlib.sha256(blob).hexdigest()


def _cell_key(value: Any) -> Any:
    """Key for one closure-cell value.  repr alone is NOT enough for
    arrays — numpy truncates > 1000 elements shapelessly, so two
    different-sized captured weight arrays would repr identically and
    alias a stale cache entry; shape/dtype are keyed explicitly."""
    shape = getattr(value, "shape", None)
    if shape is not None:
        return ["array", list(shape),
                str(getattr(value, "dtype", "")), repr(value)]
    return repr(value)


def _code_key(fn) -> Any:
    """Content key for a block body: bytecode + consts + names, so an
    edited kernel invalidates while re-building the identical lambda
    does not.  Closure cell values are included (a captured scalar or
    array changing the computation must change the key)."""
    code = getattr(fn, "__code__", None)
    if code is None:
        return repr(fn)
    cells = tuple(_cell_key(getattr(c, "cell_contents", None))
                  for c in (fn.__closure__ or ()))
    return [code.co_code.hex(), repr(code.co_consts), code.co_names,
            code.co_varnames, code.co_argcount, code.co_freevars, cells]


def program_fingerprint(program) -> str:
    """Content hash of the tuning-relevant program structure.  Input
    *values* are excluded on purpose — timings depend on shapes and
    dtypes, not on the numbers in the arrays."""
    obj = {
        "name": program.name,
        "blocks": [[b.idx, b.kind.value, b.name, list(b.reads),
                    list(b.writes), list(b.loop_path), _code_key(b.fn),
                    getattr(b, "kernel", None)]
                   for b in program.blocks],
        "loops": [[lid, info.n_iters, list(info.parent_path)]
                  for lid, info in sorted(program.loops.items())],
        "inputs": [[k, list(getattr(v, "shape", ())),
                    str(getattr(v, "dtype", type(v).__name__))]
                   for k, v in sorted(program.inputs.items())],
        "outputs": list(program.outputs),
    }
    return _sha(obj)


def _device_key(backend) -> str:
    """The backend's device: ``str(backend.device)`` ("cuda:0", "cpu"),
    plus the card's name on CUDA ("cuda:0:NVIDIA H100 80GB HBM3"), so two
    kinds of card never share a table; "None" for host backends."""
    dev = getattr(backend, "device", None)
    if dev is None:
        return "None"
    key = str(dev)
    if getattr(dev, "type", None) == "cuda":
        import torch
        key += f":{torch.cuda.get_device_name(dev)}"
    return key


def _mesh_suffix(backend) -> str:
    mesh_key = getattr(backend, "mesh_key", None)
    return f":mesh{mesh_key}" if mesh_key else ""


def backend_fingerprint(backend) -> str:
    """Identity string for the measuring backend: two backends with the
    same fingerprint must time a plan the same way.  Mesh backends fold
    in the mesh shape + axis names: the same program tuned on a 2x4 and
    a 1x8 mesh picks different placements, so the tables must not alias
    (the per-candidate placement is part of the grid, not this)."""
    return (f"{type(backend).__name__}:{backend.name}"
            f":streams{backend.n_streams}"
            f":donate{getattr(backend, 'donate', False)}"
            f":{_device_key(backend)}{_mesh_suffix(backend)}")


def grid_fingerprint(configs: Sequence, protocol: Dict[str, Any]) -> str:
    """Hash of the candidate grid + measurement protocol: part of the
    SLOT key (not just the fingerprint), so e.g. a ``top_k`` sweep and
    the default grid of the same program keep separate entries instead
    of evicting each other on every alternation."""
    return _sha({"grid": [c.as_dict() for c in configs],
                 "protocol": protocol})


def tuning_fingerprint(program, backend, configs: Sequence,
                       protocol: Dict[str, Any],
                       hw: Dict[str, float]) -> str:
    """The full cache key: see module docstring.  ``hw`` must be the
    DEFAULT pricing constants (never the calibrated ones — calibration
    drift must not evict measured tables, see tune())."""
    return _sha({
        "cost_model_version": COST_MODEL_VERSION,
        "program": program_fingerprint(program),
        "backend": backend_fingerprint(backend),
        "grid": [c.as_dict() for c in configs],
        "protocol": protocol,
        "hw": {k: hw[k] for k in sorted(hw)},
    })


def calibration_fingerprint(hw: Dict[str, float]) -> str:
    """Fitted constants are valid for one (cost-model version, default
    constants) pair; either changing discards them."""
    return _sha({"cost_model_version": COST_MODEL_VERSION,
                 "hw": {k: hw[k] for k in sorted(hw)}})


def device_class_key(backend) -> str:
    """Key of the per-DEVICE-CLASS store (calibration constants, measured
    candidate rows, fitted cross-program predictor).  Unlike
    ``backend_fingerprint`` it deliberately EXCLUDES the stream count and
    the donation flag: those are per-candidate knobs (features of a
    measured row), not properties of the silicon — a 4-stream and a
    2-stream run of the same device must pool their measurements rather
    than fit in separate slots.  A mesh backend folds in its mesh, as
    ``backend_fingerprint`` does."""
    return (f"{type(backend).__name__}:{backend.name}:{_device_key(backend)}"
            f"{_mesh_suffix(backend)}")


class TuneCache:
    """One JSON file per slot under ``path``; lookups validate the
    stored fingerprint and evict on mismatch (stale-entry invalidation).
    Writes are atomic (tempfile + rename).

    The cache is bounded: past ``max_entries`` slot files (default 256,
    or ``REPRO_TORCH_TUNE_CACHE_MAX``), ``store`` evicts the least-recently
    used entries by file mtime — lookups touch their entry so a hot slot
    survives a cold sweep.  ``max_entries <= 0`` disables eviction."""

    def __init__(self, path: Optional[Any] = None,
                 max_entries: Optional[int] = None):
        if max_entries is None:
            try:
                max_entries = int(os.environ.get(
                    _MAX_ENV_VAR, _DEFAULT_MAX_ENTRIES))
            except ValueError:
                max_entries = _DEFAULT_MAX_ENTRIES
        self.max_entries = max_entries
        if path is None:
            env = os.environ.get(_ENV_VAR)
            # a disable sentinel is not a directory name: a direct
            # TuneCache() under REPRO_TORCH_TUNE_CACHE=off must not create a
            # literal ./off — fall through to the XDG default (callers
            # wanting the sentinel honored use default_cache())
            if env and env.strip().lower() not in _DISABLED:
                path = env
            else:
                xdg = os.environ.get("XDG_CACHE_HOME",
                                     os.path.expanduser("~/.cache"))
                path = os.path.join(xdg, "repro_torch", "tunecache")
        self.path = pathlib.Path(path)

    # -- internals ----------------------------------------------------------
    def _slot_path(self, slot: str) -> pathlib.Path:
        safe = re.sub(r"[^A-Za-z0-9._-]+", "_", slot)[:48]
        return self.path / f"{safe}-{_sha(slot)[:16]}.json"

    # -- tuning entries -----------------------------------------------------
    def lookup(self, slot: str, fingerprint: str) -> Optional[Dict]:
        """The payload stored for ``slot`` iff its fingerprint matches;
        a stale entry is deleted and reported as a miss."""
        fp_path = self._slot_path(slot)
        try:
            entry = json.loads(fp_path.read_text())
        except (OSError, ValueError):
            return None
        if entry.get("fingerprint") != fingerprint:
            try:
                fp_path.unlink()
            except OSError:
                pass
            return None
        try:
            os.utime(fp_path)  # LRU recency: a hit keeps the entry warm
        except OSError:
            pass
        return entry.get("payload")

    def evict(self, slot: str) -> None:
        """Drop ``slot``'s entry (used when a stored payload is corrupt
        or its rebuilt winner no longer passes the plan verifier — the
        fingerprint cannot see inside the payload, so the verifier is
        the load-time integrity check)."""
        try:
            self._slot_path(slot).unlink()
        except OSError:
            pass

    def store(self, slot: str, fingerprint: str, payload: Dict) -> None:
        self.path.mkdir(parents=True, exist_ok=True)
        entry = {"slot": slot, "fingerprint": fingerprint,
                 "cost_model_version": COST_MODEL_VERSION,
                 "payload": payload}
        fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(entry, f, indent=1, sort_keys=True, default=float)
            os.replace(tmp, self._slot_path(slot))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._evict_lru(keep=self._slot_path(slot))

    def _evict_lru(self, keep: Optional[pathlib.Path] = None) -> None:
        """Delete oldest-mtime entries until at most ``max_entries``
        remain.  The just-written slot (``keep``) is never evicted even
        when the cap is smaller than one."""
        if self.max_entries is None or self.max_entries <= 0:
            return
        try:
            files = list(self.path.glob("*.json"))
        except OSError:
            return
        if len(files) <= self.max_entries:
            return

        def _mtime(f: pathlib.Path) -> float:
            try:
                return f.stat().st_mtime
            except OSError:
                return float("inf")  # vanished: skip, don't evict for it

        files.sort(key=_mtime)
        excess = len(files) - self.max_entries
        for f in files:
            if excess <= 0:
                break
            if keep is not None and f == keep:
                continue
            try:
                f.unlink()
            except OSError:
                pass
            excess -= 1

    # -- per-device-class store ----------------------------------------------
    # One slot per device class (``device_class_key``) holding everything
    # measurement-derived the class accumulates across programs:
    #   {"calibration": fitted constants | absent,
    #    "programs":    {program_fp: {"program": name, "rows": [...]}},
    #    "predictor":   fitted cross-program model | absent}
    # Keyed per device class, not per backend, so the same device never
    # fits (and reads) different constants at each stream count.
    # Fingerprinted on (COST_MODEL_VERSION, default hw): either changing
    # drops the slot.

    _MAX_DEVCLASS_PROGRAMS = 32

    def _load_devclass(self, device_key: str,
                       hw: Dict[str, float]) -> Dict[str, Any]:
        payload = self.lookup(f"devclass--{device_key}",
                              calibration_fingerprint(hw))
        return dict(payload) if isinstance(payload, dict) else {}

    def _store_devclass(self, device_key: str, hw: Dict[str, float],
                        payload: Dict[str, Any]) -> None:
        self.store(f"devclass--{device_key}",
                   calibration_fingerprint(hw), payload)

    def load_calibration(self, device_key: str,
                         hw: Dict[str, float]) -> Optional[Dict[str, float]]:
        return self._load_devclass(device_key, hw).get("calibration")

    def store_calibration(self, device_key: str, hw: Dict[str, float],
                          fitted: Dict[str, float]) -> None:
        payload = self._load_devclass(device_key, hw)
        payload["calibration"] = fitted
        self._store_devclass(device_key, hw, payload)

    def add_measured_rows(self, device_key: str, hw: Dict[str, float],
                          program_fp: str, program_name: str,
                          rows: Sequence[Dict[str, Any]]) -> None:
        """Record one program's measured candidate rows (feature dicts,
        see ``roofline.analysis.candidate_features``) under the device
        class.  Re-tuning the same program replaces its rows; past
        ``_MAX_DEVCLASS_PROGRAMS`` programs the oldest entry is dropped
        (insertion order — dicts preserve it, JSON round-trips it)."""
        if not rows:
            return
        payload = self._load_devclass(device_key, hw)
        progs = payload.setdefault("programs", {})
        progs.pop(program_fp, None)
        progs[program_fp] = {"program": program_name, "rows": list(rows)}
        while len(progs) > self._MAX_DEVCLASS_PROGRAMS:
            del progs[next(iter(progs))]
        self._store_devclass(device_key, hw, payload)

    def load_measured_rows(self, device_key: str, hw: Dict[str, float],
                           exclude_fp: Optional[str] = None
                           ) -> list:
        """Every stored row across the class's programs — the predictor's
        training set.  ``exclude_fp`` drops the program being tuned, so
        pricing its grid is always a hold-one-out prediction."""
        progs = self._load_devclass(device_key, hw).get("programs") or {}
        rows = []
        for fp, entry in progs.items():
            if fp == exclude_fp:
                continue
            for row in entry.get("rows", ()):
                r = dict(row)
                r.setdefault("program", entry.get("program", fp))
                rows.append(r)
        return rows

    def load_predictor(self, device_key: str,
                       hw: Dict[str, float]) -> Optional[Dict[str, Any]]:
        return self._load_devclass(device_key, hw).get("predictor")

    def store_predictor(self, device_key: str, hw: Dict[str, float],
                        model: Dict[str, Any]) -> None:
        payload = self._load_devclass(device_key, hw)
        payload["predictor"] = model
        self._store_devclass(device_key, hw, payload)

    def clear(self) -> None:
        if self.path.is_dir():
            for f in self.path.glob("*.json"):
                try:
                    f.unlink()
                except OSError:
                    pass


def default_cache() -> Optional[TuneCache]:
    """Process default: honors ``REPRO_TORCH_TUNE_CACHE`` (set a directory
    to relocate, empty/"off" to disable)."""
    env = os.environ.get(_ENV_VAR)
    if env is not None and env.strip().lower() in _DISABLED:
        return None
    return TuneCache()
