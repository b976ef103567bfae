"""Synthetic LM data pipeline with planner-style prefetch.

The port of ``src/repro/data/pipeline.py``.  ``SyntheticLM`` is its numpy
stream, value for value: batch ``i`` is a pure function of (seed, i), so
a checkpoint needs only the step counter.  ``PrefetchIterator`` is the
paper's hoisted upload (Fig. 4b) on a card: a producer thread builds
batch i+1, pins it and copies it to the device on a stream of its own
while step i runs (advancedload); ``__next__`` makes the consumer's
stream wait for that copy and marks each tensor as used there
(``record_stream``), so the caching allocator cannot hand a batch's
memory to another tensor before the step that reads it is done.  With
``shardings`` (a dict of ``distributed.NamedSharding`` per batch key,
the reference's ``shardings=``) each rank copies only its shard of each
batch array on that stream and gets a DTensor at the key's placements.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

__all__ = ["SyntheticLM", "PrefetchIterator"]


class SyntheticLM:
    """Deterministic synthetic token stream.

    Batch ``i`` is a pure function of (seed, i): restart-safe and
    mesh-agnostic."""

    def __init__(self, cfg, batch: int, seq: int, seed: int = 0):
        self.cfg, self.batch, self.seq, self.seed = cfg, batch, seq, seed

    def batch_at(self, index: int) -> Dict[str, np.ndarray]:
        """Learnable stream: tokens follow an affine recurrence
        t_{i+1} = (a·t_i + c) mod V with occasional random resets, labels
        are next-token, so cross-entropy decreasing below ln(V) is a real
        end-to-end signal."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, index]))
        cfg = self.cfg
        V = cfg.vocab
        out: Dict[str, np.ndarray] = {}
        toks = np.empty((self.batch, self.seq + 1), np.int64)
        toks[:, 0] = rng.integers(0, V, (self.batch,))
        resets = rng.random((self.batch, self.seq)) < 0.05
        fresh = rng.integers(0, V, (self.batch, self.seq))
        for t in range(self.seq):
            nxt = (5 * toks[:, t] + 13) % V
            toks[:, t + 1] = np.where(resets[:, t], fresh[:, t], nxt)
        if cfg.input_embeds:
            out["embeds"] = rng.standard_normal(
                (self.batch, self.seq, cfg.d_model)).astype(np.float32)
        else:
            out["tokens"] = toks[:, :-1].astype(np.int32)
        if cfg.n_codebooks:
            out["labels"] = rng.integers(
                0, V, (self.batch, self.seq, cfg.n_codebooks),
                dtype=np.int32)
        else:
            out["labels"] = toks[:, 1:].astype(np.int32)
        return out


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("PrefetchIterator: no CUDA device is available "
                           "(pass device='cpu' to feed the host)")
    return dev


class PrefetchIterator:
    """Device prefetch ``depth`` batches ahead (advancedload).

    ``device`` defaults to ``cuda`` (or the shardings' mesh device) and
    raises without a card.  ``state_dict``/``restore`` round-trip the
    cursor for checkpoint/restart."""

    def __init__(self, source: SyntheticLM, start_index: int = 0,
                 depth: int = 2, device=None,
                 shardings: Optional[Dict[str, Any]] = None):
        self.source = source
        self.index = start_index
        self.depth = depth
        self.shardings = shardings
        if device is None and shardings:
            device = next(iter(shardings.values())).mesh.device_type
        self.device = _device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _put_device(self, host_batch):
        """(device batch, the event its copies complete at, or None)."""
        shapes = {k: v.shape for k, v in host_batch.items()}
        if self.shardings is not None:
            from ..distributed.sharding import host_shard
            host_batch = {k: np.ascontiguousarray(host_shard(
                v, self.shardings[k].mesh, self.shardings[k].placements))
                for k, v in host_batch.items()}
        tensors = {k: torch.from_numpy(v) for k, v in host_batch.items()}
        ready = None
        if self._stream is not None:
            with torch.cuda.stream(self._stream):
                tensors = {k: t.pin_memory().to(self.device,
                                                non_blocking=True)
                           for k, t in tensors.items()}
                ready = torch.cuda.Event()
                ready.record(self._stream)
        if self.shardings is not None:
            from ..distributed.sharding import wrap_shard
            tensors = {k: wrap_shard(t, self.shardings[k].mesh,
                                     self.shardings[k].placements, shapes[k])
                       for k, t in tensors.items()}
        return tensors, ready

    def _producer(self):
        idx = self.index
        while not self._stop.is_set():
            item = (idx, *self._put_device(self.source.batch_at(idx)))
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            idx += 1

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return self

    def __next__(self) -> Dict[str, Any]:
        idx, batch, ready = self._q.get()
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in batch.values():
                (t.to_local() if self.shardings is not None
                 else t).record_stream(stream)
        self.index = idx + 1
        return batch

    def state_dict(self) -> Dict[str, int]:
        return {"index": self.index}

    @classmethod
    def restore(cls, source: SyntheticLM, state: Dict[str, int],
                **kw) -> "PrefetchIterator":
        return cls(source, start_index=state["index"], **kw)

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
