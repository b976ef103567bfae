"""Pluggable execution backends for the plan runtime.

A ``Backend`` is alloc/upload/download/launch/sync plus per-stream events,
so the same ``Plan`` can run against:

``NumpyHostBackend``
    Both spaces are numpy.  Transfers are copies, launches run the block
    body with ``numpy``.  Useful for validating plans (the residency
    discipline is still enforced by the driver) without a device.

``TorchDeviceBackend``
    Device space is one torch device, ``cuda:0`` by default.  On CUDA,
    ``upload`` stages the host array in pinned memory and copies it
    asynchronously on one of ``n_streams`` transfer streams, block bodies
    run eagerly under ``torch`` on the compute stream, and ``sync(stream)``
    is a real wait point.  ``device="cpu"`` is the explicit host form the
    CPU tests use; a CUDA device without a card raises, never falls back.

Registered names, against the reference's: ``"numpy"`` → ``"numpy"``,
``jax`` → ``"torch"``, ``pinned`` → ``"pinned"``.  ``"torch"`` and
``"pinned"`` both build the ``TorchDeviceBackend``, whose uploads already
stage through pinned host memory (what the reference's pinned backend
adds to its ``jax`` one); ``"mesh"`` is
``distributed.mesh_backend.MeshBackend``, registered when that module is
first imported (``get_backend("mesh")`` imports it).

Streams are logical ids chosen by the planner (``AdvancedLoad.stream``
etc.); a backend may map many logical streams onto fewer physical ones
(``Backend._stream_of``).  Stream 0 is the compute stream by convention.

Unlike JAX, CUDA orders nothing across streams by data dependency, so
``TorchDeviceBackend`` states every edge itself: each device handle
carries the event after which its value is ready (``_ready_event``);
work on another stream waits for that event before touching the handle
and calls ``record_stream`` so the caching allocator does not recycle
the memory early.  Because every launch runs eagerly, in program order,
on the one compute stream, compiled and interpreted execution issue the
same kernels in the same order and their outputs are bitwise equal.

The blocks are fp32 products, computed in full fp32 as the reference
does: TF32 is turned off around each of the backend's own compute
launches and the caller's setting restored after it, so building or
running a backend changes no precision outside it.  Between
``time_kernels()`` and ``kernel_seconds()`` those launches are timed on
the card with CUDA events (``ExecStats.kernel_time``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .dtypes import torch_dtype

__all__ = [
    "Backend", "Event", "NumpyHostBackend",
    "TorchDeviceBackend", "get_backend", "register_backend",
]


@dataclasses.dataclass
class Event:
    """Completion handle for an async backend operation.

    ``payload`` is what must complete before the op is complete (a
    ``torch.cuda.Event`` for CUDA work, nothing for host work); ``keep``
    holds buffers the operation reads (a pinned staging copy) alive until
    then.  ``wait()`` is idempotent.
    """
    payload: Any = None
    _done: bool = False
    keep: Any = None

    def wait(self) -> None:
        if self._done:
            return
        if self.payload is not None:
            self.payload.synchronize()
        self.keep = None
        self._done = True


class Backend:
    """Protocol for plan-execution backends (duck-typed; subclass for the
    shared stream bookkeeping).

    Handles returned by ``upload``/``launch`` are opaque to the driver; it
    only stores them in slots and passes them back in.
    """

    name: str = "abstract"
    n_streams: int = 2   # logical transfer streams (double-buffered)
    supports_donation: bool = False   # can ``donate=True`` change execution?
    # can a kernel's tile choice (``kernel_variants``) change execution?
    # True keeps every tile its own execution class, as the reference's
    # backends do: the numpy backend's tuning tables are the parity
    # baseline against the reference's
    reads_kernel_tiles: bool = True

    def __init__(self) -> None:
        self._pending: Dict[int, List[Event]] = {}
        self.loop_dispatches = 0   # fused whole-loop launches (launch_loop)

    def variant(self, *, n_streams: Optional[int] = None,
                donate: Optional[bool] = None) -> "Backend":
        """A backend identical to this one except for the given knobs —
        the tuner uses it to measure each candidate on a PHYSICALLY
        matching backend (a streams-3 plan on a 3-queue backend, a
        donate candidate on a donating one) instead of folding every
        config onto the caller's instance.  Backends without the knob
        return themselves; implementations must memoize twins so
        compiled-plan caches are shared across tuning calls."""
        return self

    @property
    def xp(self):
        """Array namespace block bodies run under (numpy or torch)."""
        raise NotImplementedError

    # -- stream/event bookkeeping (shared) ---------------------------------
    _MAX_PENDING = 64     # per stream; oldest events are drained past this

    def _stream_of(self, stream: int) -> int:
        """Logical → physical stream.  Stream 0 (compute) is reserved;
        transfer streams 1..∞ fold onto the backend's 1..n_streams so
        they never collide with the compute queue."""
        if stream <= 0:
            return 0
        return 1 + (stream - 1) % max(self.n_streams, 1)

    def _record(self, stream: int, ev: Event) -> Event:
        q = self._pending.setdefault(self._stream_of(stream), [])
        q.append(ev)
        # bound the queue so callers that never sync don't pin every
        # in-flight buffer forever
        while len(q) > self._MAX_PENDING:
            q.pop(0).wait()
        return ev

    def sync(self, stream: Optional[int] = None) -> None:
        """Block until every event on ``stream`` (or all streams) is done."""
        keys = (list(self._pending) if stream is None
                else [self._stream_of(stream)])
        for k in keys:
            for ev in self._pending.pop(k, ()):
                ev.wait()

    def track(self, handle: Any, *, stream: int = 0) -> Any:
        """Register an externally produced handle (e.g. a fused-launch
        output) so a later ``sync(stream)`` waits on it."""
        self._record(stream, Event(payload=None, _done=True))
        return handle

    # -- memory ------------------------------------------------------------
    def alloc(self, shape: Tuple[int, ...], dtype) -> Any:
        """Fresh zero device buffer (used for pruned/dead block inputs)."""
        raise NotImplementedError

    def upload(self, host: np.ndarray, *, stream: int = 0,
               name: Optional[str] = None) -> Any:
        """h2d: returns a device handle; completion tracked on ``stream``.
        ``name`` is the plan variable being uploaded (single-device
        backends ignore it)."""
        raise NotImplementedError

    def download(self, handle: Any, *, stream: int = 0) -> np.ndarray:
        """d2h: returns a host ndarray (a wait point for ``handle``)."""
        raise NotImplementedError

    def free(self, handle: Any) -> None:
        """Release a device handle (HMPP ``release``).  The backends here
        free by dropping the reference (on CUDA, ``record_stream`` keeps
        the allocator from reusing memory another stream still reads)."""

    # -- compute -----------------------------------------------------------
    def launch(self, fn: Callable[..., Dict[str, Any]],
               names: Sequence[str], writes: Sequence[str],
               args: Sequence[Any], *, stream: int = 0) -> Tuple[Any, ...]:
        """Run one offload block body; returns device handles for
        ``writes`` in order.  Dispatch may be asynchronous."""
        raise NotImplementedError

    def compile_fused(self, fused_fn: Callable[..., Tuple[Any, ...]],
                      donate_argnums: Tuple[int, ...] = ()
                      ) -> Callable[..., Tuple[Any, ...]]:
        """Lower a fused segment function (see ``core.compile``) to this
        backend's compiled form.  ``donate_argnums`` marks inputs the
        caller will not reuse; backends may ignore it.  Default: eager."""
        return fused_fn

    def launch_loop(self, body_fn: Callable[[Dict[str, Any]],
                                            Dict[str, Any]],
                    n_iters: int, carry: Dict[str, Any],
                    *, stream: int = 0,
                    donate_keys: Sequence[str] = ()) -> Dict[str, Any]:
        """Whole-loop launch: run ``carry = body_fn(carry)`` ``n_iters``
        times as ONE backend dispatch and return the final carry.

        ``carry`` maps loop-state names to device handles; ``body_fn`` is
        pure (built by ``core.compile`` over ``self.xp``) and returns a
        carry with the same keys plus any body-defined variables.  The
        backends here run a Python loop inside the one dispatch;
        ``loop_dispatches`` counts calls.  ``donate_keys`` names carry
        entries whose pre-launch buffers the caller will not reuse.
        """
        if n_iters < 1:
            raise ValueError("launch_loop needs n_iters >= 1")
        self.loop_dispatches += 1
        return self._launch_loop(body_fn, n_iters, carry, stream=stream,
                                 donate_keys=tuple(donate_keys))

    def _launch_loop(self, body_fn, n_iters: int, carry: Dict[str, Any],
                     *, stream: int = 0,
                     donate_keys: Tuple[str, ...] = ()) -> Dict[str, Any]:
        raise NotImplementedError

    def time_kernels(self) -> None:
        """Start timing this backend's compute launches on the device; a
        no-op where the executor's host clock is the kernel time (every
        backend here but a ``TorchDeviceBackend`` on CUDA)."""

    def kernel_seconds(self) -> Optional[float]:
        """Stop timing: the device seconds of the compute launches since
        ``time_kernels()``, or None where the host clock is the kernel
        time."""
        return None

    def finish(self) -> None:
        """Wait until every launch issued so far has completed (the end
        of an execution).  Host backends run synchronously."""

    def loop_in_body(self, body_fn: Callable[[Dict[str, Any]],
                                             Dict[str, Any]],
                     n_iters: int, env: Dict[str, Any]) -> Dict[str, Any]:
        """Run ``env = body_fn(env)`` ``n_iters`` times inside a fused
        launch — the primitive nested fused loops are built from."""
        for _ in range(n_iters):
            env = body_fn(env)
        return env


class NumpyHostBackend(Backend):
    """Both memory spaces are numpy; the device is simulated with copies so
    residency bugs (reading a stale space) still surface as wrong counts."""

    name = "numpy"

    @property
    def xp(self):
        return np

    def alloc(self, shape, dtype):
        return np.zeros(shape, dtype)

    def upload(self, host, *, stream: int = 0, name=None):
        handle = np.array(host, copy=True)
        self._record(stream, Event(payload=None, _done=True))
        return handle

    def download(self, handle, *, stream: int = 0):
        return np.array(handle, copy=True)

    def launch(self, fn, names, writes, args, *, stream: int = 0):
        out = fn(np, **dict(zip(names, args)))
        self._record(stream, Event(payload=None, _done=True))
        return tuple(np.asarray(out[w]) for w in writes)

    def compile_fused(self, fused_fn, donate_argnums=()):
        return fused_fn            # no tracing: eager numpy

    def _launch_loop(self, body_fn, n_iters, carry, *, stream: int = 0,
                     donate_keys=()):
        for _ in range(n_iters):
            carry = body_fn(carry)
        self._record(stream, Event(payload=None, _done=True))
        return carry


@contextlib.contextmanager
def _full_fp32():
    """TF32 off for the launches inside, the caller's flags back after.
    cuBLAS and cuDNN read the flags when the host enqueues a call, so
    saving and restoring them on the host scopes them exactly."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class TorchDeviceBackend(Backend):
    """One torch device; on CUDA, async pinned uploads on transfer streams
    and eager launches on the compute stream (see the module docstring
    for the ordering rules)."""

    name = "torch"
    # eager launches never reuse an input's buffer for an output, so a
    # donate flag cannot change execution; it is kept for the tuner's
    # ``variant(donate=...)`` twins
    supports_donation = False
    # neither flash kernel nor its plain version reads block_q/block_k
    # (they are only validated), so every tile launches the same work
    reads_kernel_tiles = False

    def __init__(self, device: Any = "cuda", *, n_streams: int = 2,
                 donate: bool = False):
        super().__init__()
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"TorchDeviceBackend(device={str(device)!r}): no CUDA "
                    "device is available (pass device='cpu' to run on the "
                    "host explicitly)")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            self._compute = torch.cuda.default_stream(dev)
            self._transfer: Dict[int, Any] = {0: self._compute}
        elif dev.type != "cpu":
            raise ValueError(f"unsupported device {dev}")
        self.device = dev
        # CUDA event pairs of the compute launches while timing, else None
        self._kernel_events: Optional[List[Tuple[Any, Any]]] = None
        self.n_streams = n_streams
        self.donate = donate
        # (n_streams, donate) -> twin; shared by every twin of this device
        self._variant_pool: Dict[Tuple[int, bool], "TorchDeviceBackend"] = {
            (n_streams, donate): self}

    @property
    def on_cuda(self) -> bool:
        return self.device.type == "cuda"

    def variant(self, *, n_streams: Optional[int] = None,
                donate: Optional[bool] = None) -> "TorchDeviceBackend":
        ns = self.n_streams if n_streams is None else max(1, int(n_streams))
        dn = self.donate if donate is None else bool(donate)
        twin = self._variant_pool.get((ns, dn))
        if twin is None:
            twin = type(self)(device=self.device, n_streams=ns, donate=dn)
            twin._variant_pool = self._variant_pool
            self._variant_pool[(ns, dn)] = twin
        return twin

    @property
    def xp(self):
        return torch

    def time_kernels(self) -> None:
        if self.on_cuda:
            self._kernel_events = []

    def kernel_seconds(self) -> Optional[float]:
        events, self._kernel_events = self._kernel_events, None
        if events is None:
            return None
        if not events:
            return 0.0
        events[-1][1].synchronize()
        return sum(a.elapsed_time(b) for a, b in events) / 1e3

    def finish(self) -> None:
        if self.on_cuda:
            self._compute.synchronize()

    # -- CUDA ordering helpers ---------------------------------------------
    def _stream(self, stream: int):
        """The physical CUDA stream a logical stream folds onto."""
        phys = self._stream_of(stream)
        s = self._transfer.get(phys)
        if s is None:
            s = self._transfer[phys] = torch.cuda.Stream(self.device)
        return s

    def torch_stream(self, stream: int = 0):
        """The physical CUDA stream logical ``stream`` folds onto (0: the
        compute stream), or None on the CPU."""
        return self._stream(stream) if self.on_cuda else None

    def _ready(self, tensors, stream) -> "torch.cuda.Event":
        """Record on ``stream`` the event after which ``tensors`` hold
        their values, and attach it to each of them."""
        ev = torch.cuda.Event()
        ev.record(stream)
        for t in tensors:
            t._ready_event, t._ready_stream = ev, stream
        return ev

    def _consume(self, tensors, stream) -> None:
        """Make ``stream`` wait for every tensor produced on another
        stream, and tell the allocator the tensor is in use there."""
        for t in tensors:
            src = getattr(t, "_ready_stream", None)
            if src is not None and src != stream:
                stream.wait_event(t._ready_event)
                t.record_stream(stream)

    def _run_compute(self, args, body):
        """Run ``body()`` eagerly on the compute stream after the waits
        its tensor arguments need; returns its result unchanged and the
        ready event of the tensors in it (None on CPU)."""
        if not self.on_cuda:
            return body(), None
        self._consume(args, self._compute)
        events = self._kernel_events
        with torch.cuda.stream(self._compute), _full_fp32():
            if events is not None:
                start = torch.cuda.Event(enable_timing=True)
                start.record(self._compute)
            out = body()
            if events is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record(self._compute)
                events.append((start, end))
        vals = out.values() if isinstance(out, dict) else out
        return out, self._ready(vals, self._compute)

    # -- memory ------------------------------------------------------------
    def alloc(self, shape, dtype):
        return torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                           device=self.device)

    def upload(self, host, *, stream: int = 0, name=None):
        if not self.on_cuda:
            self._record(stream, Event(payload=None, _done=True))
            return torch.from_numpy(np.array(host, copy=True))
        host = np.asarray(host)
        # one host copy, straight into pinned memory the DMA can read
        pinned = torch.empty(host.shape, dtype=torch_dtype(host.dtype),
                             pin_memory=True)
        pinned.numpy()[...] = host
        s = self._stream(stream)
        with torch.cuda.stream(s):
            handle = pinned.to(self.device, non_blocking=True)
        ev = self._ready([handle], s)
        self._record(stream, Event(payload=ev, keep=pinned))
        return handle

    def download(self, handle, *, stream: int = 0):
        if not self.on_cuda:
            return handle.detach().numpy().copy()
        s = self._stream(stream)
        self._consume([handle], s)
        host = torch.empty(handle.shape, dtype=handle.dtype,
                           pin_memory=True)
        with torch.cuda.stream(s):
            host.copy_(handle, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(s)
        ev.synchronize()                                    # wait point
        return host.numpy().copy()

    # -- compute -----------------------------------------------------------
    def launch(self, fn, names, writes, args, *, stream: int = 0):
        def body():
            out = fn(torch, **dict(zip(names, args)))
            return tuple(out[w] for w in writes)
        outs, ev = self._run_compute(args, body)
        self._record(stream, Event(payload=ev, _done=ev is None))
        return outs

    def compile_fused(self, fused_fn, donate_argnums=()):
        def run(*args):
            return self._run_compute(args, lambda: fused_fn(*args))[0]
        return run

    def track(self, handle, *, stream: int = 0):
        ev = getattr(handle, "_ready_event", None)
        self._record(stream, Event(payload=ev, _done=ev is None))
        return handle

    def _launch_loop(self, body_fn, n_iters, carry, *, stream: int = 0,
                     donate_keys=()):
        def body():
            env = carry
            for _ in range(n_iters):
                env = body_fn(env)
            return env
        out, ev = self._run_compute(list(carry.values()), body)
        self._record(stream, Event(payload=ev, _done=ev is None))
        return out


_REGISTRY: Dict[str, Callable[[], Backend]] = {
    "numpy": NumpyHostBackend,
    "torch": TorchDeviceBackend,
    # the reference's "pinned": staged through pinned memory, as "torch" is
    "pinned": TorchDeviceBackend,
}


def register_backend(name: str, factory: Callable[[], Backend]) -> None:
    _REGISTRY[name] = factory
    _INSTANCES.pop(name, None)


_INSTANCES: Dict[str, Backend] = {}


def get_backend(spec: Any = None) -> Backend:
    """Resolve a backend: an instance passes through; ``None`` (the
    ``"torch"`` backend on ``cuda:0``) or a registered name returns a
    memoized process-wide instance, so compiled-plan lowerings are reused
    across ``execute`` calls no matter how the backend was named."""
    if isinstance(spec, Backend):
        return spec
    if spec is None:
        spec = "torch"
    if spec == "mesh" and spec not in _REGISTRY:
        from ..distributed import mesh_backend  # noqa: F401 - registers
    if spec not in _INSTANCES:
        try:
            factory = _REGISTRY[spec]
        except KeyError:
            raise ValueError(
                f"unknown backend {spec!r}; have "
                f"{sorted(_REGISTRY)}") from None
        _INSTANCES[spec] = factory()
    return _INSTANCES[spec]
