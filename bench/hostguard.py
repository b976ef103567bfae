"""Supervise one run of the benchmark and stop it before it exhausts the
host's memory.

``bench/run.py`` starts the cell's run as one child process with the same
interpreter, arguments and environment, plus ``MARK`` and the
supervisor's start; the child writes to this process's own standard
output and error.  Every ``POLL_S`` the supervisor reads the host's
headroom (``HostMemory``).  Where it falls under ``MARGIN`` and the kill
is what ends the child, the run exits with ``STOPPED`` and no result
line.  Any other end of the child is passed on as it is: its exit code,
or its death by a signal, which the supervisor re-raises on itself.

This module is the standard library alone: it loads no torch, numpy or
program, and holds no CUDA context, so it keeps polling while the child
sits inside one multi-GiB allocation.
"""
from __future__ import annotations

import ctypes
import os
import resource
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

GIB = 1 << 30
# The one-card machine ends a command at 96 GiB in use of the 101 GiB
# MemTotal it shows (5 GiB), and a kill takes effect only once the call in
# flight returns: a pinned block of up to 16 GiB goes on filling.  A poll
# can come 0.18 s late under load, 1.3 GiB of a 7 GiB/s fill.  So 5 + 16
# + 3.
MARGIN = 24 * GIB
POLL_S = 0.05
STOPPED = 4
MARK = "--supervised"
_PR_SET_PDEATHSIG = 1

Reader = Callable[[], Tuple[int, int]]


class HostMemory:
    """``()`` -> (headroom, in use), in bytes, against the tighter of the
    host's bounds: ``MemAvailable`` of ``MemTotal``, and under a cgroup v2
    limit ``memory.max - memory.current`` of this process's own group.  In
    use is that bound's size less the headroom.  Only reads."""

    def __init__(self, proc: str = "/proc", cgroup_fs: str = "/sys/fs/cgroup"):
        self.meminfo = Path(proc) / "meminfo"
        self.group = _own_group(Path(proc) / "self" / "cgroup",
                                Path(cgroup_fs))

    def __call__(self) -> Tuple[int, int]:
        info = {}
        for line in self.meminfo.read_text().splitlines():
            key, _, rest = line.partition(":")
            if key in ("MemTotal", "MemAvailable"):
                info[key] = int(rest.split()[0]) * 1024
        room, size = info["MemAvailable"], info["MemTotal"]
        if self.group is not None:
            limit = (self.group / "memory.max").read_text().strip()
            if limit != "max":
                used = int((self.group / "memory.current").read_text())
                if int(limit) - used < room:
                    room, size = int(limit) - used, int(limit)
        return room, size - room


def _own_group(cgroup: Path, fs: Path) -> Optional[Path]:
    """This process's cgroup v2 group, where it states a memory limit."""
    try:
        lines = cgroup.read_text().splitlines()
    except OSError:
        return None
    rel = next((ln[3:] for ln in lines if ln.startswith("0::")), None)
    if rel is None:
        return None
    group = fs / rel.lstrip("/")
    if all((group / f).is_file() for f in ("memory.max", "memory.current")):
        return group
    return None


class _Watch:
    """The readings of one run: start, peak, least headroom and the
    fastest fall of headroom between two polls."""

    def __init__(self, room: int, use: int):
        self.start_use = self.peak_use = use
        self.least = self.last = room
        self.fall = 0

    def add(self, room: int, use: int) -> None:
        self.peak_use = max(self.peak_use, use)
        self.least = min(self.least, room)
        self.fall = max(self.fall, self.last - room)
        self.last = room

    def line(self) -> str:
        return (f"bench: host memory: peak {self.peak_use / GIB:.2f} GiB in "
                f"use, {(self.peak_use - self.start_use) / GIB:.2f} GiB above "
                f"the start, headroom at least {self.least / GIB:.2f} GiB; "
                f"it fell at most {self.fall / GIB:.3f} GiB between two polls")


def _die_with_parent(parent: int) -> Callable[[], None]:
    """The child is killed if the supervisor dies first, so a supervisor
    ended by ``SIGKILL`` leaves no run behind on the card."""
    def pre() -> None:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(_PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0)
        if os.getppid() != parent:
            os._exit(1)
    return pre


def supervise(cmd: Sequence[str], label: str, t_start: float,
              headroom: Optional[Reader] = None) -> int:
    """Run ``cmd`` plus ``MARK t_start`` as the child and watch the host.
    Returns the child's exit code, ``-signal`` where a signal ended it, or
    ``STOPPED`` where the headroom fell under ``MARGIN`` and the kill ended
    the child.  The host line goes to standard error where the child
    printed no result (any end but 0); a run that printed one has said its
    own peak before its checks, which stay the last lines."""
    read = headroom or HostMemory()
    watch = _Watch(*read())
    proc = subprocess.Popen([*cmd, MARK, repr(t_start)],
                            preexec_fn=_die_with_parent(os.getpid()))
    forward = {s: signal.signal(s, lambda n, _f: proc.send_signal(n))
               for s in (signal.SIGTERM, signal.SIGINT)}
    stop = None
    try:
        while proc.poll() is None:
            t = time.monotonic()
            room, use = read()
            watch.add(room, use)
            if room < MARGIN and stop is None:
                # the watch goes on until the child has ended: the call in
                # flight may still add to the host's peak
                stop = (f"bench: {label}: stopped: the host had "
                        f"{room / GIB:.2f} GiB left (margin {MARGIN / GIB:g} "
                        f"GiB) after {time.perf_counter() - t_start:.1f} s; "
                        f"host memory in use rose "
                        f"{(use - watch.start_use) / GIB:.2f} GiB since the "
                        f"start")
                proc.kill()
            time.sleep(max(0.0, POLL_S - (time.monotonic() - t)))
    finally:
        for s, h in forward.items():
            signal.signal(s, h)
    if stop is not None and proc.returncode == -signal.SIGKILL:
        _say(stop)
        _say(watch.line())
        return STOPPED
    if proc.returncode != 0:
        _say(watch.line())
    return proc.returncode


def _say(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def end(code: int) -> int:
    """Pass a child's end on: its exit code, or its death by a signal,
    re-raised on this process with the signal's default action (and no
    core of this process)."""
    if code >= 0:
        return code
    sig = -code
    if sig not in (signal.SIGKILL, signal.SIGSTOP):
        signal.signal(sig, signal.SIG_DFL)
    resource.setrlimit(resource.RLIMIT_CORE,
                       (0, resource.getrlimit(resource.RLIMIT_CORE)[1]))
    os.kill(os.getpid(), sig)
    return 128 + sig
