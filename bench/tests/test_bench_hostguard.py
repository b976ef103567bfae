"""The supervisor of a run (``hostguard.py``): what a child prints and how
it ends pass through unchanged, a run whose host runs low on memory is
stopped with exit code 4 and no result, and ``setup_s`` still counts
from the supervisor's start.  The headroom is faked, so nothing here
depends on this machine's memory."""
import json
import os
import signal
import subprocess
import sys
import time

import pytest

from bench import harness, hostguard
from bench.tests import tiny

TRAIN = "internlm2-20b.train-4k"
PATHS = [str(harness.ROOT / "src"), str(harness.ROOT)]
ARGS = ["--workload", "a.cell", "--seed", "7"]

SUPERVISOR = """
import os, sys, time
sys.path[:0] = {paths!r}
from bench import hostguard, run
GIB = hostguard.GIB


def ended(pid):
    with open(f"/proc/{{pid}}/stat") as f:
        return f.read().rsplit(")", 1)[1].split()[0] == "Z"


def after(path, wait=False):
    # plenty of headroom until the child has written its pid to ``path``
    # (with ``wait``: until it has also ended), then 1 GiB
    def room():
        if not os.path.exists(path):
            return 64 * GIB, GIB
        while wait and not ended(int(open(path).read())):
            time.sleep(0.01)
        print("headroom low", file=sys.stderr, flush=True)
        return GIB, 60 * GIB
    return room


print("T_START", repr(run.T_START), file=sys.stderr, flush=True)
room = {room}
sys.exit(hostguard.end(run.supervise(
    sys.argv[1:], child=[sys.executable, "-c", {child!r}], headroom=room)))
"""
PLENTY = "lambda: (64 * GIB, GIB)"


def _command(child, room=PLENTY, args=ARGS):
    code = SUPERVISOR.format(paths=PATHS, room=room, child=child)
    return [sys.executable, "-c", code, *args]


def _run(tmp_path, child, room=PLENTY, args=ARGS, timeout=120):
    return subprocess.run(_command(child, room, args),
                          capture_output=True, timeout=timeout, cwd=tmp_path)


def _gone(pid: int) -> bool:
    """No such process, or one that has ended and waits to be reaped."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


@pytest.mark.parametrize("code", [0, 7])
def test_a_finished_child_passes_its_output_and_exit_code(tmp_path, code):
    out = b"first\n\x00\xff bytes\n" + json.dumps({"correct": True}).encode()
    child = ("import os, sys\n"
             f"os.write(1, {out!r})\n"
             "print('from the child', file=sys.stderr)\n"
             f"sys.exit({code})\n")
    res = _run(tmp_path, child)
    assert res.returncode == code, res.stderr
    assert res.stdout == out
    err = res.stderr.decode().strip().splitlines()
    # a run that ends 0 has printed its checks last: the supervisor adds
    # nothing after them; any other end gets the host line
    assert err[0].startswith("T_START ")
    if code == 0:
        assert err[1:] == ["from the child"]
    else:
        assert err[1] == "from the child"
        assert err[-1].startswith("bench: host memory: peak 1.00 GiB")


def test_low_headroom_stops_the_child_with_no_result(tmp_path):
    pidfile = tmp_path / "child.pid"
    child = ("import json, os, time\n"
             "print('partial', flush=True)\n"
             f"open({str(pidfile)!r}, 'w').write(str(os.getpid()))\n"
             "time.sleep(300)\n"
             "print(json.dumps({'correct': True}))\n")
    t = time.monotonic()
    res = _run(tmp_path, child, f"after({str(pidfile)!r})")
    assert time.monotonic() - t < 60
    assert res.returncode == hostguard.STOPPED == 4, res.stderr
    assert res.stdout == b"partial\n"
    err = res.stderr.decode()
    assert ("bench: a.cell seed 7: stopped: the host had 1.00 GiB left "
            "(margin 24 GiB) after ") in err
    assert "host memory in use rose 59.00 GiB since the start" in err
    assert "bench: host memory: peak 60.00 GiB in use" in err
    assert _gone(int(pidfile.read_text()))


def test_a_child_that_ends_as_the_stop_comes_passes_its_own_end(tmp_path):
    """The headroom falls under the margin after the child has printed its
    result and exited 0, before the supervisor has reaped it: the kill
    ends nothing, so the run is no stop and the child's 0 passes."""
    pidfile = tmp_path / "child.pid"
    out = json.dumps({"correct": True}) + "\n"
    child = ("import os, sys, time\n"
             f"open({str(pidfile)!r} + '.tmp', 'w').write(str(os.getpid()))\n"
             f"os.replace({str(pidfile)!r} + '.tmp', {str(pidfile)!r})\n"
             "time.sleep(0.5)\n"
             f"sys.stdout.write({out!r})\n")
    res = _run(tmp_path, child, f"after({str(pidfile)!r}, wait=True)")
    assert res.returncode == 0, res.stderr
    assert res.stdout == out.encode()
    err = res.stderr.decode()
    assert "headroom low" in err
    assert "stopped" not in err and "bench: host memory" not in err
    assert _gone(int(pidfile.read_text()))


@pytest.mark.parametrize("sig,how", [(signal.SIGKILL, "itself"),
                                     (signal.SIGSEGV, "itself"),
                                     (signal.SIGTERM, "forwarded")],
                         ids=["SIGKILL", "SIGSEGV", "SIGTERM-forwarded"])
def test_a_childs_death_by_a_signal_is_passed_on(tmp_path, sig, how):
    pidfile = tmp_path / "child.pid"
    child = ("import os, resource, signal, time\n"
             "resource.setrlimit(resource.RLIMIT_CORE, (0, 0))\n"
             f"open({str(pidfile)!r}, 'w').write(str(os.getpid()))\n"
             + (f"os.kill(os.getpid(), {int(sig)})\n" if how == "itself"
                else "time.sleep(300)\n"))
    proc = subprocess.Popen(_command(child), cwd=tmp_path,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    if how == "forwarded":
        deadline = time.monotonic() + 60
        while not pidfile.exists() and time.monotonic() < deadline:
            time.sleep(0.05)
        proc.send_signal(sig)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == -sig, err
    assert out == b""
    assert _gone(int(pidfile.read_text()))


def test_a_killed_supervisor_takes_its_child_along(tmp_path):
    pidfile = tmp_path / "child.pid"
    child = ("import os, time\n"
             f"open({str(pidfile)!r}, 'w').write(str(os.getpid()))\n"
             "time.sleep(300)\n")
    proc = subprocess.Popen(_command(child), cwd=tmp_path,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    deadline = time.monotonic() + 60
    while not pidfile.exists() and time.monotonic() < deadline:
        time.sleep(0.05)
    proc.kill()
    proc.communicate(timeout=120)
    pid = int(pidfile.read_text())
    deadline = time.monotonic() + 30
    while not _gone(pid) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert _gone(pid)


@pytest.mark.parametrize("module", ["bench.hostguard", "bench.run"])
def test_the_supervisor_loads_no_torch_numpy_jax_or_program(module):
    code = (f"import json, sys\nsys.path[:0] = {PATHS!r}\nimport {module}\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=harness.ROOT)
    assert res.returncode == 0, res.stderr
    mods = json.loads(res.stdout)
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"torch", "numpy", "jax", "jaxlib", "flax", "repro",
                       "repro_torch"}
    assert "bench.harness" not in mods


def _fake_host(tmp_path, cgroup_lines, groups):
    proc, fs = tmp_path / "proc", tmp_path / "cgroup"
    (proc / "self").mkdir(parents=True)
    (proc / "meminfo").write_text(
        "MemTotal:       100000 kB\nMemFree:         1000 kB\n"
        "MemAvailable:    60000 kB\n")
    (proc / "self" / "cgroup").write_text(cgroup_lines + "\n")
    fs.mkdir()
    for rel, (limit, current) in groups.items():
        g = fs / rel
        g.mkdir(parents=True, exist_ok=True)
        (g / "memory.max").write_text(f"{limit}\n")
        (g / "memory.current").write_text(f"{current}\n")
    return hostguard.HostMemory(str(proc), str(fs))


K = 1024


@pytest.mark.parametrize("cgroup_lines,groups,room,in_use", [
    ("0::/", {}, 60000 * K, 40000 * K),
    ("6:memory:/job\n1:cpu:/job", {"memory/job": (1024, 1024)}, 60000 * K,
     40000 * K),
    ("0::/job/run", {"job/run": ("max", 1)}, 60000 * K, 40000 * K),
    ("0::/job/run", {"job/run": (50000 * K, 30000 * K)}, 20000 * K,
     30000 * K),
    ("0::/job/run", {"job/run": (90000 * K, 10000 * K)}, 60000 * K,
     40000 * K),
], ids=["no-group-limit", "cgroup-v1", "v2-max", "v2-limit-binds",
        "v2-limit-loose"])
def test_host_memory_reads_meminfo_and_the_cgroup_limit(tmp_path,
                                                        cgroup_lines, groups,
                                                        room, in_use):
    read = _fake_host(tmp_path, cgroup_lines, groups)
    assert read() == (room, in_use)


def test_setup_counts_from_the_supervisors_start(tmp_path, capsys):
    """The tiny train cell through ``run.supervise`` and ``run.finish``:
    ``train.run`` receives the supervisor's ``T_START``, the line's keys are
    those of the unsupervised call, the run's own host line precedes the
    checks, which stay last."""
    child = f"""
import sys
sys.path[:0] = {PATHS!r}
import torch
torch.set_num_threads(2)
from bench import harness, run
from bench.drivers import train
from bench.tests import tiny
args = run.parse(sys.argv[1:])
drive = train.run
def spy(*a):
    print("window t_start", repr(a[-1]), file=sys.stderr)
    return drive(*a)
train.run = spy
sys.exit(run.finish(tiny.cell(args.workload), harness.manifest(), args,
                    "cpu", args.supervised))
"""
    res = _run(tmp_path, child, args=["--workload", TRAIN, "--seed",
                                      str(2 ** 33 + 5), "--seconds", "1.5",
                                      "--trace", "0"], timeout=600)
    err = res.stderr.decode().strip().splitlines()
    assert res.returncode == 0, err[-20:]
    said = {ln.split()[0]: ln.split()[-1] for ln in err
            if ln.startswith(("T_START", "window t_start"))}
    assert float(said["window"]) == float(said["T_START"])
    host = [i for i, ln in enumerate(err)
            if ln.startswith("bench: host memory: ")]
    assert len(host) == 1
    assert err[host[0]].startswith(
        "bench: host memory: this process's peak resident set ")
    checks = [i for i, ln in enumerate(err) if ln.startswith("check ")]
    assert checks and host[0] == checks[0] - 1
    assert checks == list(range(len(err) - len(checks), len(err)))
    line = json.loads(res.stdout.decode().strip().splitlines()[-1])
    rc, plain, _ = tiny.run(TRAIN, capsys)
    assert rc == 0
    assert list(line) == list(plain)
    for key in ("metrics", "device", "readings", "checks"):
        assert list(line[key]) == list(plain[key]), key
