"""The port's fault-tolerance module (``repro_torch.runtime``): the
reference's ``tests/test_fault.py`` cases against the port's own copy,
and its decisions against the reference's (``src/repro/runtime``) on the
same inputs."""
import pytest

import repro.runtime as ref
from repro_torch.runtime import (ElasticController, FaultInjector, Heartbeat,
                                 StepWatchdog, run_with_retries)


def test_heartbeat_dead_host_detection():
    hb = Heartbeat(timeout=5.0)
    hb.tick("h0", now=100.0)
    hb.tick("h1", now=100.0)
    hb.tick("h0", now=109.0)
    assert hb.dead_hosts(now=110.0) == ["h1"]
    assert hb.live_hosts(now=110.0) == ["h0"]


def test_watchdog_flags_straggler():
    wd = StepWatchdog(factor=2.0)
    for h in ("h0", "h1", "h2", "h3"):
        wd.record(h, 1.0)
    wd.record("h2", 5.0)
    assert wd.stragglers() == ["h2"]


def test_watchdog_no_false_positive():
    wd = StepWatchdog(factor=2.0)
    for h in ("h0", "h1"):
        wd.record(h, 1.0)
    assert wd.stragglers() == []


def test_elastic_controller_shrinks_data_axis():
    ec = ElasticController(chips_per_host=4, model_axis=16)
    d = ec.decide(n_live_hosts=128)         # 512 chips
    assert d.mesh_shape == (32, 16)
    d = ec.decide(n_live_hosts=100)         # 400 chips -> data 16 (pow2)
    assert d.mesh_shape == (16, 16)
    with pytest.raises(RuntimeError):
        ec.decide(n_live_hosts=2)


def test_run_with_retries():
    inj = FaultInjector((0, 1))
    calls = []

    def train_fn(_):
        step = len(calls)
        calls.append(step)
        inj.maybe_fail(step)
        return 99

    final, restarts = run_with_retries(train_fn, max_restarts=3)
    assert final == 99 and restarts == 2


def test_run_with_retries_exhausted():
    def always_fail(_):
        raise RuntimeError("boom")
    with pytest.raises(RuntimeError):
        run_with_retries(always_fail, max_restarts=2)


@pytest.mark.parametrize("chips_per_host,model_axis", [(4, 16), (8, 8),
                                                       (1, 2)])
def test_elastic_decisions_equal_reference(chips_per_host, model_axis):
    port = ElasticController(chips_per_host, model_axis)
    want = ref.ElasticController(chips_per_host, model_axis)
    for n in range(1, 300):
        try:
            w = want.decide(n)
        except RuntimeError:
            with pytest.raises(RuntimeError):
                port.decide(n)
            continue
        g = port.decide(n)
        assert (g.n_hosts, g.mesh_shape, g.mesh_axes) == \
            (w.n_hosts, w.mesh_shape, w.mesh_axes)


def test_heartbeat_and_watchdog_equal_reference():
    import random
    rnd = random.Random(0)
    pairs = [(Heartbeat(3.0), ref.Heartbeat(3.0)),
             (StepWatchdog(1.5, 4), ref.StepWatchdog(1.5, 4))]
    (hb, rhb), (wd, rwd) = pairs
    for t in range(200):
        host = f"h{rnd.randrange(6)}"
        hb.tick(host, now=float(t))
        rhb.tick(host, now=float(t))
        dt = rnd.expovariate(1.0)
        wd.record(host, dt)
        rwd.record(host, dt)
        assert hb.dead_hosts(now=t + 2.5) == rhb.dead_hosts(now=t + 2.5)
        assert hb.live_hosts(now=t + 2.5) == rhb.live_hosts(now=t + 2.5)
        assert wd.stragglers() == rwd.stragglers()


def test_fault_injector_fires_once_per_step():
    inj = FaultInjector((2, 5))
    for step in range(8):
        if step in (2, 5):
            with pytest.raises(RuntimeError, match=f"step {step}"):
                inj.maybe_fail(step)
        inj.maybe_fail(step)           # a retried step does not fail again
    assert inj.failures == 2
