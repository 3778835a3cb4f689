"""Port host-level fault tolerance (`repro_torch.ft`: `HeartbeatMonitor`,
`FailureEvent` / `FailureInjector`, `StragglerPolicy`, `shrink_mesh`) vs
the reference `repro.ft`, on the inputs of tests/test_ft.py: every answer
identical, every injected event the same (step, host, kind, factor),
every shrunken mesh the same shape, names and dropped count."""

import pytest

from repro.ft import elastic as ref_elastic
from repro.ft import failures as ref_failures
from repro_torch.ft.elastic import StragglerPolicy, shrink_mesh
from repro_torch.ft.failures import (FailureEvent, FailureInjector,
                                     HeartbeatMonitor)

PACKAGES = ((HeartbeatMonitor, FailureInjector, StragglerPolicy),
            (ref_failures.HeartbeatMonitor, ref_failures.FailureInjector,
             ref_elastic.StragglerPolicy))


def _both(fn):
    """``fn(monitor_cls, injector_cls, straggler_cls)`` under the port
    and under the reference; asserts the two transcripts are equal."""
    got, want = (fn(*classes) for classes in PACKAGES)
    assert got == want
    return got


def test_heartbeat_dead_and_evict():
    def run(Mon, _, __):
        mon = Mon([0, 1, 2], timeout_s=10.0)
        for h in (0, 1, 2):
            mon.beat(h, 5.0)
        mon.beat(1, 20.0)
        out = [mon.dead(now=16.0)]
        mon.evict(2)
        out += [mon.dead(now=16.0), mon.alive]
        mon.beat(99, 0.0)
        out.append(99 in mon.last)
        mon.evict(2)
        return out + [dict(mon.last)]

    assert _both(run)[:3] == [[0, 2], [0], [0, 1]]


def test_heartbeat_boundary_is_strict():
    def run(Mon, _, __):
        mon = Mon([0], timeout_s=10.0)
        mon.beat(0, 0.0)
        return [mon.dead(now=10.0), mon.dead(now=10.0 + 1e-9)]

    assert _both(run) == [[], [0]]


@pytest.mark.parametrize("kw", [
    dict(n_hosts=4, seed=7, crash_rate=0.05, straggle_rate=0.05,
         horizon_steps=500),
    dict(n_hosts=4, seed=0, crash_rate=0.0, straggle_rate=0.0,
         horizon_steps=100),
    dict(n_hosts=16, seed=3, crash_rate=0.2, straggle_rate=0.1,
         horizon_steps=200),
])
def test_injector_events_identical(kw):
    def run(_, Inj, __):
        inj = Inj(**kw)
        steps = sorted({e.step for e in inj.events})[:5] + [10 ** 6]
        return ([(e.step, e.host, e.kind, e.factor) for e in inj.events],
                [[(e.step, e.host, e.kind, e.factor) for e in inj.at(s)]
                 for s in steps])

    events, _ = _both(run)
    assert bool(events) == (kw["crash_rate"] > 0)
    for step, host, kind, factor in events:
        assert 0 <= host < kw["n_hosts"] and 0 <= step < kw["horizon_steps"]
        assert kind in ("crash", "straggle")
        assert kind == "crash" or 2.0 <= factor <= 10.0


def test_failure_event_defaults():
    e = FailureEvent(3, 1, "crash")
    r = ref_failures.FailureEvent(3, 1, "crash")
    assert (e.step, e.host, e.kind, e.factor) == \
        (r.step, r.host, r.kind, r.factor) == (3, 1, "crash", 1.0)


def test_straggler_policy_flags_slow_host():
    def run(_, __, Pol):
        pol = Pol(threshold=3.0, window=20)
        for _ in range(5):
            for h in (0, 1, 2):
                pol.record(h, 1.0)
            pol.record(3, 10.0)
        return pol.stragglers()

    assert _both(run) == [3]


def test_straggler_policy_needs_three_samples():
    def run(_, __, Pol):
        pol = Pol(threshold=3.0)
        pol.record(0, 1.0)
        pol.record(1, 100.0)
        pol.record(1, 100.0)
        return [pol.stragglers(), Pol().stragglers()]

    assert _both(run) == [[], []]


def test_straggler_window_forgets_old_slowness():
    def run(_, __, Pol):
        pol = Pol(threshold=3.0, window=5)
        for h in (0, 1):
            for _ in range(5):
                pol.record(h, 1.0)
        for _ in range(5):
            pol.record(2, 50.0)
        out = [pol.stragglers()]
        for _ in range(5):
            pol.record(2, 1.0)
        return out + [pol.stragglers(), {h: list(t)
                                         for h, t in pol.times.items()}]

    assert _both(run)[:2] == [[2], []]


@pytest.mark.parametrize("model_width", [1, 2, 4, 8])
def test_shrink_mesh_equals_reference(model_width):
    """Every survivor count from 1 to 16: the mesh's device array shape,
    its axis names, the devices in order, and the count left out."""
    for n in range(1, 17):
        ids = list(range(100, 100 + n))
        mesh, dropped = shrink_mesh(ids, model_width)
        want, want_dropped = ref_elastic.shrink_mesh(ids, model_width)
        assert mesh.devices.shape == want.devices.shape, n
        assert mesh.axis_names == tuple(want.axis_names)
        assert dropped == want_dropped
        assert mesh.devices.tolist() == want.devices.tolist()
    mesh, _ = shrink_mesh([f"cuda:{i}" for i in range(3)], 2)
    assert mesh.devices.tolist() == [["cuda:0", "cuda:1"]]


@pytest.mark.parametrize("devices,width,match", [
    ([], 2, "no surviving devices"), ([0, 1], 0, "model_width"),
    ([0], -3, "model_width")])
def test_shrink_mesh_rejects_degenerate_inputs_as_the_reference(devices,
                                                                 width,
                                                                 match):
    with pytest.raises(ValueError, match=match) as got:
        shrink_mesh(devices, width)
    with pytest.raises(ValueError, match=match) as want:
        ref_elastic.shrink_mesh(devices, width)
    assert str(got.value) == str(want.value)
