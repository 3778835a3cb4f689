"""Port resilient sweep execution (`repro_torch.sim.harness`) vs the
reference `repro.sim.harness`, mirroring tests/test_harness.py on the CPU.

Fingerprints are stable (also across processes), sensitive to the
inputs, the backend and the device type, and never equal the
reference's; rate, event and fleet sweeps resume bit for bit from a
checkpoint directory, also after a SIGKILL mid-sweep; retry, timeout and
mesh -> local degradation (onto the mesh's first device) behave as in
the reference; the guards run by default, poisoned results raise, and
every violation of the reference's table raises the same
`InvariantViolation.invariant` in both packages."""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.metrics import RunTotals as RefRunTotals
from repro.sim import harness as ref_harness
from repro.sim.plan import plan_sweep as ref_plan_sweep
from repro.sim.sweep import SweepCell as RefCell
from repro_torch.checkpoint.manager import ChunkStore
from repro_torch.core.metrics import RunTotals
from repro_torch.core.traces import synthetic_trace
from repro_torch.core.workers import DEFAULT_FLEET
from repro_torch.fleet import FleetCell, TenantSpec
from repro_torch.sim import harness
from repro_torch.sim.events_batched import EventCell
from repro_torch.sim.exec import LocalBackend, MeshBackend, execute
from repro_torch.sim.harness import (ChunkExecutionError, ChunkTimeout,
                                     InvariantViolation, RetryPolicy,
                                     _call_with_timeout, check_drift,
                                     check_sweep_result, check_totals,
                                     chunk_fingerprint, plan_fingerprint)
from repro_torch.sim.plan import plan_sweep
from repro_torch.sim.ratesim import Accum
from repro_torch.sim.sweep import (sweep, sweep_events, sweep_fleet,
                                   tune_fpga_dynamic_cells)
from repro_torch.sim.sweep import SweepCell
from test_torch_fleet import KW as FLEET_KW
from test_torch_fleet import QFLEET, dyadic_tenants

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
POLICIES = ("spork", "cpu_dynamic", "fpga_static")


def _counts(horizon=400):
    return synthetic_trace(seed=0, horizon_s=horizon, request_size_s=0.05,
                           mean_demand_workers=20.0).counts


def _rate_cells(n_policies=3, counts=None):
    counts = _counts() if counts is None else counts
    return [SweepCell(p, counts, 0.05, DEFAULT_FLEET)
            for p in POLICIES[:n_policies]]


def _event_cells():
    rng = np.random.default_rng(1)
    return [EventCell(d, np.sort(rng.uniform(0.0, 60.0, 50)), 1.0,
                      DEFAULT_FLEET, horizon_s=60.0)
            for d in ("spork", "round_robin")]


def _fleet_cells():
    return [FleetCell(tenants=dyadic_tenants(TenantSpec, seed=s, n=2 + s),
                      admission=a, fleet=QFLEET, horizon_s=60.0)
            for s in (0, 1) for a in ("admit_all", "token_bucket")]


def _accum_equal(a, b) -> None:
    for f, x, y in zip(Accum._fields, a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y)), f


def _totals_equal(a, b) -> None:
    for f in RunTotals.FLOAT_FIELDS + RunTotals.COUNT_FIELDS:
        assert getattr(a, f) == getattr(b, f), f
    assert a.breakdown == b.breakdown


# ------------------------------------------------------------- fingerprints
def test_chunk_fingerprint_stable_sensitive_and_device_typed():
    cells = _rate_cells()
    plan = plan_sweep(cells, device=CPU)
    d = plan.dispatches[0]
    fp = chunk_fingerprint(d, "local", "cpu")
    assert fp == chunk_fingerprint(d, "local", "cpu")
    assert fp != chunk_fingerprint(d, "mesh", "cpu")
    assert fp != chunk_fingerprint(d, "local", "cuda")
    assert fp != chunk_fingerprint(d, "local", "cpu", salt="other")
    bumped = np.array(cells[0].counts, copy=True)
    bumped[7] += 1
    plan2 = plan_sweep([SweepCell(cells[0].policy, bumped, 0.05,
                                  DEFAULT_FLEET)] + cells[1:], device=CPU)
    assert ({chunk_fingerprint(x, "local", "cpu") for x in plan.dispatches}
            != {chunk_fingerprint(x, "local", "cpu")
                for x in plan2.dispatches})
    assert plan_fingerprint(plan, "local", "cpu") \
        != plan_fingerprint(plan2, "local", "cpu")
    assert plan_fingerprint(plan, "local", "cpu") \
        == plan_fingerprint(plan, "local", "cpu")


def test_fingerprints_never_equal_the_references():
    """The same cells planned by both packages: the port's salt and device
    type keep every port key apart from every reference key, so a
    checkpoint directory shared by both never mixes their chunks."""
    counts = _counts()
    port = plan_sweep(_rate_cells(counts=counts), device=CPU)
    from repro.core.workers import DEFAULT_FLEET as REF_FLEET
    ref = ref_plan_sweep([RefCell(p, counts, 0.05, REF_FLEET)
                          for p in POLICIES])
    assert port.n_dispatches == ref.n_dispatches
    ref_keys = {ref_harness.chunk_fingerprint(d, b) for d in ref.dispatches
                for b in ("local", "mesh")}
    port_keys = {chunk_fingerprint(d, b, t) for d in port.dispatches
                 for b in ("local", "mesh") for t in ("cpu", "cuda")}
    assert len(port_keys) == 4 * port.n_dispatches
    assert not ref_keys & port_keys
    assert harness.CODE_SALT != ref_harness.CODE_SALT


# -------------------------------------------------------- checkpoint/resume
def test_rate_checkpoint_resume_bit_identical(tmp_path):
    cells = _rate_cells()
    r1 = sweep(cells, device=CPU, checkpoint_dir=tmp_path)
    assert r1.meta["checkpointed"] is True
    assert r1.meta["executed_chunks"] == r1.n_dispatches > 1
    assert r1.meta["restored_chunks"] == 0
    r2 = sweep(cells, device=CPU, checkpoint_dir=tmp_path)
    assert r2.meta["executed_chunks"] == 0
    assert r2.meta["restored_chunks"] == r1.n_dispatches
    _accum_equal(r1.accum, r2.accum)
    _accum_equal(r1.accum, sweep(cells, device=CPU).accum)
    bumped = np.array(cells[0].counts, copy=True)
    bumped[3] += 2
    r3 = sweep([SweepCell(c.policy, bumped, 0.05, DEFAULT_FLEET)
                for c in cells], device=CPU, checkpoint_dir=tmp_path)
    assert r3.meta["restored_chunks"] == 0
    assert r3.meta["executed_chunks"] == r3.n_dispatches


def test_restored_chunks_keep_every_dtype(tmp_path):
    """The store holds each leaf in its own dtype (float32 sums, int32
    counters, int64/float64 tenant rows) and a restored chunk comes back
    as CPU tensors of those dtypes."""
    sweep_fleet(_fleet_cells(), device=CPU, checkpoint_dir=tmp_path,
                **FLEET_KW)
    store = ChunkStore(tmp_path)
    (key,) = store.keys()
    leaves = store.load(key)
    acc, fail, over, fa = harness._reassemble_output("fleet", leaves)
    assert {x.dtype for x in acc} == {torch.float32}
    assert fail.retries.dtype == torch.int32
    assert fail.wasted_j.dtype == torch.float32
    assert fa.admitted.dtype == torch.int64
    assert fa.work_f.dtype == torch.float64
    again = harness._flatten_output("fleet", (acc, fail, over, fa))
    for a, b in zip(leaves, again):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_event_checkpoint_resume_bit_identical(tmp_path):
    cells = _event_cells()
    kw = dict(n_max=64, w_fpga=16, w_cpu=32, device=CPU)
    e1 = sweep_events(cells, checkpoint_dir=tmp_path, **kw)
    e2 = sweep_events(cells, checkpoint_dir=tmp_path, **kw)
    assert e1.meta["executed_chunks"] == e1.n_dispatches > 0
    assert e2.meta["restored_chunks"] == e1.n_dispatches
    assert e2.meta["executed_chunks"] == 0
    for ta, tb in zip(e1, e2):
        _totals_equal(ta, tb)


def test_fleet_checkpoint_resume_bit_identical(tmp_path):
    cells = _fleet_cells()
    f1 = sweep_fleet(cells, device=CPU, checkpoint_dir=tmp_path, **FLEET_KW)
    f2 = sweep_fleet(cells, device=CPU, checkpoint_dir=tmp_path, **FLEET_KW)
    assert f1.meta["executed_chunks"] == f1.n_dispatches > 0
    assert f2.meta["restored_chunks"] == f1.n_dispatches
    for i in range(len(cells)):
        _totals_equal(f1.totals(i), f2.totals(i))
        assert f1.tenants(i) == f2.tenants(i)


def test_tune_threads_checkpoint_dir(tmp_path):
    cells = _rate_cells(n_policies=1)
    out1 = tune_fpga_dynamic_cells(cells, max_k=2, device=CPU,
                                   checkpoint_dir=tmp_path)
    assert len(ChunkStore(tmp_path).keys()) > 0
    out2 = tune_fpga_dynamic_cells(cells, max_k=2, device=CPU,
                                   checkpoint_dir=tmp_path)
    assert [(h, t.energy_j) for h, t in out1] \
        == [(h, t.energy_j) for h, t in out2]


# ------------------------------------------------- SIGKILL mid-sweep resume
_CHILD = textwrap.dedent("""
    import hashlib, json, sys
    sys.path.insert(0, "src")
    import numpy as np
    from repro_torch.core.traces import synthetic_trace
    from repro_torch.core.workers import DEFAULT_FLEET
    from repro_torch.sim.harness import chunk_fingerprint
    from repro_torch.sim.plan import plan_sweep
    from repro_torch.sim.sweep import SweepCell, sweep

    tr = synthetic_trace(seed=0, horizon_s=400, request_size_s=0.05,
                         mean_demand_workers=20.0)
    cells = [SweepCell(p, tr.counts, 0.05, DEFAULT_FLEET)
             for p in ("spork", "cpu_dynamic", "fpga_static")]
    keys = [chunk_fingerprint(d, "local", "cpu")
            for d in plan_sweep(cells, device="cpu").dispatches]
    res = sweep(cells, device="cpu", checkpoint_dir=sys.argv[1])
    h = hashlib.sha256()
    for leaf in res.accum:
        h.update(np.ascontiguousarray(leaf).tobytes())
    print(json.dumps({"digest": h.hexdigest(), "keys": keys,
                      "n_dispatches": res.n_dispatches, **res.meta}))
""")


def _run_child(ckpt_dir, kill_after=None):
    env = dict(os.environ)
    env.pop(harness.ENV_KILL_AFTER, None)
    if kill_after is not None:
        env[harness.ENV_KILL_AFTER] = str(kill_after)
    return subprocess.run([sys.executable, "-c", _CHILD, str(ckpt_dir)],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=600)


def test_sigkill_mid_sweep_resume_bit_identical(tmp_path):
    """SIGKILL a sweep after its first chunk persisted; the resumed run
    re-executes only the unfinished chunks and its totals are
    bit-identical to an uninterrupted run. The fingerprints the child
    computes equal this process's."""
    ref = _run_child(tmp_path / "ref")
    assert ref.returncode == 0, ref.stderr[-3000:]
    ref_rec = json.loads(ref.stdout.strip().splitlines()[-1])
    n = ref_rec["n_dispatches"]
    assert n > 1
    plan = plan_sweep(_rate_cells(), device=CPU)
    assert ref_rec["keys"] == [chunk_fingerprint(d, "local", "cpu")
                               for d in plan.dispatches]
    killed = _run_child(tmp_path / "ckpt", kill_after=1)
    assert killed.returncode == -signal.SIGKILL, (killed.returncode,
                                                  killed.stderr[-3000:])
    assert len(ChunkStore(tmp_path / "ckpt").keys()) == 1
    resumed = _run_child(tmp_path / "ckpt")
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    rec = json.loads(resumed.stdout.strip().splitlines()[-1])
    assert rec["restored_chunks"] == 1, rec
    assert rec["executed_chunks"] == n - 1, rec
    assert rec["digest"] == ref_rec["digest"]


# --------------------------------------------------- retry and degradation
class _FlakyBackend(LocalBackend):
    """Fails the first ``n_failures`` run() calls, then runs for real."""

    def __init__(self, n_failures):
        super().__init__(CPU)
        self.n_failures = n_failures
        self.calls = 0

    def run(self, d):
        self.calls += 1
        if self.calls <= self.n_failures:
            raise RuntimeError(f"transient device loss #{self.calls}")
        return super().run(d)


class _DeadMesh(MeshBackend):
    """A mesh whose shards all fail."""

    def run(self, d):
        raise RuntimeError("device lost: shard raised")


class _SlowBackend(LocalBackend):
    def __init__(self):
        super().__init__(CPU)

    def run(self, d):
        time.sleep(30.0)


def test_retry_recovers_from_transient_failure():
    cells = _rate_cells(n_policies=1)
    flaky = _FlakyBackend(n_failures=2)
    res = execute(plan_sweep(cells, device=CPU), flaky,
                  retry=RetryPolicy(max_retries=2, backoff_s=0.0))
    assert res.meta["retried_dispatches"] == 2
    assert res.meta["degraded_chunks"] == []
    _accum_equal(res.accum, sweep(cells, device=CPU).accum)


def test_retry_exhaustion_raises_chunk_execution_error():
    flaky = _FlakyBackend(n_failures=10)
    with pytest.raises(ChunkExecutionError, match="after 2 attempts"):
        execute(plan_sweep(_rate_cells(n_policies=1), device=CPU), flaky,
                retry=RetryPolicy(max_retries=1, backoff_s=0.0))
    assert flaky.calls == 2      # 1 attempt + 1 retry, local: no degradation


def test_mesh_failure_degrades_to_local_on_the_first_mesh_device():
    cells = _rate_cells()
    plan = plan_sweep(cells, device=CPU)
    mesh = _DeadMesh([CPU, CPU])
    res = execute(plan, mesh, retry=RetryPolicy(max_retries=1, backoff_s=0.0))
    assert res.meta["degraded_chunks"] == list(range(plan.n_dispatches))
    assert res.meta["retried_dispatches"] == plan.n_dispatches
    assert res.meta["degraded_device"] == str(mesh.devices[0]) == "cpu"
    assert res.backend == "mesh" and res.dispatch_devices == \
        [2] * plan.n_dispatches
    _accum_equal(res.accum, sweep(cells, device=CPU).accum)


def test_degradation_opt_out_fails_the_sweep():
    with pytest.raises(ChunkExecutionError, match="mesh"):
        execute(plan_sweep(_rate_cells(n_policies=1), device=CPU),
                _DeadMesh([CPU, CPU]),
                retry=RetryPolicy(max_retries=0, backoff_s=0.0,
                                  degrade=False))


def test_call_with_timeout_raises_chunk_timeout():
    with pytest.raises(ChunkTimeout, match="wall timeout"):
        _call_with_timeout(lambda: time.sleep(30.0), 0.05, "chunk 0")
    assert _call_with_timeout(lambda: 42, 5.0, "chunk 0") == 42
    assert _call_with_timeout(lambda: 42, None, "chunk 0") == 42


def test_timeout_surfaces_through_retry_ladder():
    with pytest.raises(ChunkExecutionError, match="wall timeout"):
        execute(plan_sweep(_rate_cells(n_policies=1), device=CPU),
                _SlowBackend(),
                retry=RetryPolicy(max_retries=0, backoff_s=0.0,
                                  timeout_s=0.1, degrade=False))


def test_kernel_build_runs_before_the_timed_attempt():
    """With a timeout, the backend's `prepare` (the kernels' build) runs
    once per dispatch kind in the caller's thread, outside the attempts
    a timeout abandons (each runs in a thread of its own)."""
    class SlowBuild(LocalBackend):
        def __init__(self):
            super().__init__(CPU)
            self.prepared = []
            self.attempt_threads = set()

        def prepare(self, kind):
            self.prepared.append((kind, threading.current_thread()))

        def run(self, d):
            self.attempt_threads.add(threading.current_thread())
            return super().run(d)

    cells = _rate_cells()
    backend = SlowBuild()
    res = execute(plan_sweep(cells, device=CPU), backend,
                  retry=RetryPolicy(max_retries=0, timeout_s=600.0))
    assert backend.prepared == [("rate", threading.current_thread())]
    assert threading.current_thread() not in backend.attempt_threads
    assert len(backend.attempt_threads) == len(POLICIES)
    _accum_equal(res.accum, sweep(cells, device=CPU).accum)
    untimed = SlowBuild()
    execute(plan_sweep(cells, device=CPU), untimed)
    assert untimed.prepared == []                 # no timeout: no prepare
    assert untimed.attempt_threads == {threading.current_thread()}


# --------------------------------------------------------- invariant guards
def _totals(cls, **kw):
    t = cls()
    t.requests = 100
    t.work_cpu_s = 50.0
    t.work_on_fpga_cpu_s = 30.0
    t.work_on_cpu_cpu_s = 20.0
    t.energy_j = 1000.0
    t.fpga_busy_j = 400.0
    t.cpu_busy_j = 300.0
    for k, v in kw.items():
        setattr(t, k, v)
    return t


def test_check_totals_passes_clean_record():
    check_totals(_totals(RunTotals))


@pytest.mark.parametrize("field,value,invariant", [
    ("energy_j", float("nan"), "finite"),
    ("cost_usd", float("inf"), "finite"),
    ("energy_j", -1.0, "non_negative"),
    ("retries", -3, "non_negative"),
    ("deadline_misses", 101, "request_conservation"),
    ("work_on_cpu_cpu_s", 99.0, "request_conservation"),
    ("recovered_requests", 1, "resilience_reconciled"),
    ("retries", 1, "resilience_reconciled"),
    ("fpga_idle_j", 900.0, "energy_components"),
])
def test_check_totals_catches_violations_as_the_reference(field, value,
                                                           invariant):
    with pytest.raises(InvariantViolation) as e:
        check_totals(_totals(RunTotals, **{field: value}), where="unit")
    with pytest.raises(ref_harness.InvariantViolation) as r:
        ref_harness.check_totals(_totals(RefRunTotals, **{field: value}),
                                 where="unit")
    assert e.value.invariant == r.value.invariant == invariant
    assert e.value.where == r.value.where == "unit"


def test_check_totals_failure_misses_reconciled():
    t = _totals(RunTotals, deadline_misses=5)
    t.failure_misses = 6
    with pytest.raises(InvariantViolation) as e:
        check_totals(t)
    assert e.value.invariant == "resilience_reconciled"


def test_invariant_catalogue_and_tolerances_are_the_references():
    assert harness.INVARIANTS == ref_harness.INVARIANTS
    assert (harness._WORK_RTOL, harness._COMPONENT_RTOL) == \
        (ref_harness._WORK_RTOL, ref_harness._COMPONENT_RTOL)
    assert harness.ENV_SKIP_INVARIANTS == ref_harness.ENV_SKIP_INVARIANTS
    assert harness.ENV_KILL_AFTER == ref_harness.ENV_KILL_AFTER


class _NaNBackend(LocalBackend):
    """A structurally valid Accum poisoned with one NaN."""

    def __init__(self):
        super().__init__(CPU)

    def run(self, d):
        leaves = [torch.zeros(d.chunk) for _ in Accum._fields]
        leaves[0][0] = float("nan")        # fpga_busy_j of the first cell
        return Accum(*leaves)


def test_execute_guards_by_default(monkeypatch):
    monkeypatch.delenv(harness.ENV_SKIP_INVARIANTS, raising=False)
    plan = plan_sweep(_rate_cells(n_policies=1), device=CPU)
    with pytest.raises(InvariantViolation) as e:
        execute(plan, _NaNBackend())
    assert e.value.invariant == "finite"
    monkeypatch.setenv(harness.ENV_SKIP_INVARIANTS, "1")
    assert np.isnan(execute(plan, _NaNBackend()).accum.fpga_busy_j).any()
    monkeypatch.delenv(harness.ENV_SKIP_INVARIANTS)
    res = execute(plan, _NaNBackend(), validate=False)
    assert np.isnan(res.accum.fpga_busy_j).any()


def test_real_sweeps_pass_guards_and_poisoned_results_fail():
    res = sweep(_rate_cells(), device=CPU)
    check_sweep_result(res)
    res.accum.missed_requests[0] = float(res._requests[0]) + 1
    with pytest.raises(InvariantViolation) as e:
        check_sweep_result(res)
    assert e.value.invariant == "request_conservation"

    ev = sweep_events(_event_cells(), n_max=64, w_fpga=16, w_cpu=32,
                      device=CPU)
    check_sweep_result(ev)
    ev[1].energy_j = float("nan")
    with pytest.raises(InvariantViolation) as e:
        check_sweep_result(ev)
    assert (e.value.invariant, e.value.where) == ("finite", "cell 1")

    fl = sweep_fleet(_fleet_cells(), device=CPU, **FLEET_KW)
    check_sweep_result(fl)
    row = fl.tenants(2)[0]
    fl.tenants(2)[0] = dataclasses.replace(row, admitted=row.admitted + 1,
                                           requests=row.requests + 1)
    with pytest.raises(InvariantViolation) as e:
        check_sweep_result(fl)
    assert (e.value.invariant, e.value.where) == ("tenant_conservation",
                                                  "cell 2")


def test_check_drift_bounds_as_the_reference():
    pairs = [(_totals(RunTotals), _totals(RefRunTotals), None),
             (_totals(RunTotals, energy_j=1200.0),
              _totals(RefRunTotals, energy_j=1200.0), "drift"),
             (_totals(RunTotals, requests=101),
              _totals(RefRunTotals, requests=101), "drift")]
    for port_b, ref_b, want in pairs:
        got = []
        for fn, a, b, exc in (
                (check_drift, _totals(RunTotals), port_b,
                 InvariantViolation),
                (ref_harness.check_drift, _totals(RefRunTotals), ref_b,
                 ref_harness.InvariantViolation)):
            try:
                fn(a, b)
                got.append(None)
            except exc as e:
                got.append(e.invariant)
        assert got == [want, want]
    with pytest.raises(InvariantViolation, match="requests"):
        check_drift(_totals(RunTotals), _totals(RunTotals, requests=101))
