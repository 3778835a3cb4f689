"""Port sweep stack (plan / execute / sweep) vs the reference.

The plan/execute path reproduces every pinned rate golden on the CPU,
plans lay out the same arrays as the reference planner, and the plan
invariants hold: scatter indices are a permutation of the cells, pads
repeat row 0, chunks come from {CHUNK, CHUNK_BIG}.
"""

import numpy as np
import pytest
import torch

from repro.core.traces import synthetic_trace
from repro.core.workers import DEFAULT_FLEET as REF_FLEET
from repro.sim.plan import plan_sweep as ref_plan_sweep
from repro.sim.sweep import SweepCell as RefCell
from repro.sim.sweep import tune_fpga_dynamic_cells as ref_tune_cells
from repro_torch.core.workers import DEFAULT_FLEET
from repro_torch.policies import rate_policy_names
from repro_torch.sim import ratesim
from repro_torch.sim.exec import LocalBackend, execute, get_backend
from repro_torch.sim.plan import CHUNK, CHUNK_BIG, plan_sweep
from repro_torch.sim.sweep import SweepCell, sweep, tune_fpga_dynamic_cells
from test_torch_policies import (N_MAX, RATE_KEYS, assert_matches_golden,
                                 golden_trace, rate_golden, rate_kwargs)


def _traces(n=3, horizon=600):
    return [synthetic_trace(seed=s, horizon_s=horizon, request_size_s=0.05,
                            mean_demand_workers=20.0) for s in range(n)]


def _grid(cell_cls, fleet):
    """A mixed grid: two fleets (spin-up 10 s and 60 s) x traces x
    policies, as tests/test_plan.py draws it for the reference."""
    slow = fleet.replace(fpga=fleet.fpga.replace(spin_up_s=60.0))
    return [cell_cls(policy, tr.counts, 0.05, f, energy_weight=ew,
                     headroom=hr)
            for tr in _traces()
            for f in (fleet, slow)
            for policy, ew, hr in (("spork", 0.5, 0), ("cpu_dynamic", 1.0, 0),
                                   ("fpga_static", 1.0, 0),
                                   ("mark_ideal", 1.0, 0),
                                   ("predictive", 1.0, 1))]


def test_sweep_matches_goldens():
    tr = golden_trace()
    cells = [SweepCell(counts=tr.counts, size_s=tr.request_size_s,
                       fleet=DEFAULT_FLEET, **rate_kwargs(k))
             for k in RATE_KEYS]
    res = sweep(cells, n_max=N_MAX, device="cpu")
    assert res.backend == "local" and res.device == "cpu"
    for i, key in enumerate(RATE_KEYS):
        assert_matches_golden(res.totals(i), rate_golden(key),
                              ("sweep", key))


def test_plan_matches_reference_plan():
    """Same groups, chunk shapes, scatter indices and padded arrays as
    the reference planner (the reference orders array keys the same)."""
    port = plan_sweep(_grid(SweepCell, DEFAULT_FLEET), n_max=N_MAX)
    ref = ref_plan_sweep(_grid(RefCell, REF_FLEET), n_max=N_MAX)
    assert port.n_dispatches == ref.n_dispatches
    np.testing.assert_array_equal(port.work, ref.work)
    np.testing.assert_array_equal(port.requests, ref.requests)
    for d, r in zip(port.dispatches, ref.dispatches):
        assert d.static[0].name == r.static[0].name
        assert d.static[1:] == r.static[1:]
        assert (d.cell_idx, d.chunk) == (r.cell_idx, r.chunk)
        assert d.arrays.keys() == r.arrays.keys()
        for k in d.arrays:
            np.testing.assert_array_equal(d.arrays[k], r.arrays[k], err_msg=k)


def test_plan_invariants():
    tr = _traces(1)[0]
    cells = _grid(SweepCell, DEFAULT_FLEET) + [
        SweepCell("fpga_dynamic", tr.counts, 0.05, DEFAULT_FLEET, headroom=k)
        for k in range(CHUNK + 1)]
    plan = plan_sweep(cells)
    idx = [i for d in plan.dispatches for i in d.cell_idx]
    assert sorted(idx) == list(range(len(cells)))
    assert {d.chunk for d in plan.dispatches} == {CHUNK, CHUNK_BIG}
    for d in plan.dispatches:
        assert d.n_real <= d.chunk
        if d.static[0].uses_predictor:
            assert d.chunk == CHUNK
        for name, arr in d.arrays.items():
            assert isinstance(arr, np.ndarray)         # no device work
            assert arr.shape[0] == d.chunk, name
            for r in range(d.n_real, d.chunk):
                np.testing.assert_array_equal(arr[r], arr[0], err_msg=name)


def test_sweep_matches_per_call_simulate():
    cells = _grid(SweepCell, DEFAULT_FLEET)[:10]
    res = sweep(cells, n_max=N_MAX, backend=LocalBackend("cpu"))
    assert res.n_dispatches == plan_sweep(cells, n_max=N_MAX).n_dispatches
    for i, c in enumerate(cells):
        want = ratesim.simulate(c.policy, c.counts, c.size_s, c.fleet,
                                energy_weight=c.energy_weight,
                                headroom=c.headroom, n_max=N_MAX,
                                device="cpu")
        got = res.totals(i)
        for f in ("requests", "deadline_misses", "fpga_spinups",
                  "cpu_spinups", "energy_j", "cost_usd"):
            assert getattr(got, f) == getattr(want, f), (i, f)
    assert res.reports()[0].totals is not None


def test_tune_fpga_dynamic_cells_matches_reference():
    traces = _traces(2)
    got = tune_fpga_dynamic_cells(
        [SweepCell("fpga_dynamic", t.counts, 0.05, DEFAULT_FLEET)
         for t in traces], max_k=8, n_max=N_MAX, device="cpu")
    want = ref_tune_cells([RefCell("fpga_dynamic", t.counts, 0.05, REF_FLEET)
                           for t in traces], max_k=8, n_max=N_MAX)
    for (h, tot), (h_r, tot_r) in zip(got, want):
        assert h == h_r
        assert tot.deadline_misses == tot_r.deadline_misses == 0
        np.testing.assert_allclose(tot.energy_j, tot_r.energy_j, rtol=1e-5)
        np.testing.assert_allclose(tot.cost_usd, tot_r.cost_usd, rtol=1e-5)


def test_unported_cells_and_backends_are_rejected():
    tr = _traces(1)[0]
    # scenario cells are resolved now (tests/test_torch_workloads.py holds
    # them to the reference)
    from repro_torch.workloads import registry
    spec = registry.get("steady").with_(horizon_s=60)
    planned = plan_sweep([SweepCell("spork", scenario=spec)], device="cpu")
    assert len(planned.cells[0].counts) == 60
    # failure-bearing cells are no longer rejected: they run on the
    # degraded fleet (tests/test_torch_failures.py holds the numbers)
    from repro_torch.ft.failures import FailureSpec
    spec = FailureSpec(crash_p=0.1)
    planned = plan_sweep([SweepCell("spork", tr.counts, 0.05,
                                    failures=spec)]).cells[0]
    assert planned.failures is None
    assert planned.fleet == spec.degrade_fleet(DEFAULT_FLEET)
    with pytest.raises(ValueError, match="explicit counts"):
        plan_sweep([SweepCell("spork")])
    with pytest.raises(ValueError, match="unknown policy"):
        plan_sweep([SweepCell("nope", tr.counts, 0.05)])
    with pytest.raises(ValueError, match="unknown sweep backend"):
        get_backend("mesh", device="cpu")
    with pytest.raises(ValueError, match="must be 1-D"):
        SweepCell("spork", np.ones((2, 2)), 0.05)
    assert "spork" in rate_policy_names()


def test_entry_points_device_none_raise_without_cuda(monkeypatch):
    tr = _traces(1, horizon=60)[0]
    cells = [SweepCell("spork", tr.counts, 0.05, DEFAULT_FLEET)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep(cells)
    with pytest.raises(RuntimeError, match="CUDA"):
        tune_fpga_dynamic_cells(cells)
    with pytest.raises(RuntimeError, match="CUDA"):
        execute(plan_sweep(cells))
    with pytest.raises(RuntimeError, match="CUDA"):
        LocalBackend()
