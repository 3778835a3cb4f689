"""Hypothesis property tests on system-level invariants, on the port
(`repro_torch`) on the CPU: the four properties of
`tests/test_properties.py`, with its strategies and draw counts.

The traces come from the port's own numpy b-model (the reference's only
in distribution), so each property is held on the port's draws; the
bounds are the reference test's.
"""

import numpy as np

try:
    from hypothesis import given, settings, strategies as st
except ImportError:    # environment without hypothesis: local shim
    from _hypothesis_shim import given, settings, strategies as st

from repro_torch.core.dp import evaluate_path, solve_dp
from repro_torch.core.metrics import report
from repro_torch.core.traces import synthetic_trace
from repro_torch.core.workers import DEFAULT_FLEET
from repro_torch.sim import ratesim


@given(bias=st.floats(0.5, 0.75), seed=st.integers(0, 100),
       policy=st.sampled_from(["spork", "cpu_dynamic", "mark_ideal",
                               "spork_ideal"]))
@settings(max_examples=12, deadline=None)
def test_hybrid_platform_invariants(bias, seed, policy):
    """For any hybrid policy and any trace: (1) all demand is served,
    (2) no deadline misses (CPUs absorb bursts), (3) energy is bounded
    below by the idealized platform (efficiency <= 1), (4) cost is
    bounded below by the idealized occupancy cost."""
    tr = synthetic_trace(seed=seed, bias=bias, horizon_s=300,
                         request_size_s=0.05, mean_demand_workers=5.0)
    tot = ratesim.simulate(policy, tr.counts, tr.request_size_s,
                           DEFAULT_FLEET, device="cpu")
    served = tot.work_on_fpga_cpu_s + tot.work_on_cpu_cpu_s
    np.testing.assert_allclose(served, tot.work_cpu_s, rtol=1e-3)
    assert tot.deadline_misses == 0
    r = report(tot, DEFAULT_FLEET)
    assert r.energy_efficiency <= 1.0 + 1e-6
    assert r.relative_cost >= 1.0 - 1e-6


@given(seed=st.integers(0, 1000), levels=st.integers(1, 12))
@settings(max_examples=15, deadline=None)
def test_dp_optimum_dominates_arbitrary_paths(seed, levels):
    """The DP objective must lower-bound the exact evaluation of any
    feasible allocation path (optimality as a property)."""
    rng = np.random.default_rng(seed)
    W = rng.uniform(0, levels * DEFAULT_FLEET.T_s, size=12)
    opt = solve_dp(W, DEFAULT_FLEET, energy_weight=1.0, device="cpu")
    rand_path = rng.integers(0, levels + 1, size=12)
    ev = evaluate_path(W, rand_path, DEFAULT_FLEET)
    assert opt.objective <= ev.energy_j + 1e-3


@given(seed=st.integers(0, 100))
@settings(max_examples=8, deadline=None)
def test_more_efficient_fpga_never_hurts_optimum(seed):
    """Improving FPGA busy power can only reduce optimal energy."""
    rng = np.random.default_rng(seed)
    W = rng.uniform(0, 20 * DEFAULT_FLEET.T_s, size=10)
    base = solve_dp(W, DEFAULT_FLEET, energy_weight=1.0, device="cpu")
    better_fleet = DEFAULT_FLEET.replace(
        fpga=DEFAULT_FLEET.fpga.replace(busy_w=25.0))
    better = solve_dp(W, better_fleet, energy_weight=1.0, device="cpu")
    assert better.energy_j <= base.energy_j + 1e-6


@given(w1=st.floats(0.0, 1.0), w2=st.floats(0.0, 1.0))
@settings(max_examples=10, deadline=None)
def test_pareto_monotonicity(w1, w2):
    """Higher energy weight never increases energy and never decreases
    cost (pareto consistency of the weighted optimum)."""
    if w1 > w2:
        w1, w2 = w2, w1
    rng = np.random.default_rng(7)
    W = rng.uniform(0, 25 * DEFAULT_FLEET.T_s, size=16)
    lo = solve_dp(W, DEFAULT_FLEET, energy_weight=w1, device="cpu")
    hi = solve_dp(W, DEFAULT_FLEET, energy_weight=w2, device="cpu")
    assert hi.energy_j <= lo.energy_j + 1e-3
    assert hi.cost_usd >= lo.cost_usd - 1e-6
