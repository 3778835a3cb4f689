"""Port MILP (`repro_torch.core.milp`) vs the reference's, and the port's
DP vs the port's MILP, mirroring tests/test_milp.py.

Both MILPs hand the same model to scipy's HiGHS, so their objectives
agree to rtol 1e-6; the DP equals the MILP optimum to rtol 1e-5 (the
reference test's tolerance) at T_s = A_f. Fleets are carried across with
`repro_torch.interop.fleet_params`; the DP runs on the CPU.
"""

import numpy as np
import pytest

from repro.core.milp import solve_milp as ref_solve_milp
from repro.core.workers import DEFAULT_FLEET
from repro_torch import interop
from repro_torch.core.dp import evaluate_path, solve_dp
from repro_torch.core.milp import solve_milp

REF_FLEET = DEFAULT_FLEET.replace(max_cpus=10_000, max_fpgas=64)
FLEET = interop.fleet_params(REF_FLEET)


def _work(seed, T, scale):
    return np.random.default_rng(seed).uniform(0, scale * FLEET.T_s, size=T)


def test_fleet_params_copies_every_field():
    assert FLEET.max_cpus == 10_000 and FLEET.max_fpgas == 64
    for name in ("T_s", "S", "fpga_idle_timeout_s", "cpu_idle_timeout_s"):
        assert getattr(FLEET, name) == getattr(REF_FLEET, name)
    for w in ("cpu", "fpga"):
        for name in ("spin_up_s", "spin_down_s", "speedup", "busy_w",
                     "idle_w", "cost_per_hr", "spin_up_energy_j",
                     "spin_down_energy_j", "cost_per_s"):
            assert (getattr(getattr(FLEET, w), name)
                    == getattr(getattr(REF_FLEET, w), name))


@pytest.mark.parametrize("ew,kw", [(1.0, {}), (0.0, {}), (0.5, {}),
                                   (1.0, dict(allow_fpga=False)),
                                   (1.0, dict(allow_cpu=False))])
def test_milp_matches_reference(ew, kw):
    W = _work(0, 16, 30)
    want = ref_solve_milp(W, REF_FLEET, energy_weight=ew, time_limit_s=60, **kw)
    got = solve_milp(W, FLEET, energy_weight=ew, time_limit_s=60, **kw)
    np.testing.assert_allclose(got.objective, want.objective, rtol=1e-6)
    np.testing.assert_allclose(got.energy_j, want.energy_j, rtol=1e-6)
    np.testing.assert_allclose(got.cost_usd, want.cost_usd, rtol=1e-6)


@pytest.mark.parametrize("ew", [1.0, 0.0, 0.5, 0.9])
def test_dp_matches_milp_hybrid(ew):
    W = _work(0, 16, 30)
    m = solve_milp(W, FLEET, energy_weight=ew, time_limit_s=60)
    d = solve_dp(W, FLEET, energy_weight=ew, device="cpu")
    np.testing.assert_allclose(d.objective, m.objective, rtol=1e-5)


@pytest.mark.parametrize("kw", [dict(allow_fpga=False), dict(allow_cpu=False)])
def test_dp_matches_milp_homogeneous(kw):
    W = _work(1, 16, 20)
    m = solve_milp(W, FLEET, energy_weight=1.0, **kw)
    d = solve_dp(W, FLEET, energy_weight=1.0, device="cpu", **kw)
    np.testing.assert_allclose(d.objective, m.objective, rtol=1e-5)


@pytest.mark.parametrize("transition", ["dense", "kernel"])
def test_dp_transitions_match_milp(transition):
    W = _work(0, 16, 30)
    m = solve_milp(W, FLEET, energy_weight=0.5, time_limit_s=60)
    d = solve_dp(W, FLEET, energy_weight=0.5, transition=transition,
                 device="cpu")
    np.testing.assert_allclose(d.objective, m.objective, rtol=1e-5)


def test_dp_objective_equals_path_evaluation():
    W = _work(2, 24, 25)
    d = solve_dp(W, FLEET, energy_weight=1.0, device="cpu")
    ev = evaluate_path(W, d.y_fpga, FLEET)
    np.testing.assert_allclose(ev.energy_j, d.objective, rtol=1e-5)


def test_hybrid_dominates_homogeneous():
    W = _work(3, 24, 25)
    for ew in (1.0, 0.0):
        hy = solve_dp(W, FLEET, energy_weight=ew, device="cpu")
        cpu = solve_dp(W, FLEET, energy_weight=ew, allow_fpga=False,
                       device="cpu")
        fpga = solve_dp(W, FLEET, energy_weight=ew, allow_cpu=False,
                        device="cpu")
        assert hy.objective <= cpu.objective + 1e-6
        assert hy.objective <= fpga.objective + 1e-6


def test_min_duration_constraint_binds():
    fleet_fine = FLEET.replace(interval_s=5.0)   # spin-up 10s -> S_int=2
    y = solve_milp(_work(4, 16, 10), fleet_fine, energy_weight=1.0,
                   time_limit_s=60).y_fpga
    u = np.maximum(np.diff(np.concatenate([[0], y])), 0)
    for t in range(len(y)):
        assert y[t] + 1e-6 >= u[max(0, t - 1):t + 1].sum()


def test_pareto_tradeoff_direction():
    W = _work(5, 32, 30)
    e = solve_dp(W, FLEET, energy_weight=1.0, device="cpu")
    c = solve_dp(W, FLEET, energy_weight=0.0, device="cpu")
    assert e.energy_j <= c.energy_j + 1e-6
    assert e.cost_usd >= c.cost_usd - 1e-9
