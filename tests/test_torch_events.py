"""Port serial DES oracle (`repro_torch.sim.events`) vs the reference.

The port's `EventSim` reproduces the ``oracle`` section of every pinned
event golden, and equals the reference's `simulate_events` on the bursty
quantized traces for every dispatcher, with and without failures:
counters exactly, energies and costs within 1e-5 (both accumulate in
float64; the per-tick `predict` runs in float32 on each side).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.breakeven import objective_setup as ref_objective_setup
from repro.core.predictor import Predictor as RefPredictor
from repro.sim.events import simulate_events as ref_simulate_events
from repro_torch.core.breakeven import objective_setup
from repro_torch.core.predictor import Predictor
from repro_torch.core.workers import DEFAULT_FLEET
from repro_torch.ft.failures import FailureSpec
from repro_torch.policies import (dispatch_policies, dispatch_policy_names,
                                  get_dispatch_policy)
from repro_torch.sim.events import DISPATCHERS, simulate_events
from test_arrival_kernel import FAIL_SPEC
from test_events_batched import HORIZON, QFLEET as REF_QFLEET, bursty_trace
from test_policy_equivalence import (EVENT_KEYS, FSPEC, GOLDENS,
                                     assert_matches_golden, event_arrivals)

QFLEET = DEFAULT_FLEET.replace(cpu=DEFAULT_FLEET.cpu.replace(spin_up_s=1.0))
N_MAX = 64
FIELDS = ("requests", "deadline_misses", "fpga_spinups", "cpu_spinups",
          "retries", "failed_spinups", "crashes", "recovered_requests",
          "failure_misses")
FLOATS = ("energy_j", "cost_usd", "work_on_fpga_cpu_s", "work_on_cpu_cpu_s",
          "fpga_idle_j", "fpga_busy_j", "cpu_busy_j", "spinup_j",
          "wasted_spinup_j")


def port_spec(spec):
    return None if spec is None else FailureSpec(**dataclasses.asdict(spec))


@pytest.mark.parametrize("key", EVENT_KEYS)
def test_event_sim_matches_oracle_goldens(key):
    disp, _, fail_key = key.partition("@")
    tot = simulate_events(event_arrivals(), 1.0, QFLEET, dispatcher=disp,
                          horizon_s=float(HORIZON), n_max=N_MAX,
                          failures=port_spec(FSPEC if fail_key == "combined"
                                             else None),
                          device="cpu")
    assert_matches_golden(tot, GOLDENS["event"][key]["oracle"],
                          ("oracle", key))


@pytest.mark.parametrize("disp", DISPATCHERS)
@pytest.mark.parametrize("failures", [None, FAIL_SPEC],
                         ids=["pristine", "failures"])
def test_event_sim_matches_reference(disp, failures):
    arr = bursty_trace(1)
    a = ref_simulate_events(arr, 1.0, REF_QFLEET, dispatcher=disp,
                            horizon_s=HORIZON, n_max=N_MAX,
                            failures=failures)
    b = simulate_events(arr, 1.0, QFLEET, dispatcher=disp,
                        horizon_s=HORIZON, n_max=N_MAX,
                        failures=port_spec(failures), device="cpu")
    for f in FIELDS:
        assert getattr(a, f) == getattr(b, f), (f, getattr(a, f),
                                                getattr(b, f))
    for f in FLOATS:
        np.testing.assert_allclose(getattr(b, f), getattr(a, f), rtol=1e-5,
                                   atol=1e-3, err_msg=f)


def test_predictor_matches_reference():
    """The stateful predictor: same observations and lifetimes give the
    same targets, tick after tick."""
    from repro.core.workers import DEFAULT_FLEET as REF_FLEET
    rng = np.random.default_rng(4)
    _, rc = ref_objective_setup(REF_FLEET, 0.5)
    _, pc = objective_setup(DEFAULT_FLEET, 0.5)
    r = RefPredictor(32, rc, REF_FLEET.T_s)
    p = Predictor(32, pc, DEFAULT_FLEET.T_s, device="cpu")
    for step in range(40):
        a, b = (int(x) for x in rng.integers(0, 40, 2))
        r.observe(a, b)
        p.observe(a, b)
        if step % 3 == 0:
            lvl, life = int(rng.integers(0, 40)), float(rng.uniform(0, 90))
            r.record_lifetime(lvl, life)
            p.record_lifetime(lvl, life)
        n_prev, n_curr = (int(x) for x in rng.integers(0, 40, 2))
        assert p.predict(n_prev, n_curr) == r.predict(n_prev, n_curr), step
    np.testing.assert_array_equal(p.H, r.H)


def test_dispatch_registry_matches_reference():
    from repro.policies import dispatch_policies as ref_policies
    assert [(p.name, p.code) for p in dispatch_policies()] == \
        [(p.name, p.code) for p in ref_policies()]
    assert dispatch_policy_names() == DISPATCHERS
    with pytest.raises(ValueError, match="unknown policy"):
        get_dispatch_policy("nope")


def test_dispatch_select_matches_each_policy_combine():
    """The per-cell fold agrees with each policy's own rule at every code,
    with a different code per cell."""
    from repro_torch.policies import Candidates, dispatch_select
    rng = np.random.default_rng(7)
    C, W = 6, 12

    def b(*s):
        return torch.from_numpy(rng.integers(0, 2, s).astype(bool))

    cand = Candidates(f_found=b(C), c_found=b(C),
                      av_f=torch.from_numpy(rng.uniform(0, 5, C)),
                      av_c=torch.from_numpy(rng.uniform(0, 5, C)),
                      oh_f=b(C, W), oh_c=b(C, W), rr_found=b(C),
                      oh_rr=b(C, W))
    code = torch.tensor([0, 1, 2, 2, 1, 0], dtype=torch.int32)
    got_f, got_oh = dispatch_select(code, cand)
    for p in dispatch_policies():
        want_f, want_oh = p.combine(cand)
        rows = code == p.code
        assert torch.equal(got_f[rows], want_f[rows]), p.name
        assert torch.equal(got_oh[rows], want_oh[rows]), p.name
