"""Port rate policies vs the reference: registry contracts and the
pinned goldens through `repro_torch.sim.ratesim.simulate` on the CPU.

tests/goldens/policy_goldens.json pins the reference's `RunTotals` for
every rate policy on one synthetic trace. The port is held to the same
rows: counters exact, energies to 1e-5 relative (atol 1e-3), exactly as
tests/test_policy_equivalence.py holds the reference. The helpers below
are shared with tests/test_torch_sweep.py.
"""

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.core.traces import synthetic_trace
from repro.policies import rate as ref_rate
from repro.policies import rate_policy_names as ref_rate_policy_names
from repro_torch.core.workers import DEFAULT_FLEET
from repro_torch.policies import (RatePolicy, get_rate_policy,
                                  rate_policies, rate_policy_names,
                                  register_rate)
from repro_torch.policies import rate as port_rate
from repro_torch.policies.base import RATE_REGISTRY
from repro_torch.policies.rate import FpgaDynamic
from repro_torch.sim import ratesim

GOLDENS = json.loads(
    (Path(__file__).parent / "goldens" / "policy_goldens.json").read_text())
N_MAX = 64
RATE_KEYS = sorted(GOLDENS["rate"]) + sorted(GOLDENS["rate_plugin"])
COUNTERS = ("requests", "deadline_misses", "fpga_spinups", "cpu_spinups",
            "retries", "failed_spinups", "crashes", "recovered_requests",
            "failure_misses")
ENERGIES = ("energy_j", "cost_usd", "work_on_fpga_cpu_s",
            "work_on_cpu_cpu_s", "fpga_idle_j", "fpga_busy_j", "cpu_busy_j",
            "spinup_j", "wasted_spinup_j")


def golden_trace():
    """The reference's golden rate trace (counts drawn by `jax.random`).

    The goldens were pinned under jax < 0.5, whose threefry generator was
    not partitionable; newer jax flipped that default and draws other
    bits, so the trace is drawn in the pinned mode."""
    with jax.threefry_partitionable(False):
        return synthetic_trace(seed=3, bias=0.65, horizon_s=600,
                               request_size_s=0.05, mean_demand_workers=10.0)


def rate_golden(key: str) -> dict:
    return GOLDENS["rate"].get(key) or GOLDENS["rate_plugin"][key]


def rate_kwargs(key: str) -> dict:
    """Decode a golden key ('fpga_dynamic@h2', 'predictive@h2_g0.5',
    'spork@w0.5') into simulate()/SweepCell kwargs."""
    policy, _, mods = key.partition("@")
    kw = dict(policy=policy)
    for mod in mods.split("_") if mods else ():
        if mod.startswith("h"):
            kw["headroom"] = int(mod[1:])
        elif mod.startswith("w"):
            kw["energy_weight"] = float(mod[1:])
        elif mod.startswith("g"):
            kw["forecast_gain"] = float(mod[1:])
    return kw


def assert_matches_golden(tot, row: dict, tag) -> None:
    for f in COUNTERS:
        assert getattr(tot, f) == row[f], (tag, f, getattr(tot, f), row[f])
    for f in ENERGIES:
        np.testing.assert_allclose(getattr(tot, f), row[f], rtol=1e-5,
                                   atol=1e-3, err_msg=f"{tag} {f}")


@pytest.fixture(scope="module")
def trace():
    return golden_trace()


@pytest.mark.parametrize("key", RATE_KEYS)
def test_rate_policy_matches_golden(trace, key):
    tot = ratesim.simulate(counts=trace.counts, size_s=trace.request_size_s,
                           fleet=DEFAULT_FLEET, n_max=N_MAX, device="cpu",
                           **rate_kwargs(key))
    assert_matches_golden(tot, rate_golden(key), ("simulate", key))


def test_registry_mirrors_reference():
    """The seven built-in policies, registered in the reference's order
    (tests may register more on either side afterwards)."""
    builtins = ("SPORK", "SPORK_IDEAL", "CPU_DYNAMIC", "FPGA_STATIC",
                "FPGA_DYNAMIC", "MARK_IDEAL", "PREDICTIVE")
    want = tuple(getattr(ref_rate, b).name for b in builtins)
    assert tuple(getattr(port_rate, b).name for b in builtins) == want
    assert ref_rate_policy_names()[:len(want)] == want
    names = rate_policy_names()
    assert names[:len(want)] == want
    assert {k.partition("@")[0] for k in RATE_KEYS} <= set(names)
    assert set(p.name for p in rate_policies()) == set(names)


def test_registry_resolution_and_errors():
    p = get_rate_policy("spork")
    assert get_rate_policy(p) is p
    with pytest.raises(ValueError, match="unknown policy"):
        get_rate_policy("nope")
    with pytest.raises(ValueError, match="duplicate"):
        register_rate(get_rate_policy("spork"))
    with pytest.raises(TypeError):
        RATE_REGISTRY.register(object())


def test_base_policy_contract_surface():
    base = RatePolicy()
    with pytest.raises(NotImplementedError):
        base.allocator_tick(None, None, None, None)
    assert hash(get_rate_policy("spork")) != hash(get_rate_policy("spork_ideal"))
    with pytest.raises(dataclasses.FrozenInstanceError):
        base.name = "mutated"
    assert get_rate_policy("spork").uses_predictor
    assert not get_rate_policy("spork_ideal").uses_predictor
    assert get_rate_policy("cpu_dynamic").latency_free


def test_predictive_gain_zero_reduces_to_fpga_dynamic(trace):
    a = ratesim.simulate("predictive", trace.counts, trace.request_size_s,
                         DEFAULT_FLEET, headroom=2, n_max=N_MAX,
                         forecast_gain=0.0, device="cpu")
    b = ratesim.simulate("fpga_dynamic", trace.counts, trace.request_size_s,
                         DEFAULT_FLEET, headroom=2, n_max=N_MAX, device="cpu")
    for f in COUNTERS + ENERGIES:
        assert getattr(a, f) == getattr(b, f), f


def test_user_registered_policy_flows_through_simulate(trace):
    """Subclass + register: the simulator takes the new name with no
    edits, and a renamed fpga_dynamic twin reproduces its golden."""

    @dataclass(frozen=True)
    class Twin(FpgaDynamic):
        name: str = "test_twin"

    if "test_twin" not in rate_policy_names():
        register_rate(Twin())
    tot = ratesim.simulate("test_twin", trace.counts, trace.request_size_s,
                           DEFAULT_FLEET, headroom=2, n_max=N_MAX,
                           device="cpu")
    assert_matches_golden(tot, GOLDENS["rate"]["fpga_dynamic@h2"],
                          ("plugin-twin",))

