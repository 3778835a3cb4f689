"""Port workload library (`repro_torch.workloads`, `sim.plan.
resolve_scenarios`) vs the reference `repro.workloads`.

Contracts:
  * `stats`, `ingest`, `zipf_weights` / `tenant_population` and the
    scenario registry are exactly the reference's: the same outputs on the
    same arrays, the same specs field by field, the data file a
    byte-identical copy;
  * the generators cannot reproduce `jax.random`, so they are held by
    distribution (tests/test_workloads.py's checks, by mean, bounds and
    levels) and every registry scenario's realized batch passes its own
    validator at the seeds the scenario suite's full mode uses, with the
    registry's ranges unchanged; the same seed gives the same batch;
  * scenario cells run through the port's engines on the REFERENCE's
    realized arrays (`realize` swapped for the reference's): a scenario
    cell equals the explicit cell built from the same arrays, and the
    port's `sweep` / `sweep_events` / `tune_fpga_dynamic_cells` equal the
    reference's on them, counters exactly and floats within 1e-5.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.core.workers import DEFAULT_FLEET as REF_FLEET
from repro.ft.failures import FailureSpec as RefFailureSpec
from repro.sim.events_batched import EventCell as RefEventCell
from repro.sim.sweep import SweepCell as RefCell
from repro.sim.sweep import resolve_scenarios as ref_resolve
from repro.sim.sweep import sweep as ref_sweep
from repro.sim.sweep import sweep_events as ref_sweep_events
from repro.sim.sweep import tune_fpga_dynamic_cells as ref_tune
from repro.workloads import ingest as ref_ingest
from repro.workloads import registry as ref_registry
from repro.workloads import scenarios as ref_scenarios
from repro.workloads import stats as ref_stats
from repro.workloads import tenants as ref_tenants
from repro_torch.core.bmodel import bmodel_series_torch
from repro_torch.core.metrics import RunTotals
from repro_torch.core.workers import DEFAULT_FLEET
from repro_torch.ft.failures import FailureSpec
from repro_torch.sim.events_batched import EventCell, simulate_events_batch
from repro_torch.sim.plan import plan_events
from repro_torch.sim.sweep import (SweepCell, resolve_scenarios, sweep,
                                   sweep_events, tune_fpga_dynamic_cells)
from repro_torch.workloads import (generators, ingest, registry, scenarios,
                                   stats, tenants)
from repro_torch.workloads.scenarios import (ScenarioBatch, ScenarioSpec,
                                             realize)

CPU = "cpu"
SUITE_SEEDS = tuple(range(10))     # the scenario suite's full mode
SUITE_HORIZON_S = 7200
CHAOS_SEEDS = tuple(range(6))      # the chaos suite's full mode
RTOL = 1e-5


def gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def ref_spec(spec: ScenarioSpec):
    """The reference's twin of a port spec (failures carried across)."""
    f = spec.failures
    return ref_scenarios.ScenarioSpec(
        **{**{k.name: getattr(spec, k.name)
              for k in dataclasses.fields(spec)},
           "failures": None if f is None
           else RefFailureSpec(**dataclasses.asdict(f))})


@pytest.fixture(autouse=True)
def _forget_reference_batches():
    """The reference's `realize` keeps each realized batch for the life of
    the process; one left from here would turn the reference's own
    cache-miss test (tests/test_workloads.py) into a hit whenever both
    files run in one process, so each test here empties it after."""
    yield
    ref_scenarios.realize.cache_clear()


@pytest.fixture
def reference_realize(monkeypatch):
    """The port's resolvers realize through the REFERENCE's `realize`:
    the engines are then held to the reference on identical arrays."""
    scenarios.clear_caches()

    def fake(spec, seeds, device=None):
        b = ref_scenarios.realize(ref_spec(spec), tuple(int(s) for s in seeds))
        return ScenarioBatch(b.rates, b.counts, b.sizes)

    monkeypatch.setattr(scenarios, "realize", fake)
    yield
    scenarios.clear_caches()


def assert_totals_match(got, want, tag):
    for f in RunTotals.COUNT_FIELDS:
        assert getattr(got, f) == getattr(want, f), (tag, f)
    for f in RunTotals.FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, atol=1e-6, err_msg=f"{tag} {f}")


# ------------------------------------------------------------------- stats

def _series(seed: int, n: int = 3000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.abs(rng.normal(50.0, 20.0, n)) * (1 + (np.arange(n) % 600 < 60))


@pytest.mark.parametrize("seed", [0, 1])
def test_stats_equal_reference(seed):
    x = _series(seed)
    for agg in (1, 10, 60):
        assert stats.bias_estimate(x, agg) == ref_stats.bias_estimate(x, agg)
        assert stats.trace_stats(x, agg) == ref_stats.trace_stats(x, agg)
    for lag in (1, 60):
        assert stats.autocorr(x, lag) == ref_stats.autocorr(x, lag)
    assert stats.peak_to_mean(x) == ref_stats.peak_to_mean(x)
    assert stats.cv(x) == ref_stats.cv(x)
    batch = np.stack([x, _series(seed + 5)])
    assert stats.batch_stats(batch) == ref_stats.batch_stats(batch)
    for name in registry.names():
        got = stats.validate(registry.get(name), batch)
        want = ref_stats.validate(ref_registry.get(name), batch)
        assert got == want, name


def test_basic_stats_on_constant_series():
    x = np.full((256,), 7.0)
    assert stats.bias_estimate(x) == pytest.approx(0.5)
    assert stats.peak_to_mean(x) == pytest.approx(1.0)
    assert stats.autocorr(x, 1) == pytest.approx(1.0)
    assert stats.cv(x) == pytest.approx(0.0)


def test_bias_estimate_recovers_bmodel_bias():
    """As tests/test_workloads.py, on the port's torch cascade."""
    for b in (0.5, 0.62, 0.72):
        ests = [stats.bias_estimate(
            bmodel_series_torch(gen(s), b, 10, 1000.0).numpy())
            for s in range(5)]
        assert abs(np.mean(ests) - b) < 0.03, (b, np.mean(ests))


# ------------------------------------------------------------------ ingest

def test_data_file_is_a_byte_identical_copy():
    port = os.path.join(scenarios._DATA_DIR, "sample_trace.csv")
    ref = os.path.join(ref_scenarios._DATA_DIR, "sample_trace.csv")
    assert os.path.abspath(port) != os.path.abspath(ref)
    with open(port, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("body,ext", [
    ("t,rate\n0,10\n10,20\n20,10\n", ".csv"),
    ("5\n6\n7\n", ".csv"),
    ("0,3\n4,1\n2,2\n", ".csv"),
    ("\n".join(json.dumps({"t": i * 2.0, "rate": 3.0 + i})
               for i in range(4)) + "\n", ".jsonl"),
])
def test_read_series_equals_reference(tmp_path, body, ext):
    p = tmp_path / f"t{ext}"
    p.write_text(body)
    np.testing.assert_array_equal(ingest.read_series(str(p)),
                                  ref_ingest.read_series(str(p)))


def test_replay_equals_reference():
    path = os.path.join(scenarios._DATA_DIR, "sample_trace.csv")
    series = ingest.read_series(path)
    for horizon, mean in ((7, None), (400, 10.0), (5000, 400.0)):
        np.testing.assert_array_equal(
            ingest.replay_rates(series, horizon, mean),
            ref_ingest.replay_rates(series, horizon, mean))
    got = ingest.replay_trace(path, request_size_s=0.05, horizon_s=400,
                              mean_demand_workers=20.0, seed=3)
    want = ref_ingest.replay_trace(path, request_size_s=0.05, horizon_s=400,
                                   mean_demand_workers=20.0, seed=3)
    np.testing.assert_array_equal(got.rates_per_s, want.rates_per_s)
    np.testing.assert_array_equal(got.counts, want.counts)
    with pytest.raises(ValueError, match="empty replay series"):
        ingest.replay_rates(np.array([]), 5)


# ----------------------------------------------------------------- registry

def _spec_fields(spec) -> dict:
    d = {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}
    d["failures"] = (None if spec.failures is None
                     else dataclasses.asdict(spec.failures))
    return d


def test_registry_equals_reference_field_by_field():
    assert registry.names() == ref_registry.names()
    assert registry.chaos_names() == ref_registry.chaos_names()
    assert len(registry.names()) == 8 and len(registry.chaos_names()) == 4
    for name in registry.names():
        assert _spec_fields(registry.get(name)) == \
            _spec_fields(ref_registry.get(name)), name
    for name in registry.chaos_names():
        assert _spec_fields(registry.get_chaos(name)) == \
            _spec_fields(ref_registry.get_chaos(name)), name
    with pytest.raises(KeyError, match="unknown scenario"):
        registry.get("nope")
    with pytest.raises(ValueError, match="already registered"):
        registry.register(registry.get("steady"))


def test_spec_validation():
    with pytest.raises(ValueError, match="unknown scenario kind"):
        ScenarioSpec(name="bad", kind="nope")
    for kw in ({"horizon_s": 0}, {"request_size_s": -1.0},
               {"mean_demand_workers": -2.0}):
        with pytest.raises(ValueError):
            ScenarioSpec(name="bad", kind="bmodel", **kw)
    spec = registry.get("steady")
    assert spec.with_(horizon_s=60).horizon_s == 60
    assert spec.p == dict(spec.params)


@pytest.mark.parametrize("n,a", [(1, 1.0), (16, 1.0), (64, 0.0), (100, 1.3)])
def test_zipf_weights_equal_reference(n, a):
    np.testing.assert_array_equal(tenants.zipf_weights(n, a),
                                  ref_tenants.zipf_weights(n, a))


def test_tenant_population_equals_reference():
    got = tenants.tenant_population(16, zipf_a=1.0, seed=3)
    want = ref_tenants.tenant_population(16, zipf_a=1.0, seed=3)
    assert len(got) == len(want) == 16
    for g, w in zip(got, want):
        assert _spec_fields(g.scenario) == _spec_fields(w.scenario)
        assert (g.slo, g.weight, g.seed, g.request_size_s, g.failures) == \
            (w.slo, w.weight, w.seed, w.request_size_s, w.failures)
    assert len({t.scenario for t in got}) <= 6
    with pytest.raises(ValueError, match="unknown SLO class"):
        tenants.tenant_population(4, slo_mix=("gold",))


# -------------------------------------------------------------- generators

def test_bmodel_rates_mean_and_determinism():
    r1 = generators.bmodel_rates(gen(0), 0.65, 1200, 500.0).numpy()
    r2 = generators.bmodel_rates(gen(0), 0.65, 1200, 500.0).numpy()
    np.testing.assert_array_equal(r1, r2)
    assert r1.shape == (1200,) and r1.dtype == np.float32
    assert np.all(r1 >= 0)
    means = [float(generators.bmodel_rates(gen(s), 0.65, 1200, 500.0).mean())
             for s in range(10)]
    np.testing.assert_allclose(np.mean(means), 500.0, rtol=0.15)
    flat = generators.bmodel_rates(gen(0), 0.5, 1200, 500.0).numpy()
    np.testing.assert_allclose(flat, 500.0, rtol=1e-4)


def test_mmpp_two_levels_and_stationary_mean():
    r = generators.mmpp_rates(gen(1), 20000, 100.0, burst_ratio=8.0,
                              p_enter=0.02, p_exit=0.2).numpy()
    assert len(np.unique(np.round(r, 3))) == 2          # base + burst only
    np.testing.assert_allclose(r.mean(), 100.0, rtol=0.15)
    assert r.max() / r.min() == pytest.approx(8.0, rel=1e-5)
    # the burst occupancy is the chain's stationary p_enter/(p_enter+p_exit)
    assert np.mean(r > r.min()) == pytest.approx(0.02 / 0.22, abs=0.03)


def test_diurnal_exact_mean_and_nonnegative():
    r = generators.diurnal_rates(gen(2), 2000, 50.0, period_s=2000.0).numpy()
    assert np.all(r >= 0)
    np.testing.assert_allclose(r.mean(), 50.0, rtol=1e-5)


def test_flash_crowd_overlay_shape():
    ov = generators.flash_crowd_overlay(gen(3), 2000, amp=6.0, ramp_s=20.0,
                                        decay_s=100.0,
                                        window=(0.3, 0.6)).numpy()
    assert ov.min() >= 1.0
    assert ov.max() == pytest.approx(6.0, rel=2e-2)
    onset = np.argmax(ov > 1.0 + 1e-6)
    assert 0.3 * 2000 - 25 <= onset <= 0.6 * 2000 + 1   # inside the window
    assert np.all(ov[:max(onset - 1, 0)] == 1.0)        # quiet before onset


def test_heavy_tail_size_samplers_bounded():
    pare = generators.pareto_sizes(gen(4), 2000, alpha=1.5, x_min_s=0.02,
                                   cap_s=5.0).numpy()
    logn = generators.lognormal_sizes(gen(5), 2000, lo_s=0.01,
                                      hi_s=10.0).numpy()
    assert pare.min() >= 0.02 and pare.max() <= 5.0
    assert pare.max() / np.median(pare) > 3.0           # actually heavy-tailed
    assert logn.min() >= 0.01 and logn.max() <= 10.0
    np.testing.assert_allclose(np.median(logn), 0.1, rtol=0.1)


def test_poisson_counts_deterministic_and_mean():
    rates = torch.full((5000,), 40.0)
    c1 = generators.poisson_counts(gen(6), rates).numpy()
    c2 = generators.poisson_counts(gen(6), rates).numpy()
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_allclose(c1.mean(), 40.0, rtol=0.05)
    assert generators.poisson_counts(gen(6), -rates).max() == 0


# --------------------------------------------------- realize + validators

@pytest.mark.parametrize("name", registry.names())
def test_every_scenario_validates_at_suite_seeds(name):
    spec = registry.get(name).with_(horizon_s=SUITE_HORIZON_S)
    batch = realize(spec, SUITE_SEEDS, device=CPU)
    assert batch.rates.shape == (10, SUITE_HORIZON_S)
    assert batch.counts.shape == (10, SUITE_HORIZON_S)
    assert batch.counts.min() >= 0 and np.all(batch.sizes > 0)
    ok, measured, failures = stats.validate(spec, batch.rates)
    assert ok, failures
    for s in range(10):
        vol = batch.rates[s].sum()
        assert abs(batch.counts[s].sum() - vol) < 6 * np.sqrt(vol) + 10
    # the registry's default (fast-mode) horizon validates too
    fast = realize(registry.get(name), SUITE_SEEDS[:4], device=CPU)
    assert stats.validate(registry.get(name), fast.rates)[0]


@pytest.mark.parametrize("name", registry.chaos_names())
def test_every_chaos_scenario_validates(name):
    spec = registry.get_chaos(name)
    ok, _, failures = stats.validate(
        spec, realize(spec, CHAOS_SEEDS, device=CPU).rates)
    assert ok, failures


def test_same_seed_same_batch_and_seed_independent_of_batch():
    spec = registry.get("heavy_tail_mix").with_(horizon_s=600)
    a = realize(spec, (0, 1, 2), device=CPU)
    scenarios.clear_caches()
    b = realize(spec, (0, 1, 2), device=CPU)
    assert a is not b
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    c = realize(spec, (2,), device=CPU)            # seed 2 alone
    for x, y in zip(a, c):
        np.testing.assert_array_equal(x[2], y[0])
    d = realize(spec, (3,), device=CPU)
    assert not np.array_equal(a.counts[0], d.counts[0])


def test_realize_caches_and_counts_dispatches():
    spec = registry.get("steady").with_(horizon_s=600)
    scenarios.clear_caches()
    before = scenarios.SYNTH_DISPATCHES
    b1 = realize(spec, (0, 1), device=CPU)
    mid = scenarios.SYNTH_DISPATCHES
    b2 = realize(spec, (0, 1), device=CPU)
    assert mid == before + 1                     # one synthesis per miss
    assert scenarios.SYNTH_DISPATCHES == mid     # cache hit
    assert b1 is b2


def test_validate_flags_out_of_range():
    spec = ScenarioSpec(name="impossible", kind="bmodel", horizon_s=600,
                        params=(("bias", 0.6),),
                        expect=(("peak_to_mean", 100.0, 200.0),))
    ok, measured, failures = stats.validate(
        spec, realize(spec, (0, 1), device=CPU).rates)
    assert not ok
    assert "peak_to_mean" in failures[0]
    assert measured["peak_to_mean"] < 100.0


def test_realize_on_the_card_needs_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: realize runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        realize(registry.get("steady").with_(horizon_s=60), (0,))


# ------------------------------------- scenario cells on reference arrays

def test_traces_from_batch_equal_reference_traces():
    spec = registry.get("bursty_short").with_(horizon_s=600)
    b = ref_scenarios.realize(ref_spec(spec), (0, 1))
    got = scenarios.traces_from_batch(spec, (0, 1),
                                      ScenarioBatch(b.rates, b.counts,
                                                    b.sizes))
    want = ref_scenarios.scenario_traces(ref_spec(spec), (0, 1))
    for g, w in zip(got, want):
        assert (g.name, g.request_size_s, g.meta) == \
            (w.name, w.request_size_s, w.meta)
        np.testing.assert_array_equal(g.rates_per_s, w.rates_per_s)
        np.testing.assert_array_equal(g.counts, w.counts)
        np.testing.assert_array_equal(g.arrival_times(3), w.arrival_times(3))


def test_scenario_cells_match_explicit_cells_and_reference(reference_realize):
    spec = registry.get("bursty_short").with_(horizon_s=600)
    traces = ref_scenarios.scenario_traces(ref_spec(spec), [0, 1])
    named = sweep([SweepCell(p, fleet=DEFAULT_FLEET, scenario=spec, seed=s)
                   for p in ("spork", "cpu_dynamic") for s in (0, 1)],
                  device=CPU)
    explicit = sweep([SweepCell(p, tr.counts, tr.request_size_s,
                                DEFAULT_FLEET)
                      for p in ("spork", "cpu_dynamic") for tr in traces],
                     device=CPU)
    ref = ref_sweep([RefCell(p, fleet=REF_FLEET, scenario=ref_spec(spec),
                             seed=s)
                     for p in ("spork", "cpu_dynamic") for s in (0, 1)])
    assert named.n_dispatches == ref.n_dispatches == 2
    assert all(c.counts is not None for c in named.cells)
    for i in range(4):
        g = named.totals(i)
        assert_totals_match(g, explicit.totals(i), ("explicit", i))
        assert_totals_match(g, ref.totals(i), ("reference", i))


def test_scenario_grid_one_dispatch_per_policy_group(reference_realize):
    specs = [registry.get(n).with_(horizon_s=600)
             for n in ("steady", "csv_replay")]
    cells = [SweepCell(policy, fleet=DEFAULT_FLEET, scenario=spec, seed=s)
             for policy in ("spork", "fpga_static")
             for spec in specs for s in range(2)]
    before = scenarios.SYNTH_DISPATCHES
    res = sweep(cells, device=CPU)
    assert len(res) == 8 and res.n_dispatches == 2
    ref = ref_sweep([RefCell(c.policy, fleet=REF_FLEET,
                             scenario=ref_spec(c.scenario), seed=c.seed)
                     for c in cells])
    for i in range(8):
        assert_totals_match(res.totals(i), ref.totals(i), i)
    assert scenarios.SYNTH_DISPATCHES == before   # realize is the reference's


def test_cell_without_demand_or_scenario_rejected():
    with pytest.raises(ValueError, match="explicit demand or a scenario"):
        sweep([SweepCell("spork", fleet=DEFAULT_FLEET)], device=CPU)


def test_tune_fpga_dynamic_accepts_scenario_cells(reference_realize):
    spec = registry.get("steady").with_(horizon_s=600)
    (h, tot), = tune_fpga_dynamic_cells(
        [SweepCell("fpga_dynamic", fleet=DEFAULT_FLEET, scenario=spec,
                   seed=0)], max_k=8, device=CPU)
    (h_r, tot_r), = ref_tune(
        [RefCell("fpga_dynamic", fleet=REF_FLEET, scenario=ref_spec(spec),
                 seed=0)], max_k=8)
    assert h == h_r
    assert tot.deadline_misses == tot_r.deadline_misses == 0
    assert tot.requests == tot_r.requests > 0
    np.testing.assert_allclose(tot.energy_j, tot_r.energy_j, rtol=RTOL)


def test_event_cell_without_demand_fails_fast_in_engine():
    spec = registry.get("steady").with_(horizon_s=120)
    with pytest.raises(ValueError, match="sweep_events"):
        simulate_events_batch([EventCell("spork", fleet=DEFAULT_FLEET,
                                         scenario=spec, seed=0)],
                              device=CPU)


def test_event_cell_scenario_resolution(reference_realize):
    spec = registry.get("steady").with_(horizon_s=120,
                                        mean_demand_workers=5.0)
    cell, = resolve_scenarios([EventCell("spork", fleet=DEFAULT_FLEET,
                                         scenario=spec, seed=1)], CPU)
    want, = ref_resolve([RefEventCell("spork", fleet=REF_FLEET,
                                      scenario=ref_spec(spec), seed=1)])
    assert cell.size_s == want.size_s
    assert cell.horizon_s == want.horizon_s == 120.0
    np.testing.assert_array_equal(cell.arrival_times, want.arrival_times)
    assert not cell.arrival_times.flags.writeable
    again, = resolve_scenarios([EventCell("spork", scenario=spec, seed=1)],
                               CPU)
    assert again.arrival_times is cell.arrival_times     # cached stream


def test_chaos_cells_inherit_failures_unless_pinned(reference_realize):
    spec = registry.get_chaos("crash_storm")
    pinned = FailureSpec(crash_p=0.01, seed=3)
    a, b = resolve_scenarios([EventCell("spork", scenario=spec, seed=0),
                              EventCell("spork", scenario=spec, seed=0,
                                        failures=pinned)], CPU)
    assert a.failures == spec.failures and b.failures == pinned
    r, = resolve_scenarios([SweepCell("spork", scenario=spec, seed=0)], CPU)
    assert r.failures == spec.failures


@pytest.mark.parametrize("name", ["crash_storm", "flaky_fpga"])
def test_scenario_event_sweep_matches_reference(reference_realize, name):
    """Chaos scenarios (cut to 60 s) through sweep_events: baseline,
    scaled and full intensity, each equal to the reference's on the same
    realized streams."""
    spec = registry.get_chaos(name).with_(horizon_s=60)
    kw = dict(n_max=64, w_fpga=16, w_cpu=32)
    cells, ref_cells = [], []
    for disp in ("spork", "round_robin"):
        for inten in (None, 0.0, 1.0):
            f = None if inten is None else spec.failures.scaled(inten)
            sc = spec.with_(failures=None) if inten is None else spec
            cells.append(EventCell(disp, fleet=DEFAULT_FLEET, scenario=sc,
                                   seed=1, failures=f))
            ref_cells.append(RefEventCell(
                disp, fleet=REF_FLEET, scenario=ref_spec(sc), seed=1,
                failures=(None if f is None
                          else RefFailureSpec(**dataclasses.asdict(f)))))
    got = sweep_events(cells, device=CPU, **kw)
    want = ref_sweep_events(ref_cells, **kw)
    assert got.n_dispatches == want.n_dispatches
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.breakdown["slot_overflow"] == 0
        assert_totals_match(g, w, (name, i))
    # intensity 0 takes the failure-free path bit for bit
    for base, zero in ((0, 1), (3, 4)):
        for f in RunTotals.COUNT_FIELDS + RunTotals.FLOAT_FIELDS:
            assert getattr(got[base], f) == getattr(got[zero], f), f


def test_plan_events_resolves_on_the_given_device(reference_realize):
    spec = registry.get("steady").with_(horizon_s=120,
                                        mean_demand_workers=5.0)
    plan = plan_events([EventCell("spork", scenario=spec, seed=2)],
                       n_max=64, device=CPU)
    assert plan.cells[0].arrival_times is not None
    assert plan.n_dispatches == 1
