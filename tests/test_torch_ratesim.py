"""Port rate simulator vs the reference.

Per-step checks start both packages from the same random mid-run state
(carried across by `repro_torch.interop`): one simulated second
(`_second_step`) for every policy family and one Spork allocator tick.
Whole-run checks compare `simulate_batch` and `tune_fpga_dynamic` with
the reference's on shared traces. Counters exact; float32 accumulators
to 1e-6 relative per step and 2e-4 over a 600 s run (the reference's
own batched-vs-per-call tolerance, tests/test_sweep.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.traces import synthetic_trace
from repro.core.workers import DEFAULT_FLEET as REF_FLEET
from repro.policies import RateCtx as RefCtx
from repro.policies import RateParams as RefParams
from repro.policies import get_rate_policy as ref_policy
from repro.sim import ratesim as rr
from repro_torch import interop
from repro_torch.core.workers import DEFAULT_FLEET
from repro_torch.policies import RateCtx, get_rate_policy
from repro_torch.sim import ratesim as pr
from test_torch_predictor import _random_state

N_MAX = 64
RTOL_RUN = 2e-4


def _traces(n=2, horizon=600):
    return [synthetic_trace(seed=s, bias=0.55 + 0.1 * s, horizon_s=horizon,
                            request_size_s=0.05, mean_demand_workers=30.0)
            for s in range(n)]


def _assert_totals_close(got, want, tag):
    for f in ("requests", "deadline_misses", "fpga_spinups", "cpu_spinups"):
        assert getattr(got, f) == getattr(want, f), (tag, f)
    for f in ("energy_j", "cost_usd", "work_on_fpga_cpu_s",
              "work_on_cpu_cpu_s", "fpga_idle_j", "fpga_busy_j",
              "cpu_busy_j", "spinup_j"):
        w, g = getattr(want, f), getattr(got, f)
        assert abs(w - g) <= RTOL_RUN * max(abs(w), 1.0), (tag, f, w, g)


def _step_inputs(cells, seed):
    """Per-cell fleet scalars, objective terms and parameters as numpy
    arrays keyed by the reference's field names."""
    rng = np.random.default_rng(seed)
    fs_ref = rr.FleetScalars.from_fleet(REF_FLEET)
    fs = {f: np.full(cells, float(v), np.float32)
          for f, v in zip(rr.FleetScalars._fields, fs_ref)}
    ew = rng.uniform(0, 1, cells).astype(np.float32)
    co, tb = jax.vmap(lambda w: rr.coeffs_in_graph(fs_ref, 10, fs_ref.A_f_s,
                                                   w))(jnp.asarray(ew))
    params = {"headroom": rng.integers(0, 3, cells).astype(np.int32),
              "static_level": rng.integers(0, 20, cells).astype(np.int32),
              "gain": rng.uniform(0, 1, cells).astype(np.float32)}
    size = rng.uniform(0.01, 0.1, cells).astype(np.float32)
    return fs, co, np.array(tb), params, size


def _ref_state(st):
    acc = rr.Accum(*(jnp.asarray(st["accum"][f]) for f in rr.Accum._fields))
    return rr.SimState(**{f: jnp.asarray(st[f]) for f in rr.SimState._fields
                          if f != "accum"}, accum=acc)


def _assert_state_equal(port, ref, fields):
    for f in fields:
        got, want = getattr(port, f), np.asarray(getattr(ref, f))
        if f == "t":
            assert np.all(want == got), f
        elif f == "accum":
            for name, g, w in zip(pr.Accum._fields, got, ref.accum):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-6, err_msg=name)
        elif want.dtype.kind == "f":
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f)


@pytest.mark.parametrize("policy", ["spork", "cpu_dynamic", "fpga_static",
                                    "fpga_dynamic", "mark_ideal"])
def test_second_step_matches_reference(policy):
    cells, n = 4, 16
    st = _random_state(cells, n, seed=len(policy))
    fs, co, tb, params, size = _step_inputs(cells, seed=len(policy))
    arrivals = np.random.default_rng(1).integers(0, 400, cells).astype(
        np.int32)
    pol_r = ref_policy(policy)

    def ref_step(fs_, co_, tb_, size_, params_, state_, arr_):
        ctx = RefCtx(10, 10, n, fs_, size_, co_, tb_)
        return rr._second_step(pol_r, ctx, params_, state_, arr_)

    want = jax.jit(jax.vmap(ref_step))(
        rr.FleetScalars(*(jnp.asarray(fs[f]) for f in rr.FleetScalars._fields)),
        co, jnp.asarray(tb), jnp.asarray(size),
        RefParams(*(jnp.asarray(params[f]) for f in RefParams._fields)),
        _ref_state(st), jnp.asarray(arrivals))
    ctx = RateCtx(10, 10, n, interop.fleet_scalars(fs, device="cpu"),
                  torch.as_tensor(size),
                  interop.objective_coeffs(co._asdict(), device="cpu"),
                  torch.as_tensor(tb))
    got = pr._second_step(get_rate_policy(policy), ctx,
                          interop.rate_params(params, device="cpu"),
                          interop.sim_state(st, device="cpu"),
                          torch.as_tensor(arrivals))
    _assert_state_equal(got, want, ("up", "pending", "used_ring",
                                    "young_ring", "dealloc_ring", "F_acc",
                                    "C_acc", "cpu_prev", "queue", "t",
                                    "accum"))


def test_spork_allocator_tick_matches_reference():
    """The policy-level tick: lifetime replay, histogram observe, Alg. 2
    predict, provisioning — every touched state field equal."""
    cells, n = 4, 64
    st = _random_state(cells, n, seed=5)
    fs, co, tb, params, size = _step_inputs(cells, seed=5)
    pol_r = ref_policy("spork")

    def ref_tick(fs_, co_, tb_, size_, params_, state_):
        ctx = RefCtx(10, 10, n, fs_, size_, co_, tb_)
        return pol_r.allocator_tick(ctx, params_, state_, (0, 0.0, 0.0))

    want = jax.jit(jax.vmap(ref_tick))(
        rr.FleetScalars(*(jnp.asarray(fs[f]) for f in rr.FleetScalars._fields)),
        co, jnp.asarray(tb), jnp.asarray(size),
        RefParams(*(jnp.asarray(params[f]) for f in RefParams._fields)),
        _ref_state(st))
    ctx = RateCtx(10, 10, n, interop.fleet_scalars(fs, device="cpu"),
                  torch.as_tensor(size),
                  interop.objective_coeffs(co._asdict(), device="cpu"),
                  torch.as_tensor(tb))
    got = get_rate_policy("spork").allocator_tick(
        ctx, interop.rate_params(params, device="cpu"),
        interop.sim_state(st, device="cpu"), (None, None, None))
    _assert_state_equal(got, want, ("pending", "H", "alloc_time", "life_sum",
                                    "life_cnt", "n_lag", "F_acc", "C_acc",
                                    "accum"))


@pytest.mark.parametrize("policy", ["spork", "fpga_static", "mark_ideal"])
def test_simulate_batch_matches_reference(policy):
    traces = _traces()
    counts_b = np.stack([t.counts for t in traces])
    got = pr.batch_totals(pr.simulate_batch(policy, counts_b, 0.05,
                                            DEFAULT_FLEET, energy_weight=0.5,
                                            n_max=N_MAX, device="cpu"),
                          counts_b, 0.05)
    want = rr.batch_totals(rr.simulate_batch(policy, counts_b, 0.05,
                                             REF_FLEET, energy_weight=0.5,
                                             n_max=N_MAX), counts_b, 0.05)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_totals_close(g, w, (policy, i))
    one = pr.simulate(policy, traces[1].counts, 0.05, DEFAULT_FLEET,
                      energy_weight=0.5, n_max=N_MAX, device="cpu")
    _assert_totals_close(one, got[1], (policy, "per-call"))


def test_simulate_matches_reference_on_slow_spinup_fleet():
    tr = _traces(1)[0]
    slow_p = DEFAULT_FLEET.replace(fpga=DEFAULT_FLEET.fpga.replace(
        spin_up_s=60.0))
    slow_r = REF_FLEET.replace(fpga=REF_FLEET.fpga.replace(spin_up_s=60.0))
    got = pr.simulate("spork", tr.counts, 0.05, slow_p, n_max=N_MAX,
                      device="cpu")
    want = rr.simulate("spork", tr.counts, 0.05, slow_r, n_max=N_MAX)
    _assert_totals_close(got, want, "spork@spin60")


def test_tune_fpga_dynamic_matches_reference():
    tr = _traces(1)[0]
    h, tot = pr.tune_fpga_dynamic(tr.counts, 0.05, DEFAULT_FLEET,
                                  n_max=N_MAX, max_k=8, device="cpu")
    h_r, tot_r = rr.tune_fpga_dynamic(tr.counts, 0.05, REF_FLEET,
                                      n_max=N_MAX, max_k=8)
    assert h == h_r
    assert pr.headroom_unit(tr.counts, 0.05, DEFAULT_FLEET) == \
        rr.headroom_unit(tr.counts, 0.05, REF_FLEET)
    _assert_totals_close(tot, tot_r, "tune")


def test_entry_points_device_none_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    counts = np.ones(20, np.int64)
    with pytest.raises(RuntimeError, match="CUDA"):
        pr.simulate("spork", counts, 0.05, DEFAULT_FLEET)
    with pytest.raises(RuntimeError, match="CUDA"):
        pr.simulate_batch("spork", counts[None], 0.05, DEFAULT_FLEET)
    with pytest.raises(RuntimeError, match="CUDA"):
        pr.tune_fpga_dynamic(counts, 0.05, DEFAULT_FLEET)
    with pytest.raises(RuntimeError, match="CUDA"):
        pr.FleetScalars.from_fleet(DEFAULT_FLEET)
