"""Port min-plus DP (`repro_torch.core.dp`) vs the reference (`repro.core.dp`).

Inputs are made with numpy from a seed and fed to both packages; the
port runs on the CPU (``device="cpu"``), where the transition wrappers
take their plain PyTorch versions. Tolerances:

* transition steps: values and argmins bitwise equal on integer-valued
  instances, where float32 arithmetic is exact in both packages; rtol
  1e-5 / atol 1e-4 on continuous inputs (the reference test's own);
* `solve_dp`: paths identical on the fixed seeds, objectives rtol 1e-6;
  `solve_dp_batch` / `pareto_front`: objectives and weighted exact
  evaluations rtol 1e-6 (the reference's optimality-equivalence
  contract); `evaluate_path`: exactly equal on the same path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:    # environment without hypothesis: local shim
    from _hypothesis_shim import given, settings, strategies as st

from repro.core import dp as rdp
from repro.core.workers import DEFAULT_FLEET as REF_FLEET
from repro_torch import interop
from repro_torch.core import dp as pdp

PORT_FLEET = interop.fleet_params(REF_FLEET)

# one row at a time in the reference, vmapped over the port's batch axis
_ref_dense = jax.jit(jax.vmap(rdp.minplus_step_jnp))
_ref_structured = jax.jit(jax.vmap(rdp.minplus_step_structured))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _monotone(rng, shape, lo=0, hi=50):
    return np.sort(rng.integers(lo, hi, shape), axis=-1)[..., ::-1].astype(
        np.float32)


def _exact_instance(seed, n, rows=2):
    """Integer-valued rows: every intermediate of both formulations is an
    exactly representable float32 (|values| < 2**24)."""
    rng = np.random.default_rng(seed)
    F = rng.integers(-4096, 4096, (rows, n)).astype(np.float32)
    coeffs = rng.integers(0, 32, (rows, 4)).astype(np.float32)
    return F, _monotone(rng, (rows, n)), _monotone(rng, (rows, n)), coeffs


def _both_steps(F, ycp, ycc, coeffs):
    """(reference, port) results of the dense and the structured step."""
    ref = [_ref_dense(F, ycp, ycc, coeffs), _ref_structured(F, ycp, ycc, coeffs)]
    args = (_t(F), _t(ycp), _t(ycc), _t(coeffs))
    port = [pdp.minplus_step(*args), pdp.minplus_step_structured(*args)]
    return ([tuple(np.asarray(x) for x in r) for r in ref],
            [tuple(x.numpy() for x in p) for p in port])


def _assert_steps_equal(F, ycp, ycc, coeffs):
    ref, port = _both_steps(F, ycp, ycc, coeffs)
    for (rv, ra), (pv, pa) in zip(ref, port):
        np.testing.assert_array_equal(pv, rv)
        np.testing.assert_array_equal(pa, ra)
        assert pa.dtype == np.int32


@given(seed=st.integers(0, 100_000), n=st.integers(1, 600))
@settings(max_examples=25, deadline=None)
def test_steps_bitwise_equal_reference_on_exact_instances(seed, n):
    _assert_steps_equal(*_exact_instance(seed, n))


def test_steps_first_minimizer_with_all_zero_coeffs():
    """trans == 0 everywhere: every destination ties across all sources,
    and the argmin is the first global minimizer of F."""
    n = 257
    F = np.tile([2.0, 1.0, 1.0, 3.0], 65)[:n].astype(np.float32)[None]
    z = np.zeros((1, n), np.float32)
    _assert_steps_equal(F, z, z, np.zeros((1, 4), np.float32))
    _, a = pdp.minplus_step_structured(_t(F), _t(z), _t(z), (0.0,) * 4)
    assert torch.all(a == 1)


# n from a small set in the next two tests: the reference compiles once per
# shape, and that compile, not the check, is what costs time here
@given(seed=st.integers(0, 100_000), n=st.sampled_from([2, 45, 200]))
@settings(max_examples=10, deadline=None)
def test_structured_falls_back_on_non_monotone_rows(seed, n):
    """A row that breaks the monotone precondition takes the dense
    transition, per row, next to a monotone row that does not."""
    rng = np.random.default_rng(seed)
    F = rng.integers(-100, 100, (2, n)).astype(np.float32)
    ycp = rng.integers(0, 9, (2, n)).astype(np.float32)      # shuffled
    ycc = rng.integers(0, 9, (2, n)).astype(np.float32)
    ycp[1], ycc[1] = np.sort(ycp[1])[::-1], np.sort(ycc[1])[::-1]
    coeffs = rng.integers(0, 10, (2, 4)).astype(np.float32)
    _assert_steps_equal(F, ycp, ycc, coeffs)


@given(seed=st.integers(0, 100_000), n=st.sampled_from([2, 57, 399]))
@settings(max_examples=10, deadline=None)
def test_steps_close_to_reference_on_continuous_inputs(seed, n):
    rng = np.random.default_rng(seed)
    F = rng.normal(0, 100, (2, n)).astype(np.float32)
    ycp = np.sort(rng.uniform(0, 40, (2, n)), axis=1)[:, ::-1].astype(np.float32)
    ycc = np.sort(rng.uniform(0, 40, (2, n)), axis=1)[:, ::-1].astype(np.float32)
    coeffs = rng.uniform(0, 10, (2, 4)).astype(np.float32)
    ref, port = _both_steps(F, ycp, ycc, coeffs)
    for (rv, _), (pv, _) in zip(ref, port):
        np.testing.assert_allclose(pv, rv, rtol=1e-5, atol=1e-4)


def test_coefficients_as_tensor_or_scalars_agree():
    F, ycp, ycc, coeffs = _exact_instance(3, 50, rows=1)
    args = (_t(F), _t(ycp), _t(ycc))
    for step in (pdp.minplus_step, pdp.minplus_step_structured):
        a = step(*args, _t(coeffs))
        b = step(*args, tuple(float(x) for x in coeffs[0]))
        c = step(*args, tuple(_t(coeffs[:, k]) for k in range(4)))
        for x, y in ((a, b), (a, c)):
            assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])


def test_table_level_matches_reference_log2():
    """The integer bit length used by the port (and its CUDA kernel) gives
    the reference's floor(log2(float)) for every length up to 4096."""
    length = np.arange(0, 4097, dtype=np.int32)
    for n_levels in range(1, 14):
        s = jnp.floor(jnp.log2(jnp.maximum(length, 1).astype(jnp.float32)))
        want = np.asarray(jnp.clip(s.astype(jnp.int32), 0, n_levels - 1))
        got = pdp._table_level(torch.from_numpy(length), n_levels).numpy()
        np.testing.assert_array_equal(got, want)


def _fleet_pair(n_levels):
    ref = REF_FLEET.replace(max_fpgas=2 * n_levels, max_cpus=10 ** 6)
    return ref, interop.fleet_params(ref)


@pytest.mark.parametrize("transition", pdp.TRANSITIONS)
@pytest.mark.parametrize("seed,n_levels,t", [(0, 64, 16), (1, 300, 12),
                                             (2, 300, 20)])
def test_solve_dp_paths_match_reference(transition, seed, n_levels, t):
    ref_fleet, port_fleet = _fleet_pair(n_levels)
    W = np.random.default_rng(seed).uniform(
        0, (n_levels - 2) * ref_fleet.S * ref_fleet.T_s, size=t)
    for ew in (1.0, 0.0, 0.3):
        want = rdp.solve_dp(W, ref_fleet, energy_weight=ew,
                            transition=transition, n_levels=n_levels)
        got = pdp.solve_dp(W, port_fleet, energy_weight=ew,
                           transition=transition, n_levels=n_levels,
                           device="cpu")
        np.testing.assert_array_equal(got.y_fpga, want.y_fpga)
        np.testing.assert_array_equal(got.y_cpu, want.y_cpu)
        np.testing.assert_allclose(got.objective, want.objective, rtol=1e-6)
        assert got.energy_j == want.energy_j and got.cost_usd == want.cost_usd


@pytest.mark.parametrize("kw", [dict(allow_fpga=False), dict(allow_cpu=False),
                                dict(n_levels=96)])
def test_solve_dp_options_match_reference(kw):
    W = np.random.default_rng(4).uniform(0, 40 * REF_FLEET.T_s, size=12)
    want = rdp.solve_dp(W, REF_FLEET, **kw)
    got = pdp.solve_dp(W, PORT_FLEET, device="cpu", **kw)
    np.testing.assert_array_equal(got.y_fpga, want.y_fpga)
    np.testing.assert_allclose(got.objective, want.objective, rtol=1e-6)


def _assert_equivalent(got, want, weights):
    """Identical objectives and exact evaluations under each row's weights
    (two equally optimal paths may differ at an exactly tied interval)."""
    for w, g, r in zip(weights, got, want):
        np.testing.assert_allclose(g.objective, r.objective, rtol=1e-6)
        we, wc = rdp._objective_weights(float(w), REF_FLEET)
        np.testing.assert_allclose(we * g.energy_j + wc * g.cost_usd,
                                   we * r.energy_j + wc * r.cost_usd,
                                   rtol=1e-6)


@pytest.mark.parametrize("transition", pdp.TRANSITIONS)
def test_solve_dp_batch_and_pareto_front_match_reference(transition):
    rng = np.random.default_rng(5)
    Ws = np.stack([rng.uniform(0, s * REF_FLEET.T_s, size=12)
                   for s in (40, 10, 40, 25)])      # two dense buckets
    weights = [1.0, 0.6, 0.3, 0.0]
    want = rdp.solve_dp_batch(Ws, REF_FLEET, weights, transition=transition)
    got = pdp.solve_dp_batch(Ws, PORT_FLEET, weights, transition=transition,
                             device="cpu")
    _assert_equivalent(got, want, weights)
    want = rdp.pareto_front(Ws[0], REF_FLEET, transition=transition)
    got = pdp.pareto_front(Ws[0], PORT_FLEET, transition=transition,
                           device="cpu")
    _assert_equivalent(got, want, rdp.PARETO_WEIGHTS)


def test_port_transitions_agree_with_dense():
    """Within the port, structured and kernel are optimality-equivalent to
    the dense oracle (the reference's own contract)."""
    rng = np.random.default_rng(6)
    Ws = np.stack([rng.uniform(0, 40 * REF_FLEET.T_s, size=12)
                   for _ in range(4)])
    weights = [1.0, 0.6, 0.3, 0.0]
    dense = pdp.solve_dp_batch(Ws, PORT_FLEET, weights, n_levels=64,
                               transition="dense", device="cpu")
    for transition in ("structured", "kernel"):
        got = pdp.solve_dp_batch(Ws, PORT_FLEET, weights, n_levels=64,
                                 transition=transition, device="cpu")
        _assert_equivalent(got, dense, weights)


def test_evaluate_path_matches_reference_exactly():
    rng = np.random.default_rng(7)
    W = rng.uniform(0, 30 * REF_FLEET.T_s, size=40)
    path = rng.integers(0, 20, size=40)
    want = rdp.evaluate_path(W, path, REF_FLEET, objective=1.5)
    got = pdp.evaluate_path(W, path, PORT_FLEET, objective=1.5)
    np.testing.assert_array_equal(got.y_fpga, want.y_fpga)
    np.testing.assert_array_equal(got.y_cpu, want.y_cpu)
    assert (got.objective, got.energy_j, got.cost_usd) == (
        want.objective, want.energy_j, want.cost_usd)
    for f in got.totals.FLOAT_FIELDS + got.totals.COUNT_FIELDS:
        assert getattr(got.totals, f) == getattr(want.totals, f), f


def test_level_buckets_follow_the_reference_rule():
    W = np.array([[10.0, 2000.0], [30.0, 6000.0], [1.0, 1.0]])
    S_Ts = REF_FLEET.S * REF_FLEET.T_s
    per_row = np.ceil(W.max(1) / S_Ts) + 2
    dense = pdp.level_buckets(W, PORT_FLEET, transition="dense")
    np.testing.assert_array_equal(dense, 128 * np.ceil(per_row / 128))
    for transition in ("structured", "kernel"):
        got = pdp.level_buckets(W, PORT_FLEET, transition=transition)
        np.testing.assert_array_equal(got, np.full(3, dense.max()))
    np.testing.assert_array_equal(
        pdp.level_buckets(W, PORT_FLEET, allow_fpga=False), [1, 1, 1])
    np.testing.assert_array_equal(
        pdp.level_buckets(W, PORT_FLEET, n_levels=77), [77, 77, 77])


def test_transition_rejects_unknown_backend():
    with pytest.raises(ValueError, match="unknown transition"):
        pdp.solve_dp(np.full(8, 10.0), PORT_FLEET, transition="blocked",
                     device="cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    W = np.full(8, 100.0)
    for call in (lambda: pdp.solve_dp(W, PORT_FLEET),
                 lambda: pdp.solve_dp_batch(W[None], PORT_FLEET, [1.0]),
                 lambda: pdp.pareto_front(W, PORT_FLEET)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
