"""Port predictor (Alg. 2) and the `spork_predict` wrapper vs the reference.

Inputs are made with numpy from a seed and fed to both packages; the
port runs on the CPU, where the `spork_predict` wrapper takes the plain
PyTorch version. Tolerances: finite J entries rtol 2e-5 with an
identical +inf mask (the reference kernel's own contract); integer
outputs (targets, lags, histograms, lifetime counts) exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import predictor as rp
from repro.core.breakeven import ObjectiveCoeffs as RCoeffs
from repro.core.breakeven import energy_coeffs
from repro.core.workers import DEFAULT_FLEET
from repro.kernels.spork_predict import ops as ref_ops
from repro_torch import interop
from repro_torch.core import predictor as pp
from repro_torch.core.breakeven import ObjectiveCoeffs
from repro_torch.kernels.spork_predict import ops
from repro_torch.kernels.spork_predict.ref import expected_objective_ref

RTOL = 2e-5

# jitted (and vmapped over cells) reference entry points: one compile
# per shape instead of one per eager op
_ref_prefix = jax.jit(rp._prefix_sum)
_ref_j = jax.jit(rp.expected_objective_jnp)
_ref_pallas = jax.jit(ref_ops.expected_objective)
_ref_amort = jax.jit(jax.vmap(
    lambda ls, lc, nc, unit: rp.amortization_vector(ls, lc, nc, 10.0, unit)))
_ref_life = jax.jit(jax.vmap(rp.lifetime_update_from_rings,
                             in_axes=(0, 0, 0, 0, 0, 0, None)))
_ref_tick = jax.jit(jax.vmap(rp.allocator_tick_jnp,
                             in_axes=(0, 0, 0, 0, 0, 0, 0, None, 0)))


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _j_inputs(n, seed, cells=1):
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 6, (cells, n)).astype(np.float32)
    life_sum = rng.uniform(0, 100, (cells, n)).astype(np.float32)
    life_cnt = rng.integers(0, 3, (cells, n)).astype(np.float32)
    return hist, life_sum, life_cnt


def _assert_j_close(got, want, tag):
    got, want = np.asarray(got), np.asarray(want)
    mask = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), mask, err_msg=tag)
    np.testing.assert_allclose(got[mask], want[mask], rtol=RTOL, err_msg=tag)


@pytest.mark.parametrize("n", [16, 64, 200, 512])
def test_prefix_sum_matches_reference(n):
    x = np.random.default_rng(n).uniform(0, 1, (3, n)).astype(np.float32)
    np.testing.assert_allclose(pp._prefix_sum(_t(x)).numpy(),
                               np.asarray(_ref_prefix(jnp.asarray(x))),
                               rtol=RTOL)


def test_amortization_vector_matches_reference():
    n, cells = 64, 3
    hist, life_sum, life_cnt = _j_inputs(n, 0, cells)
    n_curr = np.array([0, 5, 63], np.int32)
    unit = np.array([500.0, 0.27, 1.0], np.float32)
    got = pp.amortization_vector(_t(life_sum), _t(life_cnt),
                                 _t(n_curr, torch.int32), 10.0, _t(unit))
    want = _ref_amort(jnp.asarray(life_sum), jnp.asarray(life_cnt),
                      jnp.asarray(n_curr), jnp.asarray(unit))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


@pytest.mark.parametrize("n", [16, 128, 200, 512])
def test_expected_objective_matches_reference_and_pallas_kernel(n):
    """The plain version (what the CUDA kernel is held to on the card)
    against the reference oracle and the Pallas kernel (interpret mode)."""
    hist, life_sum, life_cnt = _j_inputs(n, n)
    coeffs = energy_coeffs(DEFAULT_FLEET)
    amort = np.asarray(_ref_amort(
        jnp.asarray(life_sum), jnp.asarray(life_cnt), jnp.asarray([2]),
        jnp.asarray([coeffs.amort_unit], jnp.float32)))[0]
    got = pp.expected_objective(_t(hist), coeffs, _t(amort[None]))[0]
    want = _ref_j(jnp.asarray(hist[0]), coeffs, jnp.asarray(amort))
    pallas = _ref_pallas(jnp.asarray(hist[0]), coeffs, jnp.asarray(amort))
    _assert_j_close(got, want, "vs expected_objective_jnp")
    _assert_j_close(got, pallas, "vs spork_predict_pallas")


def test_expected_objective_batched_cells_and_argmin():
    """Per-cell coefficients along the cell axis, incl. an empty and a
    one-bin histogram; argmin picks the reference's allocation."""
    n, cells = 64, 6
    rng = np.random.default_rng(7)
    hist = rng.integers(0, 4, (cells, n)).astype(np.float32)
    hist[1] = 0.0
    hist[2] = 0.0
    hist[2, 9] = 3.0
    amort = np.cumsum(rng.uniform(0, 50, (cells, n)), axis=1).astype(
        np.float32)
    w = rng.uniform(0, 1, cells)
    host = [RCoeffs(*(float(x) for x in (50 * 10 * v + 1, 20.0 * v + 0.5,
                                          300.0, 500.0))) for v in w]
    coeffs = ObjectiveCoeffs(*(_t([h[i] for h in host]) for i in range(4)))
    got = pp.expected_objective(_t(hist), coeffs, _t(amort)).numpy()
    assert np.all(np.isinf(got[1]))
    assert np.isfinite(got[2]).sum() == 1 and np.isfinite(got[2, 9])
    for c in range(cells):
        want = np.asarray(_ref_j(jnp.asarray(hist[c]), host[c],
                                 jnp.asarray(amort[c])))
        _assert_j_close(got[c], want, f"cell {c}")
        if np.isfinite(want).any():
            assert int(np.argmin(got[c])) == int(np.argmin(want))


def test_wrapper_on_cpu_uses_plain_version_and_counts_no_launch():
    hist, life_sum, life_cnt = _j_inputs(512, 3, cells=4)
    coeffs = energy_coeffs(DEFAULT_FLEET)
    amort = pp.amortization_vector(_t(life_sum), _t(life_cnt),
                                   torch.zeros(4, dtype=torch.int32),
                                   10.0, coeffs.amort_unit)
    before = ops.expected_objective.launches
    got = ops.expected_objective(_t(hist), coeffs, amort)
    assert ops.expected_objective.launches == before
    assert torch.equal(got, expected_objective_ref(_t(hist), coeffs, amort))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.expected_objective(_t(hist).to("meta"), coeffs, amort.to("meta"))


def test_cuda_kernel_matches_plain_version():
    """The hand-written kernel against the plain version on the card
    (needs a CUDA card and nvcc; `chip_smoke.py` runs the same check at
    the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cells, n in ((1, 16), (3, 200), (32, 512), (2, 4096)):
        hist, life_sum, life_cnt = _j_inputs(n, n, cells)
        hist = _t(hist).cuda()
        coeffs = ObjectiveCoeffs(*(torch.full((cells,), v, device="cuda")
                                   for v in energy_coeffs(DEFAULT_FLEET)))
        amort = pp.amortization_vector(_t(life_sum).cuda(),
                                       _t(life_cnt).cuda(),
                                       torch.zeros(cells, dtype=torch.int32,
                                                   device="cuda"),
                                       10.0, coeffs.amort_unit)
        before = ops.expected_objective.launches
        got = ops.expected_objective(hist, coeffs, amort).cpu()
        assert ops.expected_objective.launches == before + 1
        want = expected_objective_ref(hist, coeffs, amort).cpu()
        for c in range(cells):
            _assert_j_close(got[c].numpy(), want[c].numpy(), f"{cells}x{n}")
        rows = torch.isfinite(want).any(dim=1)
        assert torch.equal(got.argmin(1)[rows], want.argmin(1)[rows])


def _random_state(cells, n, interval=10, spin=10, t=50, seed=0):
    """A random mid-run rate-simulator state, batched over cells, as
    numpy arrays keyed by the reference's `SimState` field names."""
    rng = np.random.default_rng(seed)
    ri = lambda hi, shape: rng.integers(0, hi, shape).astype(np.int32)  # noqa
    rf = lambda hi, shape: rng.uniform(0, hi, shape).astype(np.float32)  # noqa
    young, dealloc = ri(3, (cells, interval)), ri(3, (cells, interval))
    state = dict(
        up=ri(n // 4, cells) + dealloc.sum(1).astype(np.int32),
        pending=ri(3, (cells, spin + 1)), used_ring=ri(n // 4, (cells, interval)),
        young_ring=young, dealloc_ring=dealloc,
        alloc_time=rf(t, (cells, n)).round(),
        H=ri(4, (cells, n, n)).astype(np.float32),
        life_sum=rf(200, (cells, n)).round(), life_cnt=ri(4, (cells, n)).astype(
            np.float32),
        n_lag=ri(n, (cells, 2)), F_acc=rf(30 * interval, cells),
        C_acc=rf(30 * interval, cells), cpu_prev=ri(5, cells),
        queue=rf(3, cells), lam_hist=rf(30 * interval, cells),
        t=np.full(cells, t, np.int32))
    state["H"][1] = 0.0                       # an empty histogram row set
    state["accum"] = {f: rf(1e4, cells) for f in (
        "fpga_busy_j", "fpga_idle_j", "cpu_busy_j", "cpu_idle_j", "spin_j",
        "cost", "work_f", "work_c", "missed_requests", "fpga_spinups",
        "cpu_spinups")}
    return state


@pytest.mark.parametrize("n", [40, 64])
def test_lifetime_update_from_rings_matches_reference(n):
    st = _random_state(4, n, seed=n)
    port = interop.sim_state(st, device="cpu")
    got = pp.lifetime_update_from_rings(
        port.alloc_time, port.life_sum, port.life_cnt, port.young_ring,
        port.dealloc_ring, port.up, port.t)
    want = _ref_life(*(jnp.asarray(st[f]) for f in (
        "alloc_time", "life_sum", "life_cnt", "young_ring", "dealloc_ring",
        "up")), jnp.asarray(st["t"][0]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", [40, 64])
def test_allocator_tick_matches_reference(n):
    """Alg. 1+2 tick from a random mid-run state carried across by
    `interop`: histogram, lags and targets exactly equal."""
    cells = 5
    st = _random_state(cells, n, seed=100 + n)
    rng = np.random.default_rng(n)
    lam = rng.uniform(0, 10 * n / 2, cells).astype(np.float32)
    n_curr = rng.integers(0, n, cells).astype(np.int32)
    tb = rng.uniform(0, 10, cells).astype(np.float32)
    co = {"co_min": rng.uniform(100, 600, cells),
          "co_over": rng.uniform(50, 300, cells),
          "co_under": rng.uniform(300, 3000, cells),
          "amort_unit": rng.uniform(100, 600, cells)}
    port = interop.sim_state(st, device="cpu")
    H, n_lag, target = pp.allocator_tick(
        port.H.clone(), port.life_sum, port.life_cnt, port.n_lag, _t(lam),
        _t(n_curr, torch.int32), interop.objective_coeffs(co, device="cpu"),
        10.0, _t(tb))
    wH, wl, wt = _ref_tick(
        jnp.asarray(st["H"]), jnp.asarray(st["life_sum"]),
        jnp.asarray(st["life_cnt"]), jnp.asarray(st["n_lag"]),
        jnp.asarray(lam), jnp.asarray(n_curr),
        RCoeffs(*(jnp.asarray(co[f], jnp.float32) for f in RCoeffs._fields)),
        jnp.float32(10.0), jnp.asarray(tb))
    np.testing.assert_array_equal(H.numpy(), np.asarray(wH))
    np.testing.assert_array_equal(n_lag.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(target.numpy(), np.asarray(wt))


def test_interop_round_trips_and_rejects_mixed_seconds():
    st = _random_state(3, 16, seed=9)
    port = interop.sim_state(st, device="cpu")
    assert port.t == 50 and port.H.shape == (3, 16, 16)
    assert port.up.dtype == torch.int32 and port.F_acc.dtype == torch.float32
    back = interop.accum_to_numpy(port.accum)
    for f, v in st["accum"].items():
        np.testing.assert_array_equal(back[f], v)
    st["t"] = np.array([50, 50, 60], np.int32)
    with pytest.raises(ValueError, match="share the second"):
        interop.sim_state(st, device="cpu")


def test_interop_device_none_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    st = _random_state(2, 16)
    for fn, arg in ((interop.sim_state, st),
                    (interop.accum, st["accum"]),
                    (interop.rate_params, {"headroom": [1], "static_level": [0],
                                           "gain": [1.0]})):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(arg)
