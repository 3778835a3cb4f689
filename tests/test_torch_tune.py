"""Port gradient tuner (`repro_torch.policies.tune`, the `relax` kernels'
plain version, `RateParams.make`) vs the reference (`repro.policies.tune`)
on the CPU.

The trace is the reference's `tests/test_policy_tune.py` trace (600 s,
60 intervals), drawn under `jax.threefry_partitionable(False)` as
`tests/test_torch_policies.py::golden_trace` draws its own. Tolerances:
the relaxation's cost in float32 to rtol 1e-5 (the same arithmetic; the
frameworks round sigmoid, softplus and the final sum at their own
places: ~1e-7 seen); the float64 gradient to rtol 1e-9 against the
reference's `jax.grad` under `jax.enable_x64(True)` (~1e-15 seen), and
to the reference's own 5e-4 / 1e-3 against central differences on the
port. The tuner's choice (headroom, gain, source) must equal the
reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.traces import synthetic_trace
from repro.core.workers import DEFAULT_FLEET as REF_FLEET
from repro.policies import base as ref_base
from repro.policies import tune as ref_tune
from repro_torch.core.workers import DEFAULT_FLEET
from repro_torch.kernels.relax import ops as relax_ops
from repro_torch.policies import RateParams
from repro_torch.policies import tune

# points spanning the domain: at/near init, mid-descent, near bounds
THETAS = [(0.5, 0.0, 0.9), (2.3, 0.7, 0.85), (7.0, 1.5, 0.65)]


@pytest.fixture(scope="module")
def trace():
    with jax.threefry_partitionable(False):
        return synthetic_trace(seed=3, bias=0.65, horizon_s=600,
                               request_size_s=0.05,
                               mean_demand_workers=100.0)


def _specs(tr, dtype):
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    tdt = torch.float64 if dtype == "float64" else torch.float32
    ref = ref_tune.make_spec(tr.counts, tr.request_size_s, REF_FLEET,
                             dtype=jdt)
    port = tune.make_spec(tr.counts, tr.request_size_s, DEFAULT_FLEET,
                          dtype=tdt, device="cpu")
    return ref, port


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_make_spec_matches_reference(trace, dtype):
    with jax.enable_x64(dtype == "float64"):
        ref, port = _specs(trace, dtype)
        assert port.demand.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(port.demand.numpy(),
                                      np.asarray(ref.demand))
    assert tuple(port)[1:] == tuple(ref)[1:]
    assert port._fields == ref._fields
    assert port.demand.shape == (60,)


@pytest.mark.parametrize("theta", THETAS)
def test_relaxed_cost_float32_matches_reference(trace, theta):
    ref, port = _specs(trace, "float32")
    want = float(ref_tune.relaxed_cost(jnp.asarray(theta, jnp.float32), ref))
    got = tune.relaxed_cost(theta, port)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("theta", THETAS)
def test_grad_float64_matches_reference(trace, theta):
    with jax.enable_x64(True):
        ref, port = _specs(trace, "float64")
        want = np.asarray(ref_tune.relaxed_grad(
            jnp.asarray(theta, jnp.float64), ref))
        assert want.dtype == np.float64
    got = tune.relaxed_grad(theta, port)
    assert got.dtype == torch.float64 and got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=0)


@pytest.mark.parametrize("theta", THETAS)
def test_grad_matches_central_fd_all_params(trace, theta):
    """The port's float64 gradient against central differences on the
    port, on every tuned parameter (the reference's own check)."""
    _, port = _specs(trace, "float64")
    th = torch.tensor(theta, dtype=torch.float64)
    g = tune.relaxed_grad(th, port).numpy()
    h = 1e-5
    for i in range(3):
        e = torch.zeros(3, dtype=torch.float64)
        e[i] = h
        fd = (float(tune.relaxed_cost(th + e, port))
              - float(tune.relaxed_cost(th - e, port))) / (2 * h)
        np.testing.assert_allclose(g[i], fd, rtol=5e-4, atol=1e-3,
                                   err_msg=f"param {i} at theta={theta}")
    assert np.all(np.abs(g) > 0.0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_relax_wrappers_take_the_plain_version_on_the_cpu(trace, dtype):
    """`relax_forward` / `relax_backward` and the autograd function on CPU
    tensors: the plain loop's cost, saved buffers and gradient, and no
    launch counted."""
    _, port = _specs(trace, dtype)
    consts = tuple(port[1:])
    th = torch.tensor(THETAS[1], dtype=port.demand.dtype)
    before = (relax_ops.relax_forward.launches,
              relax_ops.relax_backward.launches)
    cost, n, delta, w = relax_ops.relax_forward(th, port.demand, consts)
    assert float(cost) == float(tune.relaxed_cost(th, port))
    assert n.shape == delta.shape == w.shape == (60,)
    assert bool(((w >= 0) & (w <= 1)).all())
    grad = relax_ops.relax_backward(th, port.demand, consts, (n, delta, w),
                                    torch.tensor(2.0, dtype=th.dtype))
    torch.testing.assert_close(grad, 2.0 * tune.relaxed_grad(th, port),
                               rtol=0, atol=0)
    x = th.clone().requires_grad_(True)
    relax_ops.relaxed_cost(x, port.demand, consts).backward()
    torch.testing.assert_close(x.grad, tune.relaxed_grad(th, port), rtol=0,
                               atol=0)
    assert (relax_ops.relax_forward.launches,
            relax_ops.relax_backward.launches) == before
    with pytest.raises(ValueError, match="float32 or all float64"):
        relax_ops.relax_forward(th.half(), port.demand, consts)
    with pytest.raises(ValueError, match="unsupported device"):
        relax_ops.relax_forward(th.to("meta"), port.demand.to("meta"),
                                consts)


def test_softplus_is_exact_past_torch_threshold():
    x = torch.tensor([-30.0, -6.0, 0.0, 6.0, 30.0], dtype=torch.float64)
    got = tune._softplus(x, 4.0)
    with jax.enable_x64(True):
        want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy()) * 4.0)
                          / 4.0)
    assert want.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15, atol=0)


def test_fit_decreases_surrogate_loss_and_stays_projected(trace):
    _, port = _specs(trace, "float32")
    theta, losses = tune.fit(port, steps=60)
    assert len(losses) == 61 and losses[-1] < losses[0]
    assert np.isfinite(losses).all()
    th = theta.numpy()
    assert th[0] >= 0.0 and 0.0 <= th[1] <= 4.0 and 0.5 <= th[2] <= 1.0
    # a step that would leave the domain is projected back onto it
    theta, _ = tune.fit(port, theta0=(0.0, 4.0, 1.0), steps=3, lr=50.0)
    th = theta.numpy()
    assert th[0] >= 0.0 and 0.0 <= th[1] <= 4.0 and 0.5 <= th[2] <= 1.0


@pytest.mark.parametrize("policy", ["fpga_dynamic", "predictive"])
def test_tune_gradient_matches_reference(trace, policy):
    """The reference's convergence contract on the port, and the same
    choice as the reference's tuner."""
    want = ref_tune.tune_gradient(trace.counts, trace.request_size_s,
                                  REF_FLEET, policy=policy, steps=80)
    got = tune.tune_gradient(trace.counts, trace.request_size_s,
                             DEFAULT_FLEET, policy=policy, steps=80,
                             device="cpu")
    assert (got.headroom, got.gain, got.source) == (want.headroom, want.gain,
                                                    want.source)
    assert (got.grid_headroom, got.n_sim_evals) == (want.grid_headroom,
                                                    want.n_sim_evals)
    assert got.objective <= got.grid_objective
    assert got.totals.deadline_misses == 0
    assert got.objective == pytest.approx(want.objective, rel=1e-5)
    assert got.grid_objective == pytest.approx(want.grid_objective, rel=1e-5)
    # float32 Adam in both frameworks: theta to ~1e-5 after 80 steps
    np.testing.assert_allclose(got.theta, want.theta, rtol=1e-4)
    assert len(got.losses) == 81 and got.losses[-1] < got.losses[0]


def test_objective_is_lexicographic_in_misses():
    assert tune.MISS_PENALTY_J == ref_tune.MISS_PENALTY_J >= 1e8
    t0 = type("T", (), {"energy_j": 1e7, "deadline_misses": 0})
    t1 = type("T", (), {"energy_j": 0.0, "deadline_misses": 1})
    assert tune.objective_of(t0) < tune.objective_of(t1)
    assert tune.objective_of(t1) == ref_tune.objective_of(t1)


def test_rate_params_make():
    want = ref_base.RateParams.make(3, 5, 0.25)
    got = RateParams.make(3, 5, 0.25, device="cpu")
    assert got._fields == want._fields
    for g, w, dt in zip(got, want, (torch.int32, torch.int32,
                                    torch.float32)):
        assert g.dtype == dt and g.shape == (1,)
        assert g.item() == w.item()
    default = RateParams.make(device="cpu")
    assert [x.item() for x in default] == [0, 0, 1.0]


def test_tuner_defaults_to_the_card(trace):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tune.make_spec(trace.counts, trace.request_size_s, DEFAULT_FLEET)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RateParams.make()


def test_cuda_kernels_match_plain_version(trace):
    """On the card: forward value and gradient of the kernels against the
    plain loop on the card, in both types, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU build)")
    for dtype, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-10)):
        spec = tune.make_spec(trace.counts, trace.request_size_s,
                              DEFAULT_FLEET, dtype=dtype, device="cuda")
        for theta in THETAS:
            th = torch.tensor(theta, dtype=dtype, device="cuda")
            before = (relax_ops.relax_forward.launches,
                      relax_ops.relax_backward.launches)
            x = th.clone().requires_grad_(True)
            cost = tune.relaxed_cost(x, spec)
            cost.backward()
            assert (relax_ops.relax_forward.launches,
                    relax_ops.relax_backward.launches) == (before[0] + 1,
                                                           before[1] + 1)
            consts = tuple(spec[1:])
            want = relax_ops.relax_loop(th, spec.demand, consts)[0]
            want_g = relax_ops.relax_grad_ref(th, spec.demand, consts)
            torch.testing.assert_close(cost.detach(), want, rtol=rtol,
                                       atol=0)
            torch.testing.assert_close(x.grad, want_g, rtol=rtol, atol=0)
