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
from repro_torch.core.breakeven import ObjectiveCoeffs, weighted_coeffs
from repro_torch.core.workers import DEFAULT_FLEET as PORT_FLEET
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


# chip_smoke.py's kernel cases: (1, 13) and (32, 201) take the kernel's
# scalar path (N % 4 != 0), as do the OFFSET cases on rows one float past
# a 16-byte boundary
PREDICT_BINS = (16, 128, 200, 512, 4096)
PATH_SHAPES = [(c, n) for c in (1, 32) for n in PREDICT_BINS] + [
    (16, 128), (4, 128), (1, 13), (32, 201)]
OFFSET_SHAPES = [(32, 512), (32, 4096)]


def _path_inputs(cells, n, seed):
    """Histograms, amortization vectors and per-cell objective mixes like
    an allocator tick's (chip_smoke.py's `kernel` cases), on the CPU:
    integer counts with half the bins empty, an empty histogram and a
    one-bin histogram."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 6, (cells, n)).astype(np.float32)
    hist[rng.random((cells, n)) < 0.5] = 0.0
    if cells > 2:
        hist[1] = 0.0
        hist[2] = 0.0
        hist[2, n // 2] = 7.0
    co = [weighted_coeffs(PORT_FLEET, float(w))
          for w in rng.uniform(0.0, 1.0, cells)]
    coeffs = ObjectiveCoeffs(*(_t([c[i] for c in co]) for i in range(4)))
    amort = pp.amortization_vector(
        _t(rng.uniform(0, 200, (cells, n))),
        _t(rng.integers(0, 4, (cells, n))),
        _t(rng.integers(0, n, cells), torch.int32), PORT_FLEET.T_s,
        coeffs.amort_unit)
    return _t(hist), coeffs, amort


def _kernel_order_j(hist, coeffs, amort):
    """J in numpy float32, in the order of spork_predict.cu: a sequential
    chain per (array, 32-bin block), one sequential exclusive chain of
    block totals per array, P(c-1) = within + offset; for sizes that are
    not block-aligned one double chain per array, rounded at each prefix;
    then the J expression, one rounding per operation."""
    f32 = np.float32
    h = hist.numpy()
    a = amort.numpy()
    co = [np.asarray(x, f32).reshape(-1, 1) for x in coeffs[:3]]
    cells, n = h.shape
    total = h.astype(np.float64).sum(1).astype(f32)     # exact: integer counts
    p = h / np.maximum(total, f32(1.0))[:, None]
    bins = np.arange(n, dtype=f32)
    pb = p * bins

    def prefix(x):
        if n < 64 or n % 32:
            return np.cumsum(x.astype(np.float64), axis=1).astype(f32)
        k = n // 32
        blocks = x.reshape(cells, k, 32)
        within = np.empty_like(blocks)
        acc = np.zeros((cells, k), f32)
        for i in range(32):
            acc = acc + blocks[:, :, i]
            within[:, :, i] = acc
        off = np.empty((cells, k), f32)
        run = np.zeros(cells, f32)
        for b in range(k):
            off[:, b] = run
            run = run + within[:, b, 31]
        return (within + off[:, :, None]).reshape(cells, n)

    P, M = prefix(p), prefix(pb)
    zero = np.zeros((cells, 1), f32)
    pm1 = np.concatenate([zero, P[:, :-1]], 1)
    mm1 = np.concatenate([zero, M[:, :-1]], 1)
    tail = P[:, -1:] - pm1
    e_min = mm1 + bins * tail
    e_over = bins * pm1 - mm1
    e_under = (M[:, -1:] - mm1) - bins * tail
    j = co[0] * e_min + co[1] * e_over + co[2] * e_under + a
    idx = np.arange(n)
    has = h > 0
    lo = np.where(has, idx, n).min(1, keepdims=True)
    hi = np.where(has, idx, -1).max(1, keepdims=True)
    return np.where((idx >= lo) & (idx <= hi), j, np.inf).astype(f32)


@pytest.mark.parametrize("n", [128, 512, 4096])
def test_plain_j_of_a_cell_is_the_same_alone_and_in_a_batch(n):
    """A cell's amortization vector and J are bitwise the same computed
    alone (C = 1, the serial paths) and in a batch of 32 (the batched
    paths): the blocked prefix sum sums its offsets in sequential order
    at every C."""
    hist, coeffs, _ = _path_inputs(32, n, n)
    rng = np.random.default_rng(n + 1)
    life_sum = _t(rng.uniform(0, 200, (32, n)))
    life_cnt = _t(rng.integers(0, 4, (32, n)))
    n_curr = _t(rng.integers(0, n, 32), torch.int32)
    amort = pp.amortization_vector(life_sum, life_cnt, n_curr, 10.0,
                                   coeffs.amort_unit)
    batch = pp.expected_objective(hist, coeffs, amort)
    for c in range(32):
        one = ObjectiveCoeffs(*(x[c:c + 1] for x in coeffs))
        amort_c = pp.amortization_vector(life_sum[c:c + 1], life_cnt[c:c + 1],
                                         n_curr[c:c + 1], 10.0,
                                         one.amort_unit)
        assert torch.equal(amort_c[0], amort[c]), f"amort, cell {c}"
        alone = pp.expected_objective(hist[c:c + 1], one, amort_c)
        assert torch.equal(alone[0], batch[c]), f"J, cell {c}"


@pytest.mark.parametrize("cells,n", PATH_SHAPES)
def test_kernel_order_emulation_equals_cpu_plain_version(cells, n):
    """The order spork_predict.cu is built to follow, emulated in numpy,
    is bitwise the CPU plain version at every kernel case of
    chip_smoke.py (which holds the kernel to the same on the card)."""
    hist, coeffs, amort = _path_inputs(cells, n, 1000 * cells + n)
    want = pp.expected_objective(hist, coeffs, amort).numpy()
    got = _kernel_order_j(hist, coeffs, amort)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_coefficient_arguments():
    """Floats go by value; float32 tensors by pointer with their per-cell
    stride, 0 for one value; nothing else is taken."""
    cpu = torch.device("cpu")
    cells = 4
    got = ops.coeff_args(ObjectiveCoeffs(1.5, 2, np.float32(0.25), 9.0),
                         cells, cpu)
    assert got == [None, None, None, 0, 0, 0, 1.5, 2.0, 0.25]
    vec = torch.arange(cells, dtype=torch.float32)
    col = torch.zeros((cells, 3))[:, 1]                  # stride 3
    zero_dim = torch.tensor(7.0)
    one = torch.tensor([3.0])
    got = ops.coeff_args(ObjectiveCoeffs(vec, col, zero_dim, 1.0), cells, cpu)
    assert got == [vec.data_ptr(), col.data_ptr(), zero_dim.data_ptr(),
                   1, 3, 0, 0.0, 0.0, 0.0]
    got = ops.coeff_args(ObjectiveCoeffs(0.5, one, vec, vec), cells, cpu)
    assert got == [None, one.data_ptr(), vec.data_ptr(), 0, 0, 1,
                   0.5, 0.0, 0.0]
    bad = [torch.zeros(cells + 1), torch.zeros(cells, 1),
           torch.zeros(cells, dtype=torch.float64),
           torch.zeros(cells, device="meta")]
    for x in bad:
        with pytest.raises(ValueError, match="co_over"):
            ops.coeff_args(ObjectiveCoeffs(1.0, x, 1.0, 1.0), cells, cpu)


def test_cuda_kernel_matches_plain_version():
    """The hand-written kernel on the card at every kernel case of
    chip_smoke.py: bitwise equal to the plain version on the CPU, with
    per-cell tensor, float and one-value coefficients, and at the OFFSET
    cases on rows one float past a 16-byte boundary; one launch a call,
    tallied by shape (needs a CUDA card and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    def offset(x):
        buf = torch.empty(x.numel() + 1, device="cuda")
        y = buf[1:].view(x.shape)
        y.copy_(x)
        assert y.data_ptr() % 16 == 4
        return y
    for cells, n in PATH_SHAPES:
        hist, coeffs, amort = _path_inputs(cells, n, 1000 * cells + n)
        forms = ["tensors", "floats", "one_value"]
        if (cells, n) in OFFSET_SHAPES:
            forms.append("offset")
        for form in forms:
            co = coeffs
            if form == "floats":
                co = ObjectiveCoeffs(*(float(x[0]) for x in coeffs))
            elif form == "one_value":
                co = ObjectiveCoeffs(*(x[0] for x in coeffs))
            want = expected_objective_ref(hist, co, amort)
            co_cuda = ObjectiveCoeffs(*(x.cuda() if torch.is_tensor(x) else x
                                        for x in co))
            move = offset if form == "offset" else torch.Tensor.cuda
            before = ops.expected_objective.launches
            shape_before = ops.expected_objective.shapes[(cells, n)]
            got = ops.expected_objective(move(hist), co_cuda,
                                         move(amort)).cpu()
            assert ops.expected_objective.launches == before + 1
            assert ops.expected_objective.shapes[(cells, n)] == \
                shape_before + 1
            np.testing.assert_array_equal(
                got.numpy().view(np.int32), want.numpy().view(np.int32),
                err_msg=f"{cells}x{n} {form}")


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
