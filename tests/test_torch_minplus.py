"""Port min-plus kernel wrappers (`repro_torch.kernels.minplus.ops`) vs the
reference's Pallas kernels, which run here in interpret mode as the
reference's own kernel tests run them.

On a CPU tensor each wrapper takes its plain PyTorch version and counts
no launch; on a CUDA tensor it launches the hand-written kernel (the card
tests, which skip here). Tolerance: values and argmins bitwise equal on
integer-valued instances, where float32 arithmetic is exact in every
formulation; the dense-only cases (any y_c, negative coefficients, all
ties) on the dense wrapper alone. The identities the dense kernel's
two-term form rests on are checked bitwise on continuous data, and the
split and variant choices on their own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.minplus.minplus import minplus_pallas
from repro.kernels.minplus.structured import minplus_structured_pallas
from repro_torch.core import dp as pdp
from repro_torch.kernels.minplus import ops
from repro_torch.kernels.minplus.ref import (
    minplus_step_ref,
    minplus_step_structured_ref,
)


def _instance(seed, n, rows=2):
    rng = np.random.default_rng(seed)
    F = rng.integers(-1000, 1000, (rows, n)).astype(np.float32)
    mono = lambda: np.sort(rng.integers(0, 50, (rows, n)), axis=1)[:, ::-1]  # noqa: E731
    coeffs = rng.integers(0, 32, (rows, 4)).astype(np.float32)
    return (F, mono().astype(np.float32).copy(),
            mono().astype(np.float32).copy(), coeffs)


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


def _dense_instance(kind, seed, n, rows=2):
    """Integer-valued cases only the dense contract covers: "non_monotone"
    y_c in any order, "negative" coefficients (and a -0), "all_tie"
    (constant F, zero coefficients: every argmin 0)."""
    rng = np.random.default_rng(seed)
    F = rng.integers(-1000, 1000, (rows, n)).astype(np.float32)
    ycp = rng.integers(0, 50, (rows, n)).astype(np.float32)
    ycc = rng.integers(0, 50, (rows, n)).astype(np.float32)
    coeffs = rng.integers(0, 32, (rows, 4)).astype(np.float32)
    if kind == "negative":
        coeffs[0] = (-3.0, 2.0, -0.0, 5.0)
        coeffs[-1, 2] = -4.0
    elif kind == "all_tie":
        F[:] = 7.0
        coeffs[:] = 0.0
    return F, ycp, ycc, coeffs


# (B, N) of every dense launch of the Fig. 2 + 3 grid (chip_smoke.py's
# _dense_histogram: the level buckets of the three platform groups)
FIG2_DENSE_BUCKETS = (
    (2, 512), (2, 768), (2, 896), (2, 1024), (2, 1408), (2, 2816),
    (4, 1152), (4, 2176), (4, 2560), (6, 2432), (8, 256), (10, 1280),
    (12, 512), (14, 1152), (14, 2176), (16, 640), (18, 256), (18, 384),
    (38, 128), (58, 128), (120, 1))


@pytest.mark.parametrize("n", [1, 8, 100, 128, 130, 257])
def test_wrappers_match_reference_pallas_kernels(n):
    """Both wrappers, on the CPU route, bitwise equal to the reference's
    Pallas kernels (interpret mode), including non-multiples of 128."""
    F, ycp, ycc, coeffs = _instance(n * 13 + 5, n)
    before = (ops.minplus_step.launches, ops.minplus_step_structured.launches)
    dense = ops.minplus_step(*_t(F, ycp, ycc, coeffs))
    structured = ops.minplus_step_structured(*_t(F, ycp, ycc, coeffs))
    assert (ops.minplus_step.launches,
            ops.minplus_step_structured.launches) == before
    for b in range(F.shape[0]):
        args = (jnp.asarray(F[b]), jnp.asarray(ycp[b]), jnp.asarray(ycc[b]),
                jnp.asarray(coeffs[b]))
        for kernel, (v, a) in ((minplus_pallas, dense),
                               (minplus_structured_pallas, structured)):
            want_v, want_a = kernel(*args, interpret=True)
            np.testing.assert_array_equal(v[b].numpy(), np.asarray(want_v))
            np.testing.assert_array_equal(a[b].numpy(), np.asarray(want_a))


@pytest.mark.parametrize("n", [1, 64, 300])
def test_cpu_route_is_the_plain_version(n):
    F, ycp, ycc, coeffs = _t(*_instance(n, n, rows=3))
    for wrapper, plain in ((ops.minplus_step, minplus_step_ref),
                           (ops.minplus_step_structured,
                            minplus_step_structured_ref)):
        got = wrapper(F, ycp, ycc, coeffs)
        want = plain(F, ycp, ycc, coeffs)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[1].dtype == torch.int32


def test_structured_wrapper_has_no_monotonicity_fallback():
    """Like the reference kernel it requires non-increasing y_c; the plain
    version it runs on the CPU is the unchecked structured transition."""
    F, ycp, ycc, coeffs = _t(*_instance(9, 40, rows=1))
    got = ops.minplus_step_structured(F, ycp, ycc, coeffs)
    want = pdp.minplus_step_structured(F, ycp, ycc, coeffs, check=False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_other_devices_are_refused():
    F, ycp, ycc, coeffs = _t(*_instance(1, 16))
    for wrapper in (ops.minplus_step, ops.minplus_step_structured):
        with pytest.raises(ValueError, match="unsupported device"):
            wrapper(F.to("meta"), ycp.to("meta"), ycc.to("meta"), coeffs)


@pytest.mark.parametrize("kind", ["non_monotone", "negative", "all_tie"])
@pytest.mark.parametrize("n", [1, 8, 130, 257])
def test_dense_cpu_route_matches_reference_on_dense_cases(kind, n):
    """The dense wrapper, on the CPU route, bitwise equal to the
    reference's dense Pallas kernel (interpret mode) where only the dense
    contract holds."""
    F, ycp, ycc, coeffs = _dense_instance(kind, n * 7 + len(kind), n)
    v, a = ops.minplus_step(*_t(F, ycp, ycc, coeffs))
    for b in range(F.shape[0]):
        want_v, want_a = minplus_pallas(
            jnp.asarray(F[b]), jnp.asarray(ycp[b]), jnp.asarray(ycc[b]),
            jnp.asarray(coeffs[b]), interpret=True)
        np.testing.assert_array_equal(v[b].numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(a[b].numpy(), np.asarray(want_a))
    if kind == "all_tie":
        assert not a.any()


def _pairs(F, ycp, ycc, coeffs):
    """(B, N, N) operands of every (i, j) pair: d = j - i, dv = v - u."""
    n = F.shape[-1]
    i = torch.arange(n, dtype=torch.float32)[:, None]
    d = torch.arange(n, dtype=torch.float32)[None, :] - i
    dv = ycc[:, None, :] - ycp[:, :, None]
    af, df, ac, dc = (coeffs[:, k, None, None] for k in range(4))
    return d, dv, af, df, ac, dc


@pytest.mark.parametrize("seed", range(4))
def test_two_term_form_is_bitwise_the_four_term_sum(seed):
    """For coefficients with the sign bit clear and finite, F + (c_I*|j-i|
    + c_Y*|v-u|), coefficients picked by sign, is bitwise F + the plain
    version's four-term sum; and with v - u of one known sign, c_Y*|v-u|
    is ac*(v-u) or dc*(u-v). The dense kernel's two-term form and its
    fixed-sign groups rest on this. Continuous data, zero coefficients,
    equal y_c and ties included."""
    rng = np.random.default_rng(seed)
    rows, n = 3, 70
    F = rng.normal(0, 100, (rows, n)).astype(np.float32)
    F[0, ::5] = 0.0
    ycp = np.round(rng.normal(0, 20, (rows, n)), 1).astype(np.float32)
    ycc = ycp[:, rng.permutation(n)]
    coeffs = rng.uniform(0, 10, (rows, 4)).astype(np.float32)
    coeffs[1, 1] = coeffs[2, 2] = 0.0
    F, ycp, ycc, coeffs = _t(F, ycp, ycc, coeffs)
    d, dv, af, df, ac, dc = _pairs(F, ycp, ycc, coeffs)
    relu = lambda x: torch.clamp_min(x, 0.0)  # noqa: E731
    four = F[:, :, None] + (af * relu(d) + df * relu(-d) + ac * relu(dv)
                            + dc * relu(-dv))
    two = F[:, :, None] + (torch.where(d > 0, af, df) * d.abs()
                           + torch.where(dv > 0, ac, dc) * dv.abs())
    assert torch.equal(four.view(torch.int32), two.view(torch.int32))
    up = torch.where(dv >= 0, ac * dv, torch.where(dv > 0, ac, dc) * dv.abs())
    down = torch.where(dv <= 0, dc * dv.abs(),
                       torch.where(dv > 0, ac, dc) * dv.abs())
    for c_y in (up, down):
        fixed = F[:, :, None] + (torch.where(d > 0, af, df) * d.abs() + c_y)
        assert torch.equal(four.view(torch.int32), fixed.view(torch.int32))
    want_v, want_a = ops.minplus_step(F, ycp, ycc, coeffs)
    assert torch.equal(torch.amin(two, dim=1), want_v)
    assert torch.equal(torch.argmin(two, dim=1).to(torch.int32), want_a)


@pytest.mark.parametrize("rows,n", FIG2_DENSE_BUCKETS + (
    (180, 2816), (1, 1), (1, 8), (3, 257), (4, 6273)))
def test_dense_split_is_deterministic_and_covers_every_source(rows, n):
    """`dense_split` is a function of (B, N) alone, within the kernel's
    limits, its slices cover [0, N) once and in order, and every bucket of
    the Fig. 2 dense run but N = 1 gets 8 warps on each SM."""
    sp = ops.dense_split(rows, n)
    ops.dense_split.cache_clear()
    assert ops.dense_split(rows, n) == sp
    assert sp.dests in (1, 2, 4) and 1 <= sp.warps <= 32
    assert 1 <= sp.cluster <= 8 and sp.chunks >= 1
    assert sp.slice_len >= 8 and sp.slice_len % 8 == 0
    assert sp.chunks * sp.slice_len >= n
    covered = [i for lo, hi in sp.slices(n) for i in range(lo, hi)]
    assert covered == list(range(n))
    if (rows, n) in FIG2_DENSE_BUCKETS and n > 1:
        assert sp.warps_used(rows, n) >= ops.WARPS_PER_SM * ops.SMS


def test_dense_candidates_are_launchable():
    """Every candidate split covers N within the kernel's limits."""
    for rows, n in ((2, 512), (14, 2176), (120, 1), (3, 100)):
        cands = ops.dense_candidates(rows, n)
        assert ops.dense_split(rows, n) in cands
        for sp in cands:
            assert sp.chunks * sp.slice_len >= n and sp.slice_len % 8 == 0
            assert sp.warps <= 32 and sp.cluster <= 8


@pytest.mark.parametrize("n,variant", [
    (1, "shared"), (2816, "shared"), (ops.MAX_N_SHARED, "shared"),
    (ops.MAX_N_SHARED + 1, "global"), (ops.MAX_N_STRUCTURED, "global")])
def test_structured_variant_is_chosen_by_n(n, variant):
    assert ops.structured_variant(n) == variant


@pytest.mark.parametrize("n", [0, ops.MAX_N_STRUCTURED + 1])
def test_structured_variant_raises_outside_its_range(n):
    with pytest.raises(ValueError, match="levels"):
        ops.structured_variant(n)


def test_cuda_kernels_match_plain_versions():
    """The hand-written kernels against their plain versions on the card
    (needs a CUDA card and nvcc; `chip_smoke.py` runs the same check at
    the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    shapes = ((1, 1), (3, 8), (2, 257), (4, 1024), (2, ops.MAX_N_SHARED),
              (2, ops.MAX_N_SHARED + 1))
    for rows, n in shapes:
        args = tuple(x.cuda() for x in _t(*_instance(rows * n, n, rows)))
        for wrapper, plain in ((ops.minplus_step, minplus_step_ref),
                               (ops.minplus_step_structured,
                                minplus_step_structured_ref)):
            before = wrapper.launches
            got = wrapper(*args)
            assert wrapper.launches == before + 1
            want = plain(*args)
            assert torch.equal(got[0].view(torch.int32),
                               want[0].view(torch.int32)), (rows, n)
            assert torch.equal(got[1], want[1]), (wrapper.__name__, rows, n)
    # the dense-only cases and the dense run's buckets, dense kernel alone
    cases = [(kind, rows, n) for kind in ("non_monotone", "negative",
                                          "all_tie")
             for rows, n in ((2, 2816), (2, 512), (14, 2176))]
    cases += [("non_monotone", rows, n) for rows, n in FIG2_DENSE_BUCKETS]
    for kind, rows, n in cases:
        args = tuple(x.cuda() for x in _t(*_dense_instance(kind, n, n, rows)))
        got = ops.minplus_step(*args)
        want = minplus_step_ref(*args)
        assert torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32)), (kind, rows, n)
        assert torch.equal(got[1], want[1]), (kind, rows, n)
    # a contiguous (B, 4) float32 coefficient tensor goes in as it is
    args = tuple(x.cuda() for x in _t(*_instance(3, 64, 2)))
    assert ops._prepare("minplus", *args)[3] is args[3]
