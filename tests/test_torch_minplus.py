"""Port min-plus kernel wrappers (`repro_torch.kernels.minplus.ops`) vs the
reference's Pallas kernels, which run here in interpret mode as the
reference's own kernel tests run them.

On a CPU tensor each wrapper takes its plain PyTorch version and counts
no launch; on a CUDA tensor it launches the hand-written kernel (the last
test, which needs a card and skips here). Tolerance: values and argmins
bitwise equal on integer-valued instances with non-increasing y_c, where
float32 arithmetic is exact in every formulation.
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


def test_cuda_kernels_match_plain_versions():
    """The hand-written kernels against their plain versions on the card
    (needs a CUDA card and nvcc; `chip_smoke.py` runs the same check at
    the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for rows, n in ((1, 1), (3, 8), (2, 257), (4, 1024)):
        args = tuple(x.cuda() for x in _t(*_instance(rows * n, n, rows)))
        for wrapper, plain in ((ops.minplus_step, minplus_step_ref),
                               (ops.minplus_step_structured,
                                minplus_step_structured_ref)):
            before = wrapper.launches
            got = wrapper(*args)
            assert wrapper.launches == before + 1
            want = plain(*args)
            assert torch.equal(got[0], want[0]), (wrapper.__name__, rows, n)
            assert torch.equal(got[1], want[1]), (wrapper.__name__, rows, n)
