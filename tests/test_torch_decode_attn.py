"""Port decode-attention kernel wrapper (`repro_torch.kernels.decode_attn`)
vs the reference's plain ``decode_attention_ref`` and its Pallas kernel,
which runs here in interpret mode as the reference's own kernel tests run
it.

On a CPU tensor the wrapper takes its plain PyTorch version and counts no
launch; on a CUDA tensor it launches the hand-written kernel (the last
test, which needs a card and skips here). Tolerances are the reference's
own (`tests/test_kernels.py`): 2e-5 in float32, where only the order of
the float32 sums differs, and 2e-2 in bfloat16, where the output is
rounded to bfloat16 (a relative step of 2^-8) after float32 arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.decode_attn import decode_attention_pallas
from repro.kernels.decode_attn.ref import decode_attention_ref as jax_ref
from repro_torch.kernels.decode_attn import ops
from repro_torch.kernels.decode_attn.ref import decode_attention_ref

SHAPES = [  # (B, Hq, Hkv, D, S): tests/test_kernels.py's four shapes
    (2, 8, 8, 64, 256),      # MHA
    (2, 16, 8, 64, 300),     # GQA 2:1, ragged tail
    (1, 10, 1, 128, 512),    # MQA
    (4, 6, 2, 128, 1024),    # GQA 3:1
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(shape, seed, lo=1):
    b, hq, hkv, d, s = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    lengths = rng.integers(lo, s + 1, b).astype(np.int32)
    return q, k, v, lengths


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    *xs, lengths = arrays
    return ([jnp.asarray(x, jdt) for x in xs] + [jnp.asarray(lengths)],
            [torch.from_numpy(x).to(tdt) for x in xs]
            + [torch.from_numpy(lengths)])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_version_matches_reference_and_pallas(shape, dtype):
    """The wrapper's CPU route against the reference's plain version and
    its Pallas kernel (interpret mode), with no kernel launch counted."""
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _both(_inputs(shape, sum(shape)),
                                               dtype)
    before = ops.decode_attention.launches
    got = ops.decode_attention(tq, tk, tv, tl)
    assert ops.decode_attention.launches == before
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = DTYPES[dtype][2]
    got = got.float().numpy()
    for want in (jax_ref(jq, jk, jv, jl),
                 decode_attention_pallas(jq, jk, jv, jl, block_s=128,
                                         interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_zero_length_rows_are_zero_and_long_lengths_count_as_s():
    shape = (3, 4, 2, 64, 96)
    q, k, v, _ = _inputs(shape, 5)
    s = shape[-1]
    lengths = np.array([0, s, 2 * s], np.int32)
    _, (tq, tk, tv, tl) = _both((q, k, v, lengths), "float32")
    got = decode_attention_ref(tq, tk, tv, tl)
    assert torch.isfinite(got).all()
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    at_s = decode_attention_ref(tq, tk, tv, torch.full_like(tl, s))
    assert torch.equal(got[2], at_s[2])
    want = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(lengths)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("seed", range(4))
def test_ragged_lengths_property(seed):
    """Random S in [1, 700] and lengths in [0, S] (the reference's
    test_decode_attn_ragged_property), f32 within its 1e-4."""
    rng = np.random.default_rng(100 + seed)
    s = int(rng.integers(1, 701))
    q, k, v, lengths = _inputs((3, 4, 2, 64, s), seed, lo=0)
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _both((q, k, v, lengths), "float32")
    np.testing.assert_allclose(ops.decode_attention(tq, tk, tv, tl).numpy(),
                               np.asarray(jax_ref(jq, jk, jv, jl)),
                               rtol=1e-4, atol=1e-4)


def test_cuda_wrapper_rejects_other_devices():
    q = torch.zeros(1, 2, 64, device="meta")
    k = torch.zeros(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.decode_attention(q, k, k, torch.zeros(1, dtype=torch.int32,
                                                  device="meta"))


def test_cuda_kernel_matches_plain_version():
    """On the card: the kernel against its plain version at every shape,
    the smoke configs' head dimension 16 too, both types, ragged
    lengths including 0, 1 and S."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU build)")
    for shape in SHAPES + [(4, 4, 2, 16, 128), (8, 16, 8, 128, 1024)]:
        q, k, v, lengths = _inputs(shape, 1)
        lengths[-1] = shape[-1]
        lengths[:-1][:2] = (0, 1)[:shape[0] - 1]
        for dtype in DTYPES:
            _, args = _both((q, k, v, lengths), dtype)
            args = [a.cuda() for a in args]
            before = ops.decode_attention.launches
            got = ops.decode_attention(*args)
            assert ops.decode_attention.launches == before + 1
            want = decode_attention_ref(*args)
            tol = DTYPES[dtype][2]
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
            if lengths[0] == 0:
                assert torch.equal(got[0], torch.zeros_like(got[0]))
