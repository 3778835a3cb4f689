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
from repro_torch.configs.registry import get_config, list_archs
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


def _chunked_attention(q, k, v, lengths, chunk):
    """The kernel's split-sequence arithmetic in plain float32 torch: every
    chunk of ``chunk`` positions of a row gives its partial (max,
    normalizer, accumulator) over its valid positions; the chunks that
    start below the row's length are combined in chunk order (a row of
    length 0 has none and gives 0)."""
    b, hq, d = q.shape
    _, s, hkv, _ = k.shape
    qf = q.float().reshape(b, hkv, hq // hkv, d) * d ** -0.5
    n = lengths.long().clamp(0, s)
    parts = []
    for c0 in range(0, s, chunk):
        kc = k[:, c0:c0 + chunk].float().transpose(1, 2)    # (B, Hkv, P, D)
        vc = v[:, c0:c0 + chunk].float().transpose(1, 2)
        valid = (c0 + torch.arange(kc.shape[2]))[None, :] < n[:, None]
        mask = valid[:, None, None, :]
        sc = (qf @ kc.transpose(-1, -2)).masked_fill(~mask, -torch.inf)
        m = sc.amax(dim=-1)
        e = torch.where(mask, torch.exp(sc - m[..., None]), 0.0)
        parts.append((c0 < n, m, e.sum(dim=-1), e @ vc))
    mx = torch.full(qf.shape[:-1], -torch.inf)
    for ok, m, _, _ in parts:
        mx = torch.where(ok[:, None, None], torch.maximum(mx, m), mx)
    den = torch.zeros(qf.shape[:-1])
    num = torch.zeros(qf.shape)
    for ok, m, l, acc in parts:                             # chunk order
        f = torch.where(ok[:, None, None], torch.exp(m - mx), 0.0)
        den = den + l * f
        num = num + acc * f[..., None]
    return (num / den.clamp(min=1e-30)[..., None]).reshape(b, hq, d)


@pytest.mark.parametrize("s,chunk", [(37, 8), (32, 8), (8, 8), (41, 5)])
def test_split_sequence_combine_matches_reference(s, chunk):
    """The split-sequence arithmetic the CUDA kernel implements (per-chunk
    partial softmaxes, combined in chunk order), at a small chunk so that
    a row spans several: against the plain version and the JAX
    reference's, f32 within 2e-5, at lengths 0, k*P and k*P +- 1, S and
    above S."""
    shape = (10, 6, 2, 16, s)
    q, k, v, _ = _inputs(shape, s + chunk)
    lengths = np.array([0, chunk, 2 * chunk, 2 * chunk - 1, 2 * chunk + 1,
                        chunk - 1, chunk + 1, 1, s, s + 9], np.int32)
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _both((q, k, v, lengths), "float32")
    got = _chunked_attention(tq, tk, tv, tl, chunk)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    for want in (decode_attention_ref(tq, tk, tv, tl).numpy(),
                 np.asarray(jax_ref(jq, jk, jv, jl))):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_lse_is_the_float64_logsumexp(shape):
    """``return_lse``: the output is the call's without it, and the
    (B, Hq) float32 log-sum-exp is that of the scaled scores over each
    row's valid positions in float64 within 2e-5 (the float32 scores'
    rounding); -inf for a row of length 0. On meta tensors an empty
    float32 (B, Hq)."""
    q, k, v, lengths = _inputs(shape, 11, lo=0)
    lengths[0] = 0
    _, (tq, tk, tv, tl) = _both((q, k, v, lengths), "float32")
    out, lse = ops.decode_attention(tq, tk, tv, tl, return_lse=True)
    assert torch.equal(out, ops.decode_attention(tq, tk, tv, tl))
    b, hq, hkv, d, s = shape
    assert lse.dtype == torch.float32 and lse.shape == (b, hq)
    g = hq // hkv
    qd = q.astype(np.float64).reshape(b, hkv, g, d) * d ** -0.5
    want = np.full((b, hkv, g), -np.inf)
    for row in range(b):
        n = min(int(lengths[row]), s)
        if n:
            sc = np.einsum("hgd,shd->hgs", qd[row],
                           k[row, :n].astype(np.float64))
            top = sc.max(axis=-1, keepdims=True)
            want[row] = (top[..., 0]
                         + np.log(np.exp(sc - top).sum(axis=-1)))
    want = want.reshape(b, hq)
    assert np.isneginf(lse[0].numpy()).all()
    np.testing.assert_allclose(lse[1:].numpy(), want[1:], rtol=2e-5,
                               atol=2e-5)
    meta = [torch.empty(t.shape, dtype=t.dtype, device="meta")
            for t in (tq, tk, tv, tl)]
    m_out, m_lse = ops.decode_attention(*meta, return_lse=True)
    assert m_out.shape == tq.shape and m_lse.shape == (b, hq)
    assert m_lse.dtype == torch.float32 and m_lse.device.type == "meta"


def _pieces(k, v, lengths, cuts):
    """The cache cut at positions ``cuts`` (ascending, inside (0, S)) into
    pieces, each with its rows' local lengths: the valid positions that
    fall in it, clip(length - start, 0, piece length)."""
    s = k.shape[1]
    bounds = [0, *cuts, s]
    return [(k[:, a:e], v[:, a:e], (lengths - a).clamp(0, e - a))
            for a, e in zip(bounds[:-1], bounds[1:])]


@pytest.mark.parametrize("n_pieces", [2, 4, 16])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_sharded_cache_combined_by_lse_equals_unsplit(n_pieces, dtype):
    """A cache of 64 positions cut at random offsets into 2, 4 and 16
    pieces (empty ones among them: the rows' random lengths, 0 and S
    among them, leave pieces with no valid position), each piece's
    output and log-sum-exp from the wrapper, combined by
    `tensor_parallel.combine` (`reduce_pieces`), against the unsplit
    plain version and the JAX reference's, within the file's bounds; a
    row of length 0 exactly 0, and a piece with no valid position
    weighs exactly 0 (any finite output in its place changes nothing,
    bitwise)."""
    from repro_torch.distributed.tensor_parallel import combine, reduce_pieces
    shape = (6, 8, 2, 16, 64)
    s = shape[-1]
    rng = np.random.default_rng(n_pieces)
    q, k, v, _ = _inputs(shape, 3 + n_pieces)
    lengths = np.array([0, s, *rng.integers(1, s + 1, shape[0] - 2)],
                       np.int32)
    cuts = sorted(rng.choice(np.arange(1, s), n_pieces - 1, replace=False))
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _both((q, k, v, lengths), dtype)
    parts = [ops.decode_attention(tq, pk, pv, pl, return_lse=True)
             for pk, pv, pl in _pieces(tk, tv, tl, cuts)]
    outs = torch.stack([o for o, _ in parts])
    lses = torch.stack([lse for _, lse in parts])
    got = combine(outs, lses, reduce_pieces)[0]
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = DTYPES[dtype][2]
    for want in (decode_attention_ref(tq, tk, tv, tl).float().numpy(),
                 np.asarray(jax_ref(jq, jk, jv, jl), np.float32)):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    empty = torch.isneginf(lses)                          # (pieces, B, Hq)
    assert bool(empty.any())
    noise = torch.where(empty[..., None], 1e3, outs.float()).to(outs.dtype)
    assert torch.equal(combine(noise, lses, reduce_pieces)[0], got)


def _decode_head_dims(cfg) -> set[int]:
    """Head dimensions a config's decode step sends through
    `decode_attention` (the reference's `Model.decode_step`): the
    self-attention of dense, vlm, hybrid and encdec layers, of moe layers
    without MLA and of the dense layers in front of MLA ones; none for
    ssm."""
    if cfg.family in ("dense", "vlm", "hybrid", "encdec"):
        return {cfg.d_head}
    if cfg.family == "moe" and (not cfg.use_mla or cfg.n_dense_layers):
        return {cfg.d_head}
    return set()


@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_head_dims_cover_every_decoding_config(variant):
    """The kernel is compiled for the head dimension of every registry
    config that decodes through it, at full and smoke width."""
    need = {arch: _decode_head_dims(get_config(arch, variant))
            for arch in list_archs()}
    missing = {a: dims for a, dims in need.items()
               if not dims <= set(ops.HEAD_DIMS)}
    assert not missing, f"head dimensions not compiled: {missing}"
    if variant == "full":
        assert need["recurrentgemma-2b"] == {256}


def test_cuda_wrapper_rejects_other_devices():
    """A tensor on neither the CPU, the card nor the meta device (the dry
    run's: tests/test_torch_dryrun.py) is refused. Only its device is
    read, so a stand-in on "mps" serves where no such device exists."""
    class OnMps:
        device = torch.device("mps")

    k = torch.zeros(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.decode_attention(OnMps(), k, k, torch.zeros(1, dtype=torch.int32,
                                                        device="meta"))


def test_cuda_kernel_matches_plain_version():
    """On the card: the kernel against its plain version at every shape,
    the smoke configs' head dimension 16, deepseek-v3's 56 and
    recurrentgemma-2b's 256 too, caches longer than one chunk (the
    split-sequence pass and the combine), both types, ragged lengths
    including 0, 1, a multiple of the chunk and S; with ``return_lse``
    the same output and the plain version's log-sum-exp (-inf at length
    0) within 2e-5 (float32 scores in both types)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU build)")
    extra = [(4, 4, 2, 16, 128), (8, 16, 8, 128, 1024), (3, 4, 4, 56, 1500),
             (4, 10, 1, 256, 2048), (4, 10, 1, 256, 3000),
             (4, 16, 8, 128, 4096)]
    for shape in SHAPES + extra:
        q, k, v, lengths = _inputs(shape, 1)
        lengths[-1] = shape[-1]
        lengths[:-1][:3] = (0, 1, 1024)[:shape[0] - 1]
        lengths = np.minimum(lengths, shape[-1])
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
            out, lse = ops.decode_attention(*args, return_lse=True)
            _, want_lse = decode_attention_ref(*args, return_lse=True)
            assert torch.equal(out, got)
            torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-5)
