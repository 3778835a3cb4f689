"""Port SSD block and SSM family (`repro_torch.models.ssd`, the ssm
`Model`) vs the reference (`repro.models.ssd`, `repro.models.model`) at
mamba2-2.7b's smoke width (d 64, 8 heads of 16, state 16, chunk 32) on
the CPU.

The reference draws the weights with `jax.random`; the vectors it
initializes to constants (``a_log``, ``dt_bias``, ``conv_b``, ``d_skip``,
the norms) are redrawn with numpy from a seed so the decay, the step and
the skip differ per head, and the weights are carried across by name.
Inputs are made with numpy from a seed. Tolerances, float32: 1e-5 for
the block's pieces (the same arithmetic; einsums summed in another
order), 1e-4 for the model's logits (tests/test_torch_models.py's TOL32);
the chunked scan against the step-by-step recurrence 1e-3, the
reference's own duality tolerance (tests/test_models.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro.models import ssd as ref_ssd
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import Model, build_model, ssd

ARCH = "mamba2-2.7b"
KEY = jax.random.PRNGKey(5)
TOL = 1e-5
TOL32 = 1e-4
TOL_DUAL = 1e-3


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _perturb(p: dict, seed: int) -> dict:
    """Redraw the constant-initialized vectors of an SSD parameter dict
    (stacked or not) from a numpy seed."""
    rng = np.random.default_rng(seed)
    p = dict(p)
    shape = p["a_log"].shape
    p["a_log"] = rng.uniform(-1.0, 1.5, shape).astype(np.float32)
    p["dt_bias"] = rng.uniform(-2.0, 0.5, shape).astype(np.float32)
    p["d_skip"] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
    p["conv_b"] = (rng.standard_normal(p["conv_b"].shape) * 0.1).astype(
        np.float32)
    p["out_norm"] = (rng.standard_normal(p["out_norm"].shape) * 0.1).astype(
        np.float32)
    return p


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def block():
    rcfg = ref_config(ARCH, "smoke").replace(dtype=jnp.float32)
    cfg = get_config(ARCH, "smoke").replace(dtype=torch.float32)
    p = _perturb(jax.tree.map(np.asarray, ref_ssd.init_ssd(KEY, rcfg)), 1)
    mod = ssd.SSD(cfg)
    mod.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in p.items()})
    return rcfg, cfg, {k: jnp.asarray(v) for k, v in p.items()}, mod


def test_segsum_matches_reference():
    x = _x((2, 3, 9), 0)
    want = ref_ssd._segsum(jnp.asarray(x))
    got = ssd._segsum(torch.from_numpy(x))
    assert bool(torch.isneginf(got[..., 0, 1]).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_segsum_gradient_is_finite_and_masked():
    """exp after the -inf mask: the masked entries pass no gradient (an
    exp taken first would give inf x 0 = NaN)."""
    x = torch.from_numpy(_x((2, 8), 1)).requires_grad_(True)
    torch.exp(ssd._segsum(x)).sum().backward()
    want = jax.grad(lambda v: jnp.exp(ref_ssd._segsum(v)).sum())(
        jnp.asarray(x.detach().numpy()))
    assert bool(torch.isfinite(x.grad).all())
    _close(x.grad, want)


def test_causal_conv_matches_reference(block):
    _, cfg, p, mod = block
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    xbc = _x((2, 11, conv_dim), 2)
    want = ref_ssd._causal_conv(jnp.asarray(xbc), p["conv_w"], p["conv_b"])
    got = ssd._causal_conv(torch.from_numpy(xbc), mod.conv_w, mod.conv_b)
    _close(got, want)


def test_split_proj_matches_reference(block):
    rcfg, cfg, p, mod = block
    x = _x((2, 5, cfg.d_model), 3)
    for g, w in zip(ssd._split_proj(mod, torch.from_numpy(x), cfg),
                    ref_ssd._split_proj(p, jnp.asarray(x), rcfg)):
        _close(g, w)


@pytest.mark.parametrize("seq", [32, 96])
def test_ssd_scan_matches_reference(block, seq):
    """One chunk and three chunks (two inter-chunk steps): y and the final
    state."""
    _, cfg, _, _ = block
    h, hp, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    xh = _x((2, seq, h, hp), 4)
    dt = np.abs(_x((2, seq, h), 5, 0.3)) + 0.01
    a = -np.exp(_x((h,), 6, 0.5))
    b_, c_ = _x((2, seq, n), 7), _x((2, seq, n), 8)
    want = ref_ssd.ssd_scan(*map(jnp.asarray, (xh, dt, a, b_, c_)),
                            cfg.ssd_chunk)
    got = ssd.ssd_scan(*map(torch.from_numpy, (xh, dt, a, b_, c_)),
                       cfg.ssd_chunk)
    assert got[1].dtype == torch.float32
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("seq", [1, 20, 32, 45, 70])
def test_ssd_block_matches_reference(block, seq):
    """Sequences inside one chunk, equal to it, and past it by a padded
    remainder (zero padding to a multiple of the chunk)."""
    rcfg, cfg, p, mod = block
    x = _x((2, seq, cfg.d_model), seq)
    want = ref_ssd.ssd_block(p, jnp.asarray(x), rcfg)
    got = ssd.ssd_block(mod, torch.from_numpy(x), cfg)
    _close(got, want)


def test_ssd_decode_step_matches_reference_from_a_carried_cache(block):
    rcfg, cfg, p, mod = block
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    x = _x((3, 1, cfg.d_model), 9)
    conv = _x((3, cfg.ssm_conv - 1, conv_dim), 10)
    state = _x((3, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state), 11)
    want = ref_ssd.ssd_decode_step(p, *map(jnp.asarray, (x, conv, state)),
                                   rcfg)
    got = ssd.ssd_decode_step(mod, *map(torch.from_numpy, (x, conv, state)),
                              cfg)
    assert got[2].dtype == torch.float32
    for g, w in zip(got, want):
        _close(g, w)


def test_ssd_block_equals_token_by_token_decode(block):
    """The chunked block over 45 tokens equals 45 decode steps from zero
    state (the duality, one block)."""
    _, cfg, _, mod = block
    x = torch.from_numpy(_x((2, 45, cfg.d_model), 12))
    want = ssd.ssd_block(mod, x, cfg)
    conv = torch.zeros(2, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)
    state = torch.zeros(2, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state)
    outs = []
    for t in range(x.shape[1]):
        y, conv, state = ssd.ssd_decode_step(mod, x[:, t:t + 1], conv, state,
                                             cfg)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, dim=1), want, rtol=TOL,
                               atol=TOL)


def test_ssd_block_gradients_match_reference(block):
    """d(sum of squares of the block's output)/d(every weight) against
    `jax.grad`, through the padded chunked scan."""
    rcfg, cfg, p, mod = block
    x = _x((2, 45, cfg.d_model), 13)
    want = jax.grad(lambda q: jnp.sum(jnp.square(
        ref_ssd.ssd_block(q, jnp.asarray(x), rcfg))))(p)
    for w in mod.parameters():
        w.requires_grad_(True)
    try:
        ssd.ssd_block(mod, torch.from_numpy(x), cfg).square().sum().backward()
        for name, w in mod.named_parameters():
            scale = float(np.abs(np.asarray(want[name])).max())
            np.testing.assert_allclose(w.grad.numpy(),
                                       np.asarray(want[name]),
                                       rtol=TOL32, atol=TOL32 * scale,
                                       err_msg=name)
    finally:
        for w in mod.parameters():
            w.requires_grad_(False)
            w.grad = None


# ------------------------------------------------------------ the model

@pytest.fixture(scope="module")
def models():
    rcfg = ref_config(ARCH, "smoke").replace(dtype=jnp.float32)
    rm = ref_build(rcfg)
    params = jax.tree.map(np.asarray, rm.init(KEY))
    params["layers"]["ssd"] = _perturb(params["layers"]["ssd"], 2)
    cfg = get_config(ARCH, "smoke").replace(dtype=torch.float32)
    m = Model(cfg, "cpu")
    m.load_state_dict(interop.model_params(params, cfg, "cpu"))
    return rm, jax.tree.map(jnp.asarray, params), m


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(
        np.int32)


def test_forward_matches_reference(models):
    rm, params, m = models
    toks = _tokens(2, 45, 14)
    want, _ = rm.forward(params, jnp.asarray(toks))
    got, aux = m.forward(torch.from_numpy(toks))
    assert float(aux) == 0.0
    _close(got, want, TOL32)


def test_prefill_and_decode_match_reference_with_every_cache_leaf(models):
    rm, params, m = models
    toks = _tokens(2, 12, 15)
    rcache, rlast = rm.prefill(params, {"tokens": jnp.asarray(toks)},
                               rm.init_cache(2, 16))
    cache = m.init_cache(2, 16)
    last = m.prefill({"tokens": torch.from_numpy(toks)}, cache)
    _close(last, rlast, TOL32)
    nxt = _tokens(2, 1, 16)
    for _ in range(5):
        rcache, rlog = rm.decode_step(params, jnp.asarray(nxt), rcache)
        log = m.decode_step(torch.from_numpy(nxt), cache)
        _close(log, rlog, TOL32)
    assert sorted(cache) == sorted(rcache) == ["conv", "length", "ssm"]
    assert cache["length"].tolist() == [17, 17]
    for name in ("conv", "ssm"):
        _close(cache[name], rcache[name], TOL)


def test_decode_from_a_carried_cache_matches_reference(models):
    rm, params, m = models
    rc = rm.init_cache(3, 8)
    rc = {"length": jnp.asarray([4, 0, 9], jnp.int32),
          "conv": jnp.asarray(_x(rc["conv"].shape, 17)),
          "ssm": jnp.asarray(_x(rc["ssm"].shape, 18))}
    cache = interop.model_cache(jax.tree.map(np.asarray, rc), "cpu")
    toks = _tokens(3, 1, 19)
    rc, want = rm.decode_step(params, jnp.asarray(toks), rc)
    got = m.decode_step(torch.from_numpy(toks), cache)
    _close(got, want, TOL32)
    for name in ("conv", "ssm"):
        _close(cache[name], rc[name], TOL)


def test_decode_lanes_write_only_the_active_rows(models):
    """The reference's engine steps every row and merges the old state
    back on the masked ones; the port writes only the active rows: the
    idle row's conv and ssm state stay bitwise."""
    _, _, m = models
    cache = m.init_cache(2, 8)
    m.prefill({"tokens": torch.from_numpy(_tokens(2, 3, 20))}, cache)
    before = {k: v.clone() for k, v in cache.items()}
    lanes = torch.tensor([True, False])
    m.decode_step(torch.from_numpy(_tokens(2, 1, 21)), cache, lanes=lanes)
    for name in ("conv", "ssm"):
        assert torch.equal(cache[name][:, 1], before[name][:, 1])
        assert not torch.equal(cache[name][:, 0], before[name][:, 0])
    assert cache["length"].tolist() == [4, 3]


def test_duality_forward_equals_prefill(models):
    """The reference's duality check on the port: the chunked scan of
    `forward` and the recurrence of `prefill` give the same last logits,
    at 2 chunks and a padded third (S = 69)."""
    _, _, m = models
    toks = torch.from_numpy(_tokens(2, 2 * 32 + 5, 22))
    want, _ = m.forward(toks)
    cache = m.init_cache(2, 4)
    last = m.prefill({"tokens": toks}, cache)
    torch.testing.assert_close(last, want[:, -1], rtol=TOL_DUAL,
                               atol=TOL_DUAL)


def test_decode_state_is_constant_in_max_len(models):
    """The reference's constant-state check: the cache's bytes do not
    depend on max_len, and 10 steps keep its shapes and finite logits."""
    _, _, m = models

    def nbytes(c):
        return sum(v.numel() * v.element_size() for v in c.values())

    small, large = m.init_cache(2, 4), m.init_cache(2, 8192)
    assert nbytes(small) == nbytes(large)
    shapes = {k: v.shape for k, v in small.items()}
    tok = torch.zeros((2, 1), dtype=torch.int64)
    for _ in range(10):
        logits = m.decode_step(tok, small)
    assert {k: v.shape for k, v in small.items()} == shapes
    assert bool(torch.isfinite(logits).all())


def test_bf16_build_keeps_the_ssd_vectors_float32():
    """A bf16 config: ``a_log``, ``dt_bias`` and ``d_skip`` float32, every
    other weight bf16, built by the port and carried from the
    reference's bf16 pytree."""
    cfg = get_config(ARCH, "smoke")
    m = build_model(cfg, seed=0, device="cpu")
    params = jax.tree.map(np.asarray, ref_build(ref_config(ARCH, "smoke"))
                          .init(KEY))
    carried = interop.model_params(params, cfg, "cpu")
    assert set(carried) == set(m.state_dict())
    for sd in (m.state_dict(), carried):
        for name, t in sd.items():
            f32 = name.rsplit(".", 1)[-1] in ssd.F32_LEAVES
            assert t.dtype == (torch.float32 if f32 else torch.bfloat16), name
    blk = m.layers[0].ssd
    assert not blk.a_log.any() and not blk.dt_bias.any()
    assert bool((blk.d_skip == 1).all()) and not blk.conv_b.any()
    assert 0.05 < blk.conv_w.float().std().item() < 0.15


def test_full_config_builds_on_meta_shapes():
    """mamba2-2.7b at full width: every leaf of the reference's pytree (its
    shapes, from `jax.eval_shape`), unstacked, and the cache's leaves."""
    cfg = get_config(ARCH, "full")
    m = Model(cfg, "meta")
    rm = ref_build(ref_config(ARCH, "full"))
    ref = jax.eval_shape(rm.init, KEY)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        keys = [k.key for k in path]
        if keys[0] == "layers":
            for i in range(leaf.shape[0]):
                want[".".join(["layers", str(i), *keys[1:]])] = leaf.shape[1:]
        else:
            want[".".join(keys)] = leaf.shape
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == want
    # the built pytree's size (the config's analytic count, 2703282176,
    # counts the unpadded vocabulary and no conv bias)
    assert sum(p.numel() for p in m.parameters()) == sum(
        int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(ref)) == \
        2_703_623_680
    rc = jax.eval_shape(lambda: rm.init_cache(8, 512))
    cache = m.init_cache(8, 512, device="meta")
    for name in ("conv", "ssm"):
        assert tuple(cache[name].shape) == rc[name].shape
        assert str(cache[name].dtype).removeprefix("torch.") == \
            rc[name].dtype.name
