"""Port RG-LRU block (`repro_torch.models.rglru`) vs the reference
(`repro.models.rglru`) at recurrentgemma-2b's smoke width on the CPU.

The reference draws the weights with `jax.random` (one block, no layer
axis); they are carried across by name, and the inputs are made with
numpy from a seed. Tolerance 1e-5 in float32: the same arithmetic, with
matrix products summed in another order and the recurrence's scan in
another tree (the reference's `associative_scan` against the port's
doubling scan).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import rglru as ref_rglru
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import rglru

KEY = jax.random.PRNGKey(11)
TOL = 1e-5


@pytest.fixture(scope="module")
def block():
    rcfg = ref_config("recurrentgemma-2b", "smoke").replace(dtype=jnp.float32)
    cfg = get_config("recurrentgemma-2b", "smoke").replace(
        dtype=torch.float32)
    p = jax.tree.map(np.asarray, ref_rglru.init_rglru(KEY, rcfg))
    mod = rglru.RGLRU(cfg.d_model, cfg.lru_width, torch.float32)
    mod.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in p.items()})
    return rcfg, cfg, {k: jnp.asarray(v) for k, v in p.items()}, mod


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def test_conv_matches_reference(block):
    _, cfg, p, mod = block
    x = _x((2, 9, cfg.lru_width), 0)
    b = _x((cfg.lru_width,), 1)
    want = ref_rglru._conv(jnp.asarray(x), p["conv_w"], jnp.asarray(b))
    got = rglru._conv(torch.from_numpy(x), mod.conv_w, torch.from_numpy(b))
    _close(got, want, 1e-6)


def test_gates_match_reference(block):
    _, cfg, p, mod = block
    xw = _x((2, 7, cfg.lru_width), 2)
    wa, wb = ref_rglru._gates(p, jnp.asarray(xw))
    ga, gb = rglru._gates(mod, torch.from_numpy(xw))
    assert ga.dtype == gb.dtype == torch.float32
    _close(ga, wa)
    _close(gb, wb)


@pytest.mark.parametrize("seq", [1, 5, 16, 33])
def test_rglru_block_matches_reference(block, seq):
    """Sequences shorter than, equal to and past a power of two (the
    doubling scan's rounds)."""
    rcfg, cfg, p, mod = block
    x = _x((2, seq, cfg.d_model), seq)
    want = ref_rglru.rglru_block(p, jnp.asarray(x), rcfg)
    got = rglru.rglru_block(mod, torch.from_numpy(x), cfg)
    _close(got, want)


def test_rglru_decode_step_matches_reference(block):
    rcfg, cfg, p, mod = block
    w = cfg.lru_width
    x = _x((3, 1, cfg.d_model), 4)
    conv = _x((3, 3, w), 5)
    h = _x((3, w), 6)
    want = ref_rglru.rglru_decode_step(p, jnp.asarray(x), jnp.asarray(conv),
                                       jnp.asarray(h), rcfg)
    got = rglru.rglru_decode_step(mod, torch.from_numpy(x),
                                  torch.from_numpy(conv), torch.from_numpy(h),
                                  cfg)
    assert got[2].dtype == torch.float32
    for g, wv in zip(got, want):
        _close(g, wv)


def test_rglru_block_equals_token_by_token_decode(block):
    """The prefill block over 20 tokens equals 20 decode steps from zero
    state (the same recurrence, one token at a time)."""
    _, cfg, _, mod = block
    x = torch.from_numpy(_x((2, 20, cfg.d_model), 7))
    want = rglru.rglru_block(mod, x, cfg)
    conv = torch.zeros(2, 3, cfg.lru_width)
    h = torch.zeros(2, cfg.lru_width)
    outs = []
    for t in range(x.shape[1]):
        y, conv, h = rglru.rglru_decode_step(mod, x[:, t:t + 1], conv, h, cfg)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, dim=1), want, rtol=TOL,
                               atol=TOL)


def test_doubling_scan_equals_the_sequential_recurrence():
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (3, 37, 5)))
    b = torch.from_numpy(rng.standard_normal((3, 37, 5)))
    h, want = torch.zeros(3, 5, dtype=torch.float64), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(rglru._linear_scan(a, b),
                               torch.stack(want, dim=1), rtol=1e-13,
                               atol=1e-13)


def test_init_draws_the_reference_init():
    cfg = get_config("recurrentgemma-2b", "smoke")
    g = torch.Generator().manual_seed(0)
    mod = rglru.init_rglru(g, cfg)
    assert mod.lam.dtype == torch.float32 and bool((mod.lam == 3.0).all())
    assert mod.w_x.dtype == torch.bfloat16 and not mod.conv_b.any()
    assert mod.conv_w.shape == (4, cfg.lru_width)
    assert 0.05 < mod.conv_w.float().std().item() < 0.15
    ref = jax.tree.map(np.asarray, ref_rglru.init_rglru(
        KEY, ref_config("recurrentgemma-2b", "smoke")))
    assert set(dict(mod.named_parameters())) == set(ref)
    for name, leaf in ref.items():
        assert tuple(getattr(mod, name).shape) == leaf.shape, name


def test_interop_keeps_lam_float32():
    """A bfloat16 config's weights carried across: every leaf bfloat16
    but ``lam``, as in the reference."""
    rcfg = ref_config("recurrentgemma-2b", "smoke")
    from repro.models import build_model as ref_build
    params = jax.tree.map(np.asarray, ref_build(rcfg).init(KEY))
    sd = interop.model_params(params, get_config("recurrentgemma-2b",
                                                 "smoke"), "cpu")
    lams = [k for k in sd if k.endswith(".lam")]
    assert len(lams) == 4                       # 2 in the super-block, 2 tail
    for name, t in sd.items():
        want = torch.float32 if name.endswith(".lam") else torch.bfloat16
        assert t.dtype == want, name
