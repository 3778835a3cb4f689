"""Port multi-head latent attention (`repro_torch.models.mla`) and the
rotary embedding's partial and head-less forms vs the reference
(`repro.models.mla`, `repro.models.layers.rope`) on the CPU, at
deepseek-v3-671b's smoke width (4 heads, q_lora 32, kv_lora 16, nope 16,
rope 8, v 16) in float32.

The reference draws the weights with `jax.random` (one layer, no layer
axis); they are carried across by name, and the inputs are drawn with
numpy from a seed. Tolerances: 1e-4 on outputs (tests/test_torch_models
.py's TOL32), 1e-5 on the latent caches, 1e-5 on rope (float32 cos/sin
of the same float32 angle).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import layers as ref_layers
from repro.models import mla as ref_mla
from repro_torch.configs import get_config
from repro_torch.models import layers, mla

KEY = jax.random.PRNGKey(13)
TOL32 = 1e-4
ARCH = "deepseek-v3-671b"


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def block():
    rcfg = ref_config(ARCH, "smoke").replace(dtype=jnp.float32)
    cfg = get_config(ARCH, "smoke").replace(dtype=torch.float32)
    p = jax.tree.map(np.asarray, ref_mla.init_mla(KEY, rcfg))
    # norm scales away from zero, so the gains are exercised
    rng = np.random.default_rng(0)
    p = {k: (rng.standard_normal(v.shape).astype(np.float32) * 0.1
             if "norm" in k else v) for k, v in p.items()}
    mod = mla.MLA(cfg)
    mod.load_state_dict({k: _t(v) for k, v in p.items()})
    return rcfg, cfg, {k: jnp.asarray(v) for k, v in p.items()}, mod


@pytest.mark.parametrize("case", ["rotary_dim", "no_head_axis",
                                  "head_axis_batched"])
def test_rope_rotary_dim_and_head_axis(case):
    """A partial rotation (the first 8 of 16 features; the rest passed
    through), a head-less (B, S, D) tensor (MLA's k_pe) and a head axis
    with per-row positions (MLA's decode q_pe)."""
    rng = np.random.default_rng(1)
    if case == "rotary_dim":
        x, pos, kw = _x((2, 5, 3, 16), 2), np.arange(5) + 300, \
            {"rotary_dim": 8}
    elif case == "no_head_axis":
        x, pos, kw = _x((2, 5, 8), 3), rng.integers(0, 4000, (2, 5)), \
            {"has_head_axis": False}
    else:
        x, pos, kw = _x((2, 1, 4, 8), 4), rng.integers(0, 4000, (2, 1)), \
            {"has_head_axis": True}
    pos = pos.astype(np.int32)
    want = ref_layers.rope(jnp.asarray(x), jnp.asarray(pos), 1e4, **kw)
    got = layers.rope(_t(x), torch.from_numpy(pos), 1e4, **kw)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if case == "rotary_dim":
        np.testing.assert_array_equal(got.numpy()[..., 8:], x[..., 8:])


def test_latents_and_queries_match_reference(block):
    rcfg, cfg, p, mod = block
    x = _x((2, 6, cfg.d_model), 5)
    pos = np.arange(6)
    want_c, want_k = ref_mla._latents(p, jnp.asarray(x), rcfg,
                                      jnp.asarray(pos))
    got_c, got_k = mla._latents(mod, _t(x), cfg, torch.from_numpy(pos))
    np.testing.assert_allclose(got_c.detach().numpy(), np.asarray(want_c),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_k.detach().numpy(), np.asarray(want_k),
                               rtol=1e-5, atol=1e-5)
    want_n, want_p = ref_mla._queries(p, jnp.asarray(x), rcfg,
                                      jnp.asarray(pos))
    got_n, got_p = mla._queries(mod, _t(x), cfg, torch.from_numpy(pos))
    assert tuple(got_p.shape) == (2, 6, cfg.n_heads, cfg.qk_rope_dim)
    np.testing.assert_allclose(got_n.detach().numpy(), np.asarray(want_n),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_p.detach().numpy(), np.asarray(want_p),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,q_block", [(9, 64), (20, 8)])
def test_mla_block_matches_reference(block, s, q_block):
    """Causal prefill through `sdpa_chunked` (q/k of dn + dr = 24, v of
    16), in one query block and across three."""
    rcfg, cfg, p, mod = block
    rcfg, cfg = rcfg.replace(q_block=q_block), cfg.replace(q_block=q_block)
    x = _x((2, s, cfg.d_model), 6)
    want = ref_mla.mla_block(p, jnp.asarray(x), rcfg)
    got = mla.mla_block(mod, _t(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL32,
                               atol=TOL32)


def test_mla_decode_over_a_prefix_matches_reference(block):
    """Eight absorbed decode steps from empty caches, ragged lengths (a row
    two tokens behind, and one at the cache's end that writes nothing):
    every output, and the caches ``ckv``/``kpe`` at the end."""
    rcfg, cfg, p, mod = block
    b, s = 3, 8
    rc = (jnp.zeros((b, s, cfg.kv_lora_rank)),
          jnp.zeros((b, s, cfg.qk_rope_dim)))
    pc = (torch.zeros(b, s, cfg.kv_lora_rank),
          torch.zeros(b, s, cfg.qk_rope_dim))
    length = np.array([0, 2, 1], np.int32)
    for t in range(s):
        x = _x((b, 1, cfg.d_model), 10 + t)
        want, c1, c2 = ref_mla.mla_decode_step(p, jnp.asarray(x), *rc,
                                               jnp.asarray(length), rcfg)
        rc = (c1, c2)
        got = mla.mla_decode_step(mod, _t(x), *pc, torch.from_numpy(length),
                                  cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL32,
                                   atol=TOL32)
        length = np.minimum(length + 1, s + 1)
    assert length.tolist() == [8, 9, 9]
    for got_c, want_c in zip(pc, rc):
        np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                                   rtol=1e-5, atol=1e-5)
        assert got_c.abs().sum() > 0


def test_mla_decode_lanes_write_only_active_rows(block):
    """With ``lanes``, an idle row's latent cache stays bitwise as it was,
    with and without ``every_row``; ``every_row`` gives the idle row the
    output of the full-batch step (it attends with its own new entry)."""
    _, cfg, _, mod = block
    b, s = 2, 6
    caches = (_t(_x((b, s, cfg.kv_lora_rank), 20)),
              _t(_x((b, s, cfg.qk_rope_dim), 21)))
    x = _t(_x((b, 1, cfg.d_model), 22))
    length = torch.tensor([3, 2])
    lanes = torch.tensor([True, False])
    full = [c.clone() for c in caches]
    want = mla.mla_decode_step(mod, x, *full, length, cfg)
    for every_row in (False, True):
        got_c = [c.clone() for c in caches]
        got = mla.mla_decode_step(mod, x, *got_c, length, cfg, lanes=lanes,
                                  every_row=every_row)
        for g, c, f in zip(got_c, caches, full):
            assert torch.equal(g[1], c[1])           # idle row untouched
            assert torch.equal(g[0], f[0])           # active row written
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1]) == every_row
