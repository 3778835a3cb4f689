"""Port VLM family (internvl2-76b) vs the reference on the CPU.

The reference (`repro.models`) runs as tests/test_models.py runs it, the
port (`repro_torch.models`) with ``device="cpu"``, on the smoke config
(2 layers, d_head 16, 8 patches). The reference's weights are carried
across with `repro_torch.interop.model_params`; tokens and patch
embeddings are drawn with numpy from a seed and fed to both. Tolerances
as in tests/test_torch_models.py: logits 1e-4 in float32 (sums in
another order), cache leaves 1e-5, and bfloat16 logits within 1 % of
their largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import Model, build_model

KEY = jax.random.PRNGKey(7)
ARCH = "internvl2-76b"
TOL32 = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(dtype="float32"):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    rm = ref_build(ref_config(ARCH, "smoke").replace(dtype=jdt))
    params = rm.init(KEY)
    cfg = get_config(ARCH, "smoke").replace(dtype=tdt)
    m = Model(cfg, "cpu")
    m.load_state_dict(interop.model_params(_np(params), cfg, "cpu"))
    return rm, params, m


def _inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    patches = rng.standard_normal((b, cfg.n_patches, cfg.d_model)).astype(
        np.float32)
    return toks, patches


def test_model_params_are_the_state_dict():
    rm, params, m = _pair()
    carried = interop.model_params(_np(params), m.cfg, "cpu")
    assert {k: tuple(v.shape) for k, v in carried.items()} == {
        k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert len(m.layers) == 2


def test_forward_with_the_patch_prefix_matches_reference_float32():
    """The patches prepended to the tokens; only the tokens' logits come
    out."""
    rm, params, m = _pair()
    toks, patches = _inputs(rm.cfg, 2, 10, 1)
    want, _ = rm.forward(params, jnp.asarray(toks),
                         frontend=jnp.asarray(patches))
    got, aux = m.forward(torch.from_numpy(toks), torch.from_numpy(patches))
    assert got.shape == (2, 10, rm.cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL32,
                               atol=TOL32)
    assert float(aux) == 0.0


def test_forward_matches_reference_bfloat16():
    rm, params, m = _pair("bfloat16")
    toks, patches = _inputs(rm.cfg, 2, 8, 2)
    want, _ = rm.forward(params, jnp.asarray(toks),
                         frontend=jnp.asarray(patches))
    got, _ = m.forward(torch.from_numpy(toks), torch.from_numpy(patches))
    valid = slice(0, rm.cfg.vocab_size)
    want = np.asarray(want, np.float32)[..., valid]
    np.testing.assert_allclose(got.numpy()[..., valid], want, rtol=0,
                               atol=0.01 * np.abs(want).max())


def test_prefill_with_patches_and_decode_match_reference():
    """prefill (8 patches through decode_step(embeds=), then 6 tokens) and
    4 decode steps: the logits at 1e-4, the cache at 1e-5 and length =
    patches + tokens; then a step from the reference's cache, carried."""
    rm, params, m = _pair()
    toks, patches = _inputs(rm.cfg, 2, 10, 3)
    n = rm.cfg.n_patches
    rc, want = rm.prefill(params, {"tokens": jnp.asarray(toks[:, :6]),
                                   "frontend": jnp.asarray(patches)},
                          rm.init_cache(2, n + 12))
    pc = m.init_cache(2, n + 12)
    got = m.prefill({"tokens": torch.from_numpy(toks[:, :6]),
                     "frontend": torch.from_numpy(patches)}, pc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL32,
                               atol=TOL32)
    assert pc["length"].tolist() == [n + 6, n + 6]
    for t in range(6, 10):
        rc, want = rm.decode_step(params, jnp.asarray(toks[:, t:t + 1]), rc)
        got = m.decode_step(torch.from_numpy(toks[:, t:t + 1]), pc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL32, atol=TOL32)
    np.testing.assert_array_equal(pc["length"].numpy(),
                                  np.asarray(rc["length"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(pc["kv"][name].numpy(),
                                   np.asarray(rc["kv"][name]), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    carried = interop.model_cache(_np(rc), "cpu")
    _, want = rm.decode_step(params, jnp.asarray(toks[:, :1]), rc)
    got = m.decode_step(torch.from_numpy(toks[:, :1]), carried)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL32,
                               atol=TOL32)


def test_decode_step_with_embeds():
    """One patch fed as ``embeds`` (tokens None) on a partly filled cache:
    its logits, the K/V row it writes and the length it advances."""
    rm, params, m = _pair()
    toks, patches = _inputs(rm.cfg, 2, 3, 4)
    rc, _ = rm.prefill(params, {"tokens": jnp.asarray(toks)},
                       rm.init_cache(2, 8))
    pc = interop.model_cache(_np(rc), "cpu")
    emb = patches[:, :1]
    rc, want = rm.decode_step(params, None, rc, embeds=jnp.asarray(emb))
    got = m.decode_step(None, pc, embeds=torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL32,
                               atol=TOL32)
    assert pc["length"].tolist() == [4, 4]
    for name in ("k", "v"):
        np.testing.assert_allclose(pc["kv"][name].numpy(),
                                   np.asarray(rc["kv"][name]), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_port_prefill_matches_its_forward():
    """Prefill through decode_step, patches first, reproduces the port's
    own teacher-forced logits (the reference's
    test_decode_matches_forward)."""
    cfg = get_config(ARCH, "smoke").replace(dtype=torch.float32)
    m = build_model(cfg, seed=3, device="cpu")
    toks, patches = (torch.from_numpy(a) for a in _inputs(cfg, 2, 12, 5))
    want, _ = m.forward(toks, patches)
    cache = m.init_cache(2, cfg.n_patches + 16)
    last = m.prefill({"tokens": toks, "frontend": patches}, cache)
    torch.testing.assert_close(last, want[:, -1], rtol=1e-3, atol=1e-3)
    assert cache["length"].tolist() == [cfg.n_patches + 12] * 2


def test_full_config_builds_on_meta_shapes():
    """internvl2-76b at full width: 80 layers of 64 query heads on 8 KV
    heads of 128; every leaf of the reference's pytree and the same
    parameter count; and the cut to 2 layers that runs on the card."""
    cfg = get_config(ARCH, "full")
    m = Model(cfg, "meta")
    ref = jax.eval_shape(ref_build(ref_config(ARCH, "full")).init, KEY)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        keys = [k.key for k in path]
        if keys[0] == "layers":
            for i in range(leaf.shape[0]):
                want[".".join([keys[0], str(i), *keys[1:]])] = leaf.shape[1:]
        else:
            want[".".join(keys)] = leaf.shape
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == want
    n_ref = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(ref))
    assert sum(p.numel() for p in m.parameters()) == n_ref
    cut = Model(cfg.replace(n_layers=2), "meta")
    assert sum(p.numel() for p in cut.parameters()) == 2_764_087_296
    cache = cut.init_cache(8, 448, device="meta")
    assert tuple(cache["kv"]["k"].shape) == (2, 8, 448, 8, 128)
