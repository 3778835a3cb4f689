"""Port encoder-decoder family (whisper-base) vs the reference on the CPU.

The reference (`repro.models`) runs as tests/test_models.py runs it, the
port (`repro_torch.models`) with ``device="cpu"``, on the smoke config
(d_head 64, src_len 32). The reference's weights are carried across with
`repro_torch.interop.model_params`; tokens and frontend frames are drawn
with numpy from a seed and fed to both. Tolerances: the attention pieces
1e-5 (float32, one layer); logits 1e-4 (tests/test_torch_models.py's
TOL32: two encoder and two decoder layers, sums in another order);
cache leaves 1e-5; bfloat16 logits within 1 % of their largest magnitude,
as in test_dense_model_matches_reference_bfloat16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import attention as ref_attn
from repro.models import build_model as ref_build
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import Model, build_model
from repro_torch.models import attention as attn

KEY = jax.random.PRNGKey(7)
ARCH = "whisper-base"
TOL32 = 1e-4
TOL_ATTN = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _attention(cfg, pcfg, seed):
    """A reference attention's weights (random qk-norm scales when the
    config has qk-norm) and the port's module holding the same."""
    p = _np(ref_attn.init_attention(KEY, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.d_head, jnp.float32,
                                    qk_norm=cfg.qk_norm))
    rng = np.random.default_rng(seed)
    for name in ("q_norm", "k_norm"):
        if name in p:
            p[name] = (rng.standard_normal(cfg.d_head) * 0.3).astype(
                np.float32)
    mod = attn.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.d_head, torch.float32, qk_norm=cfg.qk_norm)
    mod.load_state_dict({k: _t(v) for k, v in p.items()})
    return {k: jnp.asarray(v) for k, v in p.items()}, mod


def _configs(qk_norm=False):
    cfg = ref_config(ARCH, "smoke").replace(dtype=jnp.float32,
                                            qk_norm=qk_norm)
    pcfg = get_config(ARCH, "smoke").replace(dtype=torch.float32,
                                             qk_norm=qk_norm)
    return cfg, pcfg


def _memory(cfg, b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.src_len, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_project_memory_kv(qk_norm):
    cfg, pcfg = _configs(qk_norm)
    p, mod = _attention(cfg, pcfg, 1)
    mem = _memory(cfg, 3, 2)
    wk, wv = ref_attn.project_memory_kv(p, jnp.asarray(mem), cfg)
    k, v = attn.project_memory_kv(mod, _t(mem), pcfg)
    assert k.shape == (3, cfg.src_len, cfg.n_kv_heads, cfg.d_head)
    np.testing.assert_allclose(k.numpy(), np.asarray(wk), rtol=TOL_ATTN,
                               atol=TOL_ATTN)
    np.testing.assert_allclose(v.numpy(), np.asarray(wv), rtol=TOL_ATTN,
                               atol=TOL_ATTN)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention_decode(qk_norm):
    """One query token against the memory K/V: every row attends to all
    src_len positions."""
    cfg, pcfg = _configs(qk_norm)
    p, mod = _attention(cfg, pcfg, 3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    mk = rng.standard_normal((3, cfg.src_len, cfg.n_kv_heads,
                              cfg.d_head)).astype(np.float32)
    mv = rng.standard_normal(mk.shape).astype(np.float32)
    want = ref_attn.cross_attention_decode(p, jnp.asarray(x), jnp.asarray(mk),
                                           jnp.asarray(mv), cfg)
    tk, tv = _t(mk), _t(mv)
    got = attn.cross_attention_decode(mod, _t(x), tk, tv, pcfg)
    assert got.shape == (3, 1, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_ATTN,
                               atol=TOL_ATTN)
    assert np.array_equal(tk.numpy(), mk) and np.array_equal(tv.numpy(), mv)


@pytest.mark.parametrize("case", ["memory", "memory_causal",
                                  "non_causal", "causal"])
def test_attention_block(case):
    """Cross-attention (K/V from a memory of another length, no rope; not
    causal unless asked), the encoder's non-causal self-attention and the
    decoder's causal one, across query blocks (q_block 4, 10 queries)."""
    cfg, pcfg = _configs(qk_norm=True)
    cfg, pcfg = cfg.replace(q_block=4), pcfg.replace(q_block=4)
    p, mod = _attention(cfg, pcfg, 5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    mem = _memory(cfg, 2, 7)
    kw = {"memory": {"memory": mem}, "memory_causal": {"memory": mem,
                                                       "causal": True},
          "non_causal": {"causal": False}, "causal": {}}[case]
    want = ref_attn.attention_block(
        p, jnp.asarray(x), cfg,
        **{k: (jnp.asarray(v) if k == "memory" else v)
           for k, v in kw.items()})
    got = attn.attention_block(
        mod, _t(x), pcfg,
        **{k: (_t(v) if k == "memory" else v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_ATTN,
                               atol=TOL_ATTN)


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
    return toks, _memory(cfg, b, seed + 1)


def test_model_params_are_the_state_dict():
    rm, params, m = _pair()
    carried = interop.model_params(_np(params), m.cfg, "cpu")
    want = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in carried.items()} == want
    assert set(m.decoder[0].state_dict()) == {
        "ln1", "self_attn.wq", "self_attn.wk", "self_attn.wv",
        "self_attn.wo", "ln_x", "cross_attn.wq", "cross_attn.wk",
        "cross_attn.wv", "cross_attn.wo", "ln2", "mlp.w_in", "mlp.w_down"}
    assert len(m.encoder) == 2 and len(m.decoder) == 2


def test_forward_matches_reference_float32():
    rm, params, m = _pair()
    toks, fe = _inputs(rm.cfg, 2, 10, 8)
    want, _ = rm.forward(params, jnp.asarray(toks), frontend=jnp.asarray(fe))
    got, aux = m.forward(torch.from_numpy(toks), torch.from_numpy(fe))
    assert got.shape == (2, 10, rm.cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL32,
                               atol=TOL32)
    assert float(aux) == 0.0


def test_forward_matches_reference_bfloat16():
    """bfloat16 weights and frames: logits within 1 % of their largest
    magnitude (each framework rounds the products of every layer to
    bfloat16 at its own places)."""
    rm, params, m = _pair("bfloat16")
    toks, fe = _inputs(rm.cfg, 2, 8, 9)
    want, _ = rm.forward(params, jnp.asarray(toks), frontend=jnp.asarray(fe))
    got, _ = m.forward(torch.from_numpy(toks), torch.from_numpy(fe))
    valid = slice(0, rm.cfg.vocab_size)
    want = np.asarray(want, np.float32)[..., valid]
    np.testing.assert_allclose(got.numpy()[..., valid], want, rtol=0,
                               atol=0.01 * np.abs(want).max())


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def test_prefill_and_decode_match_reference():
    """prefill (encoder, memory K/V, 6 tokens) and 4 decode steps: the
    logits at 1e-4 and every cache leaf (kv, mem_k, mem_v, length) at
    1e-5, in the reference's layout; then a step from the reference's own
    cache, carried across by `interop.model_cache`."""
    rm, params, m = _pair()
    toks, fe = _inputs(rm.cfg, 2, 10, 10)
    batch = {"tokens": toks[:, :6], "frontend": fe}
    rc, want = rm.prefill(params, {k: jnp.asarray(v)
                                   for k, v in batch.items()},
                          rm.init_cache(2, 16))
    pc = m.init_cache(2, 16)
    got = m.prefill({k: torch.from_numpy(v) for k, v in batch.items()}, pc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL32,
                               atol=TOL32)
    for t in range(6, 10):
        rc, want = rm.decode_step(params, jnp.asarray(toks[:, t:t + 1]), rc)
        got = m.decode_step(torch.from_numpy(toks[:, t:t + 1]), pc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL32, atol=TOL32)
    ref_leaves = dict(_leaves(_np(rc)))
    port_leaves = dict(_leaves(pc))
    assert sorted(port_leaves) == sorted(ref_leaves) == [
        "kv.k", "kv.v", "length", "mem_k", "mem_v"]
    for name, leaf in port_leaves.items():
        assert tuple(leaf.shape) == ref_leaves[name].shape, name
        np.testing.assert_allclose(leaf.numpy(), ref_leaves[name],
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    assert pc["length"].tolist() == [10, 10]
    carried = interop.model_cache(_np(rc), "cpu")
    assert carried["mem_k"].dtype == torch.float32
    _, want = rm.decode_step(params, jnp.asarray(toks[:, :1]), rc)
    got = m.decode_step(torch.from_numpy(toks[:, :1]), carried)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL32,
                               atol=TOL32)


def test_port_prefill_matches_its_forward():
    """Prefill through decode_step reproduces the port's own
    teacher-forced logits (the reference's test_decode_matches_forward)."""
    cfg = get_config(ARCH, "smoke").replace(dtype=torch.float32)
    m = build_model(cfg, seed=3, device="cpu")
    toks, fe = (torch.from_numpy(a) for a in _inputs(cfg, 2, 12, 11))
    want, _ = m.forward(toks, fe)
    cache = m.init_cache(2, 16)
    last = m.prefill({"tokens": toks, "frontend": fe}, cache)
    torch.testing.assert_close(last, want[:, -1], rtol=1e-3, atol=1e-3)
    assert cache["length"].tolist() == [12, 12]


def test_decode_moves_only_active_lanes_and_never_the_memory():
    cfg = get_config(ARCH, "smoke").replace(dtype=torch.float32)
    m = build_model(cfg, seed=5, device="cpu")
    toks, fe = (torch.from_numpy(a) for a in _inputs(cfg, 2, 3, 12))
    cache = m.init_cache(2, 16)
    m.prefill({"tokens": toks, "frontend": fe}, cache)
    before = {name: leaf.clone() for name, leaf in _leaves(cache)}
    assert before["mem_k"].abs().sum() > 0
    lanes = torch.tensor([True, False])
    for tok in (2, 6, 5):
        m.decode_step(torch.tensor([[tok], [7]]), cache, lanes=lanes)
    after = dict(_leaves(cache))
    for name in ("mem_k", "mem_v"):
        assert torch.equal(after[name], before[name]), name
    for name in ("kv.k", "kv.v"):
        assert torch.equal(after[name][:, 1], before[name][:, 1]), name
        assert not torch.equal(after[name][:, 0], before[name][:, 0]), name
    assert cache["length"].tolist() == [6, 3]


def test_full_config_builds_on_meta_shapes():
    """whisper-base at full width: 6 encoder and 6 decoder layers of 8
    heads of 64; every leaf of the reference's pytree (its shapes, from
    `jax.eval_shape`) and no other, and the same parameter count."""
    cfg = get_config(ARCH, "full")
    m = Model(cfg, "meta")
    ref = jax.eval_shape(ref_build(ref_config(ARCH, "full")).init, KEY)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        keys = [k.key for k in path]
        if keys[0] in ("encoder", "decoder"):
            for i in range(leaf.shape[0]):
                want[".".join([keys[0], str(i), *keys[1:]])] = leaf.shape[1:]
        else:
            want[".".join(keys)] = leaf.shape
    got = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert got == want
    n_ref = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(ref))
    assert sum(p.numel() for p in m.parameters()) == n_ref == 70_794_752
    cache = m.init_cache(8, 448, device="meta")
    assert tuple(cache["kv"]["k"].shape) == (6, 8, 448, 8, 64)
    assert tuple(cache["mem_k"].shape) == (6, 8, 1536, 8, 64)
