"""Port model zoo (`repro_torch.models`, `repro_torch.configs`) vs the
reference (`repro.models`, `repro.configs`) at smoke widths on the CPU.

The reference draws its weights with `jax.random`; they are carried
across with `repro_torch.interop.model_params`, and every other input is
made with numpy from a seed. Tolerances: 1e-4 in float32 (the two
frameworks sum products in another order; logits here are O(50), so
this is ~2e-6 relative), and, in bfloat16, a bound stated per test in
units of the logits' scale (each framework rounds intermediate products
to bfloat16 at its own places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import list_archs
from repro.configs import registry as ref_registry
from repro.models import attention as ref_attn
from repro.models import build_model as ref_build
from repro.models import layers as ref_layers
from repro_torch import interop
from repro_torch.configs import get_config, registry
from repro_torch.models import Model, build_model
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.layers import MLP

KEY = jax.random.PRNGKey(7)
TOL32 = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


@pytest.mark.parametrize("arch", list_archs())
def test_config_param_count_and_padded_vocab(arch):
    ref, port = ref_config(arch, "full"), get_config(arch, "full")
    assert port.param_count() == ref.param_count()
    assert port.param_count(active_only=True) == ref.param_count(
        active_only=True)
    assert port.padded_vocab == ref.padded_vocab
    assert port.dtype == torch.bfloat16
    assert get_config(arch, "smoke").name == ref_config(arch, "smoke").name


def test_registry_shapes_and_cells():
    assert registry.SHAPES == ref_registry.SHAPES
    assert registry.list_archs() == ref_registry.list_archs()
    for skipped in (False, True):
        assert registry.cells(skipped) == ref_registry.cells(skipped)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-2")


def test_qwen3_full_width_shape_and_size():
    cfg = get_config("qwen3-0.6b")
    assert cfg.param_count() == 596_182_016
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff, cfg.padded_vocab) == (28, 1024, 16, 8, 128,
                                                        3072, 152064)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = ref_layers.rms_norm(jnp.asarray(x, jdt), jnp.asarray(scale, jdt))
    got = layers.rms_norm(_t(x, tdt), _t(scale, tdt))
    assert got.dtype == tdt
    # bfloat16: the same float32 arithmetic rounded once at the end
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("batched", [False, True])
def test_rope(batched):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = (rng.integers(0, 5000, (2, 6)) if batched
           else np.arange(6) + 1000).astype(np.int32)
    want = ref_layers.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = layers.rope(_t(x), torch.from_numpy(pos), 1e6)
    # angles up to 5000 rad: float32 cos/sin of the same float32 angle
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu", "relu2"])
def test_mlp(mlp_type):
    rng = np.random.default_rng(2)
    p = _np(ref_layers.init_mlp(KEY, 32, 48, mlp_type, jnp.float32))
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    want = ref_layers.mlp(p, jnp.asarray(x), mlp_type)
    m = MLP(32, 48, mlp_type, torch.float32)
    m.load_state_dict({k: _t(v) for k, v in p.items()})
    got = layers.mlp(m, _t(x), mlp_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL32,
                               atol=TOL32)


def test_unembed_masks_the_padded_vocabulary():
    rng = np.random.default_rng(3)
    table = rng.standard_normal((512, 32)).astype(np.float32)
    x = rng.standard_normal((2, 32)).astype(np.float32)
    want = ref_layers.unembed(jnp.asarray(table), jnp.asarray(x), 500)
    got = layers.unembed(_t(table), _t(x), 500)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL32,
                               atol=TOL32)
    assert (got[:, 500:] == -1e30).all()


@pytest.mark.parametrize("causal,q_block", [(True, 4), (True, 8),
                                            (False, 16)])
def test_sdpa_chunked(causal, q_block):
    """Query blocks smaller than the sequence, a ragged last block, GQA."""
    _sdpa_case(causal, 0, q_block)


@pytest.mark.parametrize("causal,window,q_block", [(True, 3, 4),
                                                   (True, 8, 16),
                                                   (False, 5, 8)])
def test_sdpa_chunked_sliding_window(causal, window, q_block):
    """Sliding windows shorter than the sequence (and, non-causal, a band
    on both sides), across query blocks."""
    _sdpa_case(causal, window, q_block)


def _sdpa_case(causal, window, q_block):
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 11, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 11, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 11, 2, 16)).astype(np.float32)
    want = ref_attn.sdpa_chunked(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 window=window, q_block=q_block)
    got = attn.sdpa_chunked(_t(q), _t(k), _t(v), causal=causal,
                            window=window, q_block=q_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("causal,window,q_block", [(True, 0, 2),
                                                   (True, 4, 4),
                                                   (False, 3, 8)])
def test_sdpa_chunked_positions(causal, window, q_block):
    """``q_positions`` (B, Sq), a row's queries at global positions of
    their own (as the tensor-parallel prefill's context rule passes
    them), and ``kv_positions`` (Skv,) set the causal and window masks
    as the reference's keywords do; a ragged last query block."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 11, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 11, 2, 16)).astype(np.float32)
    q_pos = np.array([[3, 4, 5, 6, 7], [7, 8, 9, 10, 11]], dtype=np.int32)
    kv_pos = np.arange(1, 12, dtype=np.int32)
    want = ref_attn.sdpa_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_block=q_block, q_positions=jnp.asarray(q_pos),
        kv_positions=jnp.asarray(kv_pos))
    got = attn.sdpa_chunked(_t(q), _t(k), _t(v), causal=causal,
                            window=window, q_block=q_block,
                            q_positions=torch.from_numpy(q_pos),
                            kv_positions=torch.from_numpy(kv_pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the default positions are 0.. Sq - 1 and 0.. Skv - 1
    plain = attn.sdpa_chunked(_t(q), _t(k), _t(v), causal=causal,
                              window=window, q_block=q_block)
    assert torch.equal(plain, attn.sdpa_chunked(
        _t(q), _t(k), _t(v), causal=causal, window=window, q_block=q_block,
        q_positions=torch.arange(5), kv_positions=torch.arange(11)))


@pytest.mark.parametrize("ring", [False, True])
def test_decode_attention_step_from_carried_weights(ring):
    """One decode step against a partly filled cache: output and the
    written cache equal the reference's; ring=True wraps past the end."""
    cfg = ref_config("qwen3-0.6b", "smoke").replace(dtype=jnp.float32)
    pcfg = get_config("qwen3-0.6b", "smoke").replace(dtype=torch.float32)
    p = _np(ref_attn.init_attention(KEY, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.d_head, jnp.float32,
                                    qk_norm=True))
    rng = np.random.default_rng(4)
    b, s = 3, 8
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((b, s, cfg.n_kv_heads, cfg.d_head)).astype(
        np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    # ring: lengths past the window wrap; plain: a full row writes nothing
    length = np.array([0, 5, 11 if ring else s], np.int32)
    out, nk, nv = ref_attn.decode_attention_step(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(length), cfg, ring=ring)
    mod = attn.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                         torch.float32, qk_norm=True)
    mod.load_state_dict({k: _t(v) for k, v in p.items()})
    tk, tv = _t(ck), _t(cv)
    got = attn.decode_attention_step(mod, _t(x), tk, tv,
                                     torch.from_numpy(length), pcfg,
                                     ring=ring)              # writes tk, tv
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=TOL32,
                               atol=TOL32)
    np.testing.assert_allclose(tk.numpy(), np.asarray(nk), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(nv), rtol=1e-6,
                               atol=1e-6)


def test_init_attention_draws_fan_in_scaled_weights():
    g = torch.Generator().manual_seed(0)
    a = attn.init_attention(g, 64, 4, 2, 16, torch.bfloat16, qk_norm=True)
    assert a.wq.shape == (64, 64) and a.wk.shape == (64, 32)
    assert a.wo.shape == (64, 64) and a.wq.dtype == torch.bfloat16
    assert not a.q_norm.any() and not a.k_norm.any()
    for w in (a.wq, a.wk, a.wv, a.wo):
        bound = 2.0 * w.shape[0] ** -0.5          # truncated at 2 sigma
        assert 0 < w.float().abs().max() <= bound * (1 + 2 ** -8)
        assert abs(w.float().std().item() - 0.88 * w.shape[0] ** -0.5) \
            < 0.1 * w.shape[0] ** -0.5            # std of N(0,1) cut at 2


def _pair(arch, dtype="float32"):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    rcfg = ref_config(arch, "smoke").replace(dtype=jdt)
    cfg = get_config(arch, "smoke").replace(dtype=tdt)
    rm = ref_build(rcfg)
    params = rm.init(KEY)
    m = Model(cfg, "cpu")
    m.load_state_dict(interop.model_params(_np(params), cfg, "cpu"))
    return rm, params, m


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-3-2b"])
def test_dense_model_matches_reference_float32(arch):
    """forward, prefill and further decode steps from carried weights."""
    rm, params, m = _pair(arch)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, rm.cfg.vocab_size, (2, 10)).astype(np.int32)
    want_f, _ = rm.forward(params, jnp.asarray(toks))
    got_f, aux = m.forward(torch.from_numpy(toks))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=TOL32,
                               atol=TOL32)
    assert float(aux) == 0.0
    rc = rm.init_cache(2, 16)
    pc = m.init_cache(2, 16)
    rc, want = rm.prefill(params, {"tokens": jnp.asarray(toks[:, :6])}, rc)
    got = m.prefill({"tokens": torch.from_numpy(toks[:, :6])}, pc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL32,
                               atol=TOL32)
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
                                   atol=1e-5)
    # a step from the reference's own cache, carried across
    carried = interop.model_cache(_np(rc), "cpu")
    assert carried["length"].dtype == torch.int32
    nxt = toks[:, :1]
    _, want = rm.decode_step(params, jnp.asarray(nxt), rc)
    got = m.decode_step(torch.from_numpy(nxt), carried)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL32,
                               atol=TOL32)


def test_dense_model_matches_reference_bfloat16():
    """bfloat16 weights and cache: logits within 1 % of their largest
    magnitude (0.28 % seen). The frameworks round the products of every
    layer to bfloat16 at other places (a relative step of 2^-8 each), and
    two layers and eight positions compound them."""
    rm, params, m = _pair("qwen3-0.6b", "bfloat16")
    rng = np.random.default_rng(6)
    toks = rng.integers(0, rm.cfg.vocab_size, (2, 8)).astype(np.int32)
    rc, want = rm.prefill(params, {"tokens": jnp.asarray(toks)},
                          rm.init_cache(2, 12))
    pc = m.init_cache(2, 12)
    got = m.prefill({"tokens": torch.from_numpy(toks)}, pc)
    want = np.asarray(want)
    valid = slice(0, rm.cfg.vocab_size)
    scale = np.abs(want[:, valid]).max()
    np.testing.assert_allclose(got.numpy()[:, valid], want[:, valid],
                               rtol=0, atol=0.01 * scale)
    assert pc["kv"]["k"].dtype == torch.bfloat16


def test_port_decode_matches_its_forward():
    """Prefill through decode_step reproduces the port's own
    teacher-forced logits (the reference's test_decode_matches_forward)."""
    cfg = get_config("qwen3-0.6b", "smoke").replace(dtype=torch.float32)
    m = build_model(cfg, seed=3, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 12)))
    want, _ = m.forward(toks)
    cache = m.init_cache(2, 16)
    last = m.prefill({"tokens": toks}, cache)
    torch.testing.assert_close(last, want[:, -1], rtol=1e-3, atol=1e-3)
    assert cache["length"].tolist() == [12, 12]


def test_build_model_is_seeded_and_draws_the_reference_init():
    cfg = get_config("granite-3-2b", "smoke")
    a = build_model(cfg, seed=1, device="cpu")
    b = build_model(cfg, seed=1, device="cpu")
    c = build_model(cfg, seed=2, device="cpu")
    for (name, x), y, z in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(x, y), name
        assert x.dtype == torch.bfloat16
        if "ln" in name or "norm" in name:
            assert not x.any(), name                # norm scales start at 0
        else:
            assert not torch.equal(x, z), name
            fan_in = 1 if name == "embed" else x.shape[0]
            assert x.float().abs().max() <= 2.0 * fan_in ** -0.5 + 1e-2
    assert set(a.state_dict()) == set(interop.model_params(
        _np(ref_build(ref_config("granite-3-2b", "smoke")).init(KEY)), cfg,
        "cpu"))


def test_ssm_family_builds_and_decodes():
    """The ssm family, ported: the smoke config builds in its own bfloat16
    (the SSD's a_log, dt_bias and d_skip float32), and prefill + a decode
    step give finite logits and advance every lane
    (tests/test_torch_ssd.py holds it against the reference)."""
    cfg = get_config("mamba2-2.7b", "smoke")
    m = Model(cfg, "cpu").init(0)
    assert m.layers[0].ssd.a_log.dtype == torch.float32
    assert m.embed.dtype == torch.bfloat16
    cache = m.init_cache(2, 8)
    assert cache["ssm"].dtype == torch.float32
    m.prefill({"tokens": torch.tensor([[3, 1, 4], [1, 5, 9]])}, cache)
    logits = m.decode_step(torch.tensor([[2], [6]]), cache)
    assert logits.shape == (2, cfg.padded_vocab)
    assert torch.isfinite(logits[:, :cfg.vocab_size]).all()
    assert cache["length"].tolist() == [4, 4]


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v3-671b"])
def test_moe_family_builds_and_decodes(arch):
    """The moe family, ported: the smoke config builds in its own
    bfloat16 (router float32), and prefill + a decode step give finite
    logits and advance every lane (tests/test_torch_moe.py holds it
    against the reference)."""
    cfg = get_config(arch, "smoke")
    m = Model(cfg, "cpu").init(0)
    assert m.moe_layers[0].moe.router.dtype == torch.float32
    assert m.embed.dtype == torch.bfloat16
    cache = m.init_cache(2, 8)
    m.prefill({"tokens": torch.tensor([[3, 1, 4], [1, 5, 9]])}, cache)
    logits = m.decode_step(torch.tensor([[2], [6]]), cache)
    assert logits.shape == (2, cfg.padded_vocab)
    assert torch.isfinite(logits[:, :cfg.vocab_size]).all()
    assert cache["length"].tolist() == [4, 4]


def test_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(get_config("qwen3-0.6b", "smoke"))


# ------------------------------------------------------- hybrid family

HYBRID = "recurrentgemma-2b"


def test_hybrid_forward_matches_reference_float32():
    """Smoke config (one super-block of rglru, rglru, attn and a tail of
    two rglru layers; window 16) over 20 tokens, past the window."""
    rm, params, m = _pair(HYBRID)
    assert len(m.super) == 1 and len(m.tail) == 1
    assert list(m.super[0]) == ["b0_rglru", "b1_rglru", "b2_attn"]
    toks = np.random.default_rng(9).integers(
        0, rm.cfg.vocab_size, (2, 20)).astype(np.int32)
    want, _ = rm.forward(params, jnp.asarray(toks))
    got, aux = m.forward(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL32,
                               atol=TOL32)
    assert float(aux) == 0.0


def test_hybrid_sliding_window_ring_cache():
    """The reference's test_sliding_window_ring_cache on the port: window
    8, 20 tokens; prefill's last logits equal the windowed forward's."""
    cfg = get_config(HYBRID, "smoke").replace(dtype=torch.float32, window=8)
    m = build_model(cfg, seed=4, device="cpu")
    b, s = 2, 20                       # well past the window
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab_size, (b, s)))
    logits_fwd, _ = m.forward(toks)
    cache = m.init_cache(b, s)
    assert cache["kv"]["k"].shape[2] == 8   # ring sized to the window
    last = m.prefill({"tokens": toks}, cache)
    np.testing.assert_allclose(last.numpy(), logits_fwd[:, -1].numpy(),
                               rtol=1e-3, atol=1e-3)
    assert cache["length"].tolist() == [s, s]


def test_hybrid_decode_matches_reference():
    """20 decode steps from carried weights, past the 16-position ring:
    each step's logits and, at the end, every cache leaf."""
    rm, params, m = _pair(HYBRID)
    toks = np.random.default_rng(11).integers(
        0, rm.cfg.vocab_size, (2, 20)).astype(np.int32)
    rc, pc = rm.init_cache(2, 32), m.init_cache(2, 32)
    ref_shapes = jax.tree.map(lambda a: (a.shape, a.dtype.name), rc)
    port_shapes = {k: ({kk: (tuple(vv.shape), str(vv.dtype)[6:])
                        for kk, vv in v.items()} if isinstance(v, dict)
                       else (tuple(v.shape), str(v.dtype)[6:]))
                   for k, v in pc.items()}
    assert port_shapes == ref_shapes
    for t in range(20):
        rc, want = rm.decode_step(params, jnp.asarray(toks[:, t:t + 1]), rc)
        got = m.decode_step(torch.from_numpy(toks[:, t:t + 1]), pc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL32, atol=TOL32)
    np.testing.assert_array_equal(pc["length"].numpy(),
                                  np.asarray(rc["length"]))
    for name in ("conv", "h", "tail_conv", "tail_h"):
        np.testing.assert_allclose(pc[name].numpy(), np.asarray(rc[name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    for name in ("k", "v"):
        np.testing.assert_allclose(pc["kv"][name].numpy(),
                                   np.asarray(rc["kv"][name]), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    # a step from the reference's own cache, carried across
    carried = interop.model_cache(_np(rc), "cpu")
    assert carried["h"].dtype == torch.float32
    _, want = rm.decode_step(params, jnp.asarray(toks[:, :1]), rc)
    got = m.decode_step(torch.from_numpy(toks[:, :1]), carried)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL32,
                               atol=TOL32)


def test_hybrid_decode_moves_only_active_lanes():
    """A masked-out lane's recurrent state, ring and length stay bitwise
    as they were while the other lane decodes."""
    cfg = get_config(HYBRID, "smoke").replace(dtype=torch.float32)
    m = build_model(cfg, seed=5, device="cpu")
    cache = m.init_cache(2, 32)
    m.prefill({"tokens": torch.tensor([[3, 1, 4], [1, 5, 9]])}, cache)
    before = {k: (v.clone() if not isinstance(v, dict)
                  else {kk: vv.clone() for kk, vv in v.items()})
              for k, v in cache.items()}
    lanes = torch.tensor([True, False])
    for tok in (2, 6, 5):
        m.decode_step(torch.tensor([[tok], [7]]), cache, lanes=lanes)
    for name in ("conv", "h", "tail_conv", "tail_h"):
        assert torch.equal(cache[name][:, :, 1], before[name][:, :, 1])
        assert not torch.equal(cache[name][:, :, 0], before[name][:, :, 0])
    for name in ("k", "v"):
        assert torch.equal(cache["kv"][name][:, 1],
                           before["kv"][name][:, 1])
    assert cache["length"].tolist() == [6, 3]


def test_hybrid_full_config_builds_on_meta_shapes():
    """recurrentgemma-2b at full width: 8 super-blocks and a tail of two
    recurrent layers, 8 attention layers of 10 query heads on one KV head
    of 256, a ring of min(2048, max_len); every leaf of the reference's
    pytree (its shapes, from `jax.eval_shape`) and no other."""
    cfg = get_config(HYBRID, "full")
    m = Model(cfg, "meta")
    assert len(m.super) == 8 and list(m.tail[0]) == ["b0_rglru", "b1_rglru"]
    ref = jax.eval_shape(ref_build(ref_config(HYBRID, "full")).init, KEY)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        keys = [k.key for k in path]
        if keys[0] in ("super", "tail"):
            for i in range(leaf.shape[0]):
                want[".".join([keys[0], str(i), *keys[1:]])] = leaf.shape[1:]
        else:
            want[".".join(keys)] = leaf.shape
    got = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert got == want
    assert sum(p.numel() for p in m.parameters()) == 2_894_481_920
    cache = m.init_cache(8, 4096, device="meta")
    assert tuple(cache["kv"]["k"].shape) == (8, 8, 2048, 1, 256)
    assert tuple(cache["conv"].shape) == (8, 2, 8, 3, 2560)
    assert cache["h"].dtype == torch.float32
    assert tuple(m.init_cache(8, 1024, device="meta")["kv"]["k"].shape) == \
        (8, 8, 1024, 1, 256)


def test_hybrid_tail_with_an_attention_layer_matches_reference():
    """A pattern (rglru, attn, rglru) over 5 layers leaves the tail
    (rglru, attn). The reference builds it and runs forward, loss and
    init_cache; so does the port: logits within TOL32 from carried
    weights, the loss on ones within test_torch_train.py's 1e-5, every
    cache leaf shaped as the reference's (``tail_conv`` / ``tail_h`` over
    the tail's one recurrent layer, no tail KV). Only decode raises: the
    reference's tail decode reads ``rglru`` weights on every layer
    (KeyError), the port's refuses the tail (NotImplementedError)."""
    kw = dict(block_pattern=("rglru", "attn", "rglru"), n_layers=5)
    rcfg = ref_config(HYBRID, "smoke").replace(dtype=jnp.float32, **kw)
    cfg = get_config(HYBRID, "smoke").replace(dtype=torch.float32, **kw)
    rm = ref_build(rcfg)
    params = rm.init(KEY)
    m = Model(cfg, "cpu")
    m.load_state_dict(interop.model_params(_np(params), cfg, "cpu"))
    assert list(m.tail[0]) == ["b0_rglru", "b1_attn"]
    toks = np.random.default_rng(12).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    want, _ = rm.forward(params, jnp.asarray(toks))
    got, _ = m.forward(torch.from_numpy(toks))
    assert tuple(got.shape) == np.asarray(want).shape == (2, 16, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL32,
                               atol=TOL32)
    ones = np.ones((2, 17), np.int32)
    want_loss, _ = rm.loss(params, {"tokens": jnp.asarray(ones)})
    got_loss, _ = m.loss({"tokens": torch.from_numpy(ones)})
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    rc, pc = rm.init_cache(2, 32), m.init_cache(2, 32)
    want_shapes = jax.tree.map(lambda a: (a.shape, a.dtype.name), rc)
    got_shapes = {k: ({kk: (tuple(vv.shape), str(vv.dtype)[6:])
                       for kk, vv in v.items()} if isinstance(v, dict)
                      else (tuple(v.shape), str(v.dtype)[6:]))
                  for k, v in pc.items()}
    assert got_shapes == want_shapes
    assert tuple(pc["tail_h"].shape) == (1, 1, 2, cfg.lru_width or
                                         cfg.d_model)
    tok = np.array([[3], [5]], np.int32)
    with pytest.raises(KeyError):
        rm.decode_step(params, jnp.asarray(tok), rc)
    with pytest.raises((KeyError, NotImplementedError), match="tail"):
        m.decode_step(torch.from_numpy(tok), pc)


@pytest.mark.parametrize("family,arch", [("ssd", "mamba2-2.7b"),
                                         ("moe", "dbrx-132b"),
                                         ("moe", "deepseek-v3-671b"),
                                         ("mla", "deepseek-v3-671b")])
def test_init_functions_give_the_reference_leaves(family, arch):
    """`init_ssd`, `init_moe` and `init_mla`, shaped like `init_rglru`: a
    module on the generator's device whose parameters are the reference's
    `init_*` leaves by name, shape and type; the float32 leaves stay
    float32 in a bfloat16 config."""
    import importlib
    mod = importlib.import_module(f"repro_torch.models.{family}")
    ref_mod = importlib.import_module(f"repro.models.{family}")
    cfg, rcfg = get_config(arch, "smoke"), ref_config(arch, "smoke")
    got = getattr(mod, f"init_{family}")(torch.Generator().manual_seed(0),
                                         cfg)
    want = jax.eval_shape(lambda: getattr(ref_mod, f"init_{family}")(KEY,
                                                                     rcfg))
    flat = {".".join(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    params = dict(got.named_parameters())
    assert {n: (tuple(p.shape), str(p.dtype)[6:]) for n, p in
            params.items()} == {n: (leaf.shape, leaf.dtype.name)
                                for n, leaf in flat.items()}
    assert all(p.device.type == "cpu" and not p.requires_grad
               for p in params.values())
    assert any(float(p.float().abs().max()) > 0 for p in params.values())
