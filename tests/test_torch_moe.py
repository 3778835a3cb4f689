"""Port MoE family (dbrx-132b, deepseek-v3-671b) vs the reference on the CPU.

The reference (`repro.models`) runs as tests/test_models.py runs it, the
port (`repro_torch.models`) with ``device="cpu"``, on the smoke configs
in float32 (dbrx: 2 MoE layers of 4 experts, top 2, D = 128; deepseek: 1
dense and 2 MLA + MoE layers, 4 routed experts and a shared one, top 2,
D = 56). The reference's weights are carried across with
`repro_torch.interop.model_params`; every other input is drawn with
numpy from a seed and fed to both. Tolerance 1e-4 (tests/test_torch_models
.py's TOL32: the frameworks sum products in another order); cache leaves
1e-5. The dispatch is compared where it matters: a row whose capacity
drops tokens, router logits that tie, and decode batches whose routing
rows hold several tokens with idle lanes among them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro.models import moe as ref_moe
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import Model, build_model
from repro_torch.models import moe

KEY = jax.random.PRNGKey(5)
TOL32 = 1e-4
ARCHS = ["dbrx-132b", "deepseek-v3-671b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _cfgs(arch, dtype="float32"):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return (ref_config(arch, "smoke").replace(dtype=jdt),
            get_config(arch, "smoke").replace(dtype=tdt))


def _moe_pair(arch, seed=0):
    """One MoE layer's weights from the reference, carried into the
    port's `MoE` module through `interop.model_params`."""
    rcfg, cfg = _cfgs(arch)
    p = _np(ref_moe.init_moe(jax.random.PRNGKey(seed), rcfg))
    mod = moe.MoE(cfg)
    carried = interop.model_params(
        {"embed": np.zeros((1, 1)), "final_norm": np.zeros(1),
         "layers": jax.tree.map(lambda a: a[None], p)}, cfg, "cpu")
    mod.load_state_dict({k.removeprefix("layers.0."): v
                         for k, v in carried.items()
                         if k.startswith("layers.0.")})
    return rcfg, cfg, p, mod


def _block(p, mod, x, rcfg, cfg):
    want, want_aux = ref_moe.moe_block(jax.tree.map(jnp.asarray, p),
                                       jnp.asarray(x), rcfg)
    got, aux = moe.moe_block(mod, _t(x), cfg)
    return np.asarray(want), float(want_aux), got.numpy(), float(aux)


def _ref_routing(p, x, rcfg):
    """The reference's chosen experts (r, tl, k) and per-row capacity, as
    its moe_block computes them."""
    b, s, d = x.shape
    r = ref_moe._n_rows(b * s, 32)
    xr = jnp.asarray(x).reshape(r, -1, d)
    logits = jnp.einsum("rtd,de->rte", xr, jnp.asarray(p["router"]))
    _, top_i = jax.lax.top_k(jax.nn.softmax(logits, -1), rcfg.top_k)
    n = xr.shape[1] * rcfg.top_k
    cap = max(int(n / rcfg.n_experts * rcfg.capacity_factor), 4)
    return np.asarray(top_i), ((cap + 7) // 8) * 8


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch):
    """Random tokens, B x S = 128: 32 rows of 4 tokens; output and aux."""
    rcfg, cfg, p, mod = _moe_pair(arch)
    x = np.random.default_rng(0).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    want, want_aux, got, aux = _block(p, mod, x, rcfg, cfg)
    np.testing.assert_allclose(got, want, rtol=TOL32, atol=TOL32)
    assert aux == pytest.approx(want_aux, rel=1e-5) and aux > 0
    assert hasattr(mod, "shared") == (arch == "deepseek-v3-671b")


def test_moe_block_drops_tokens_past_capacity_like_the_reference():
    """dbrx-smoke at (1, 63): one row of 63 tokens (63 is odd, so the row
    grid is 1), capacity 40. One token repeated 48 times sends 48 choices
    to each of its two experts, so 8 of each are dropped, the last ones
    in the row's stable order."""
    rcfg, cfg, p, mod = _moe_pair("dbrx-132b")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 63, cfg.d_model)).astype(np.float32)
    rep = rng.permutation(63)[:48]
    x[0, rep] = x[0, rep[0]]
    top_i, cap = _ref_routing(p, x, rcfg)
    counts = np.bincount(top_i.ravel(), minlength=rcfg.n_experts)
    assert top_i.shape == (1, 63, 2) and cap == 40
    assert counts.max() > cap                  # the reference drops tokens
    want, want_aux, got, aux = _block(p, mod, x, rcfg, cfg)
    np.testing.assert_allclose(got, want, rtol=TOL32, atol=TOL32)
    assert aux == pytest.approx(want_aux, rel=1e-5)
    # the dropped copies lose that expert's share: they differ from the
    # kept copies, as in the reference
    kept, dropped = sorted(rep)[0], sorted(rep)[-1]
    assert not np.allclose(want[0, kept], want[0, dropped])
    np.testing.assert_allclose(got[0, dropped], want[0, dropped],
                               rtol=TOL32, atol=TOL32)


def _tied_router(d, e):
    """Router columns 0 = 2 and 1 = 3 in dyadic values (exact products
    with integer tokens): every token's probabilities tie in pairs."""
    rng = np.random.default_rng(2)
    w = rng.integers(-4, 5, (d, e)).astype(np.float32) / 8
    w[:, 2], w[:, 3] = w[:, 0], w[:, 1]
    return w


@pytest.mark.parametrize("router", ["zero", "paired"])
def test_top_k_takes_ties_in_lax_top_k_order(router):
    """Tied router logits: every token's chosen experts, and their order,
    equal `jax.lax.top_k`'s (ties to the lower index), in the port's
    `top_k` and through the whole block."""
    rcfg, cfg, p, mod = _moe_pair("dbrx-132b")
    d, e = cfg.d_model, cfg.n_experts
    w = np.zeros((d, e), np.float32) if router == "zero" \
        else _tied_router(d, e)
    p = {**p, "router": w}
    mod.router.copy_(_t(w))
    x = np.random.default_rng(3).integers(-3, 4, (1, 63, d)).astype(
        np.float32)
    logits = x.reshape(-1, d) @ w
    probs = jax.nn.softmax(jnp.asarray(logits), -1)
    want_p, want_i = jax.lax.top_k(probs, cfg.top_k)
    got_p, got_i = moe.top_k(torch.from_numpy(np.array(probs)), cfg.top_k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    # every token's two choices tie, the lower expert id first
    want_i, want_p = np.asarray(want_i), np.asarray(want_p)
    assert (want_p[:, 0] == want_p[:, 1]).all()
    assert (want_i[:, 0] < want_i[:, 1]).all()
    if router == "zero":
        assert (want_i == [0, 1]).all()
    top_i, cap = _ref_routing(p, x, rcfg)
    np.testing.assert_array_equal(
        top_i.reshape(-1, cfg.top_k), np.asarray(want_i))
    if router == "zero":                       # experts 0 and 1 overflow
        assert np.bincount(top_i.ravel()).max() > cap
    want, want_aux, got, aux = _block(p, mod, x, rcfg, cfg)
    np.testing.assert_allclose(got, want, rtol=TOL32, atol=TOL32)
    assert aux == pytest.approx(want_aux, rel=1e-5)


def test_n_rows_is_the_reference_grid():
    for t in (1, 2, 8, 9, 14, 48, 63, 64, 96, 128, 1000):
        assert moe._n_rows(t, 32) == ref_moe._n_rows(t, 32)
    assert [moe._n_rows(t, 32) for t in (8, 9, 48, 64)] == [8, 1, 16, 32]


def test_shared_expert_block_matches_reference():
    """deepseek-smoke: the shared expert added on every token, and a row
    grid of 3 rows of 7 (B x S = 21)."""
    rcfg, cfg, p, mod = _moe_pair("deepseek-v3-671b", seed=4)
    assert tuple(mod.shared.w_gate.shape) == (cfg.d_model, cfg.d_ff_expert)
    assert tuple(mod.experts.w_down.shape) == (cfg.n_experts, cfg.d_ff_expert,
                                               cfg.d_model)
    x = np.random.default_rng(4).standard_normal(
        (3, 7, cfg.d_model)).astype(np.float32)
    want, want_aux, got, aux = _block(p, mod, x, rcfg, cfg)
    np.testing.assert_allclose(got, want, rtol=TOL32, atol=TOL32)
    assert aux == pytest.approx(want_aux, rel=1e-5)


def test_moe_block_bfloat16_keeps_the_router_float32():
    """bfloat16 tokens and experts, router float32: the output in
    bfloat16 within 2 % of its largest magnitude of the reference's (each
    framework rounds the expert products at its own places)."""
    rcfg, cfg = _cfgs("dbrx-132b", "bfloat16")
    p = _np(ref_moe.init_moe(KEY, rcfg))
    assert p["router"].dtype == np.float32
    mod = moe.MoE(cfg)
    assert mod.router.dtype == torch.float32
    sd = {"router": _t(p["router"])}
    sd.update({f"experts.{k}": _t(v).to(torch.bfloat16)
               for k, v in p["experts"].items()})
    mod.load_state_dict(sd)
    x = np.random.default_rng(5).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    want, _ = ref_moe.moe_block(jax.tree.map(jnp.asarray, p),
                                jnp.asarray(x, jnp.bfloat16), rcfg)
    got, aux = moe.moe_block(mod, _t(x).to(torch.bfloat16), cfg)
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=0.02 * np.abs(want).max())


# ------------------------------------------------------------ the model

def _pair(arch, dtype="float32"):
    rcfg, cfg = _cfgs(arch, dtype)
    rm = ref_build(rcfg)
    params = rm.init(KEY)
    m = Model(cfg, "cpu")
    m.load_state_dict(interop.model_params(_np(params), cfg, "cpu"))
    return rm, params, m


@pytest.mark.parametrize("arch", ARCHS)
def test_state_dict_keys_are_model_params_and_router_stays_float32(arch):
    """In the configs' own bfloat16: the state dict's keys and shapes are
    `interop.model_params`' (dense and MoE stacks, experts stacked per
    layer, MTP), the router float32 and every other weight bfloat16."""
    rm, params, m = _pair(arch, "bfloat16")
    carried = interop.model_params(_np(params), m.cfg, "cpu")
    assert {k: tuple(v.shape) for k, v in carried.items()} == {
        k: tuple(v.shape) for k, v in m.state_dict().items()}
    for name, w in m.state_dict().items():
        want = torch.float32 if name.endswith(".router") else torch.bfloat16
        assert w.dtype == want == carried[name].dtype, name
    routers = [k for k in carried if k.endswith("moe.router")]
    assert len(routers) == len(m.moe_layers) == 2
    if arch == "deepseek-v3-671b":
        assert len(m.dense_layers) == 1 and "mtp.proj" in carried
        assert "mtp.block.0.attn.wq" in carried and "mtp.ln" in carried
    else:
        assert not hasattr(m, "mtp") and len(m.dense_layers) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match_reference(arch):
    rm, params, m = _pair(arch)
    toks = np.random.default_rng(6).integers(
        0, rm.cfg.vocab_size, (2, 12)).astype(np.int32)
    want, want_aux = rm.forward(params, jnp.asarray(toks))
    got, aux = m.forward(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL32,
                               atol=TOL32)
    assert aux.dtype == torch.float32 and float(aux) > 0
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_leaves_match_reference(arch):
    rm, _, m = _pair(arch, "bfloat16")
    want = jax.tree.map(lambda a: (a.shape, a.dtype.name),
                        rm.init_cache(3, 20))
    got = _shapes(m.init_cache(3, 20))
    assert got == want


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _caches_close(port, ref, tol=1e-5):
    ref_leaves = dict(_leaves(_np(ref)))
    got = dict(_leaves(port))
    assert sorted(got) == sorted(ref_leaves)
    for name, leaf in got.items():
        np.testing.assert_allclose(leaf.numpy(), ref_leaves[name], rtol=tol,
                                   atol=tol, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill of 6 tokens, 6 decode steps: every step's logits and, at
    the end, every cache leaf (``dense_kv``, ``moe_kv`` / ``ckv``,
    ``kpe``, ``length``); then a step from the reference's cache carried
    across."""
    rm, params, m = _pair(arch)
    toks = np.random.default_rng(7).integers(
        0, rm.cfg.vocab_size, (2, 12)).astype(np.int32)
    rc, pc = rm.init_cache(2, 16), m.init_cache(2, 16)
    rc, want = rm.prefill(params, {"tokens": jnp.asarray(toks[:, :6])}, rc)
    got = m.prefill({"tokens": torch.from_numpy(toks[:, :6])}, pc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL32,
                               atol=TOL32)
    for t in range(6, 12):
        rc, want = rm.decode_step(params, jnp.asarray(toks[:, t:t + 1]), rc)
        got = m.decode_step(torch.from_numpy(toks[:, t:t + 1]), pc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL32, atol=TOL32)
    _caches_close(pc, rc)
    carried = interop.model_cache(_np(rc), "cpu")
    _, want = rm.decode_step(params, jnp.asarray(toks[:, :1]), rc)
    got = m.decode_step(torch.from_numpy(toks[:, :1]), carried)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL32,
                               atol=TOL32)


def _ref_masked_step(rm, params, toks, cache, lanes):
    """The reference engine's step: the full batch, then the old cache
    merged back on the lanes outside ``lanes``."""
    new, logits = rm.decode_step(params, jnp.asarray(toks), cache)
    axes = {k: (1 if k != "length" else 0) for k in new}
    merged = {}
    for k, v in new.items():
        if isinstance(v, dict):
            merged[k] = {kk: jnp.where(jnp.asarray(lanes)[None, :, None,
                                                          None, None],
                                       vv, cache[k][kk])
                         for kk, vv in v.items()}
        else:
            shape = [-1 if i == axes[k] else 1 for i in range(v.ndim)]
            merged[k] = jnp.where(jnp.asarray(lanes).reshape(shape), v,
                                  cache[k])
    return merged, logits


@pytest.mark.parametrize("arch,b", [("dbrx-132b", 48),
                                    ("deepseek-v3-671b", 64),
                                    ("dbrx-132b", 9)])
def test_idle_lanes_route_with_their_row(arch, b):
    """Decode with lanes at a batch whose routing rows hold several tokens
    (48: 16 rows of 3; 64: 32 rows of 2; 9: one row of 9, where capacity 8
    binds when the rows agree): every row's logits, idle ones included,
    equal the reference's full-batch step, and the cache its merged one.
    At b = 9 every lane holds the same tokens, so all nine choose the
    same experts and the last one is dropped."""
    rm, params, m = _pair(arch)
    rng = np.random.default_rng(8)
    if b == 9:
        prompt = np.repeat(rng.integers(0, rm.cfg.vocab_size, (1, 4)), b, 0)
    else:
        prompt = rng.integers(0, rm.cfg.vocab_size, (b, 4))
    prompt = prompt.astype(np.int32)
    rc, pc = rm.init_cache(b, 12), m.init_cache(b, 12)
    rc, _ = rm.prefill(params, {"tokens": jnp.asarray(prompt)}, rc)
    m.prefill({"tokens": torch.from_numpy(prompt)}, pc)
    lanes = rng.random(b) < 0.6
    lanes[:2] = True, False
    first = None
    for step in range(3):
        toks = (np.repeat(rng.integers(0, rm.cfg.vocab_size, (1, 1)), b, 0)
                if b == 9 else rng.integers(0, rm.cfg.vocab_size, (b, 1)))
        toks = toks.astype(np.int32)
        rc, want = _ref_masked_step(rm, params, toks, rc, lanes)
        got = m.decode_step(torch.from_numpy(toks), pc,
                            lanes=torch.from_numpy(lanes))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL32, atol=TOL32)
        first = got.numpy() if first is None else first
    _caches_close(pc, rc)
    assert pc["length"].tolist() == (4 + 3 * lanes).tolist()
    if b == 9:
        # the nine rows agree at every position but the last, whose MoE
        # outputs were dropped (capacity 8): at the first step the idle
        # lanes' logits equal the active ones' and the last row's differ
        np.testing.assert_allclose(first[:-1], first[:1].repeat(8, 0),
                                   rtol=1e-5, atol=1e-5)
        assert not np.allclose(first[0], first[-1], atol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_prefill_matches_its_forward(arch):
    """At B = 2 (2 rows of 1 in decode, 2 rows of 7 in forward) no row can
    overflow, so the sequential prefill reproduces the port's own
    forward."""
    cfg = get_config(arch, "smoke").replace(dtype=torch.float32)
    m = build_model(cfg, seed=3, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 7)))
    want, _ = m.forward(toks)
    cache = m.init_cache(2, 8)
    last = m.prefill({"tokens": toks}, cache)
    torch.testing.assert_close(last, want[:, -1], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_build_model_is_seeded(arch):
    cfg = get_config(arch, "smoke")
    a = build_model(cfg, seed=1, device="cpu")
    b = build_model(cfg, seed=1, device="cpu")
    c = build_model(cfg, seed=2, device="cpu")
    for (name, x), y, z in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(x, y), name
        if "ln" in name or "norm" in name:
            assert not x.any(), name
        else:
            assert not torch.equal(x, z), name
            fan_in = 1 if name == "embed" else x.shape[-2]
            assert x.float().abs().max() <= 2.0 * fan_in ** -0.5 + 1e-2, name
    # experts drawn one at a time: no two experts alike
    w = a.moe_layers[0].moe.experts.w_up
    assert not torch.equal(w[0], w[1])


def _ref_state_shapes(arch, cfg_ref):
    """`jax.eval_shape` of the reference's init, unstacked like
    `interop.model_params`."""
    ref = jax.eval_shape(ref_build(cfg_ref).init, KEY)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        keys = [k.key for k in path]
        if keys[0] in ("dense_layers", "moe_layers"):
            for i in range(leaf.shape[0]):
                want[".".join([keys[0], str(i), *keys[1:]])] = leaf.shape[1:]
        elif keys[:2] == ["mtp", "block"]:
            want[".".join(["mtp.block.0", *keys[2:]])] = leaf.shape[1:]
        else:
            want[".".join(keys)] = leaf.shape
    return want


@pytest.mark.parametrize("arch,layers,analytic,built", [
    ("dbrx-132b", 2, 7_134_744_576, 7_134_738_432),
    ("deepseek-v3-671b", 4, 14_186_264_576, 14_946_162_688)])
def test_full_config_cut_in_depth_builds_on_meta(arch, layers, analytic,
                                                 built):
    """The configs the card serves: full width, n_layers cut (dbrx 40 ->
    2; deepseek-v3 61 -> 4, its 3 dense layers and one MLA + MoE layer).
    Every leaf of the reference's pytree and no other; the analytic count
    (which leaves the MTP depth out, and counts the final norm twice)
    beside the built one."""
    cfg = get_config(arch, "full").replace(n_layers=layers)
    m = Model(cfg, "meta")
    want = _ref_state_shapes(arch, ref_config(arch, "full").replace(
        n_layers=layers))
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == want
    assert cfg.param_count() == analytic
    assert sum(p.numel() for p in m.parameters()) == built
    assert m.moe_layers[0].moe.router.dtype == torch.float32
    cache = m.init_cache(8, 1024, device="meta")
    if arch == "dbrx-132b":
        assert tuple(cache["moe_kv"]["k"].shape) == (2, 8, 1024, 8, 128)
    else:
        assert tuple(cache["dense_kv"]["k"].shape) == (3, 8, 1024, 128, 56)
        assert tuple(cache["ckv"].shape) == (1, 8, 1024, 512)
        assert tuple(cache["kpe"].shape) == (1, 8, 1024, 64)
