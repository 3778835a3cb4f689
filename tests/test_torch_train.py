"""Port training path (`repro_torch.models.layers.cross_entropy`,
`Model.loss`, `repro_torch.train`, `repro_torch.distributed.compression`,
`repro_torch.data.pipeline`) vs the reference (`repro.train`,
`repro.distributed.compression`, `repro.data.pipeline`) at smoke widths
on the CPU, in float32.

The reference's weights and training state are carried across with
`repro_torch.interop` (`model_params`, `train_state`); the batches come
from the reference's `TokenPipeline` and are the port's bit for bit.
Tolerances: the loss within 1e-5 relative (float32 sums in another
order); every gradient within 1e-4 of its leaf's largest magnitude (the
backward sums over the batch and the sequence in another order);
AdamW, clipping and the schedule 1e-6 relative (parameters and moments
1e-6 of their leaf's largest magnitude: a few float32 roundings) on
carried inputs; compression bitwise (the same float32 operations, one
scale per reference leaf). After 3 train steps every moment and residual
within 1e-4 of its leaf's largest magnitude, and 99.9 % of each
parameter's entries within 1e-6 + 1e-6 |p| of the reference's, every
entry within 2 % of the summed learning rates: AdamW's step is lr x m /
sqrt(v), a ratio that a rounding changes by much more than its own size
where m nearly cancels. With compression a gradient's rounding can flip
an int8 level (1/127 of the leaf's largest gradient; a gradient's
relative rounding of ~1e-5 of that maximum flips ~0.1 % of the levels a
step): there 99 % of the entries meet the same tight bounds, and every
entry is within one flip's reach: a parameter within the summed
learning rates (|m / sqrt(v)| <= 1 over these 3 steps), a moment within
3 % of its leaf's largest magnitude, a residual within one level (3
times the residual's largest magnitude: a level is twice the largest a
residual can reach, and the largest one seen may fall short). A residual is at most half a level, 1/254 of the gradient's
maximum, so the gradient's rounding is held to 5 % of the residual's own
largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.data.pipeline import TokenPipeline as RefPipeline
from repro.distributed import compression as ref_comp
from repro.models import build_model as ref_build
from repro.models import layers as ref_layers
from repro.train import loop as ref_loop
from repro.train import optim as ref_optim
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed import compression
from repro_torch.models import Model, layers
from repro_torch.models.layers import cross_entropy
from repro_torch.models.model import reference_leaf
from repro_torch.train import loop, optim

KEY = jax.random.PRNGKey(9)
FAMILIES = {"dense": "qwen3-0.6b", "moe": "dbrx-132b",
            "moe_mla_mtp": "deepseek-v3-671b", "hybrid": "recurrentgemma-2b",
            "encdec": "whisper-base", "vlm": "internvl2-76b",
            "ssm": "mamba2-2.7b"}
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
OPT_RTOL = 1e-6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _frontend_shape(cfg):
    if cfg.family == "encdec":
        return (cfg.src_len, cfg.d_model)
    if cfg.family == "vlm":
        return (cfg.n_patches, cfg.d_model)
    return None


def _setup(arch, seq=12, batch=2, seed=0):
    """The reference model and its float32 weights, the port's model with
    them carried across, and a reference batch (numpy)."""
    rcfg = ref_config(arch, "smoke").replace(dtype=jnp.float32)
    rm = ref_build(rcfg)
    params = rm.init(KEY)
    cfg = get_config(arch, "smoke").replace(dtype=torch.float32)
    m = Model(cfg, "cpu")
    m.load_state_dict(interop.model_params(_np(params), cfg, "cpu"))
    pipe = RefPipeline(cfg.vocab_size, seq, batch, seed=seed,
                       frontend_shape=_frontend_shape(cfg))
    return rm, params, m, _np(pipe.batch_at(0))


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


# ---------------------------------------------------------------- loss

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 40)) * 4).astype(np.float32)
    labels = rng.integers(0, 40, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = ref_layers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    None if mask is None
                                    else jnp.asarray(mask))
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def test_cross_entropy_of_an_empty_mask_is_zero():
    logits = torch.zeros(2, 3, 5)
    labels = torch.zeros(2, 3, dtype=torch.int64)
    assert float(cross_entropy(logits, labels, torch.zeros(2, 3))) == 0.0


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_every_gradient_match_reference(family):
    """`Model.loss` (ce + aux, + the MTP loss for deepseek-v3) and the
    gradient of the total with respect to every weight against
    `jax.value_and_grad` of the reference's loss, leaf for leaf (the
    reference's stacked gradients unstacked by `interop.model_params`)."""
    rm, params, m, batch = _setup(FAMILIES[family])
    (want, wmet), wgrad = jax.value_and_grad(rm.loss, has_aux=True)(
        params, jax.tree.map(jnp.asarray, batch))
    for p in m.parameters():
        p.requires_grad_(True)
    total, met = m.loss(_t(batch))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(want),
                               rtol=LOSS_RTOL)
    assert sorted(met) == sorted(wmet)
    for k in met:
        np.testing.assert_allclose(float(met[k].detach()), float(wmet[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    wg = interop.model_params(_np(wgrad), m.cfg, "cpu", dtype=torch.float32)
    got = dict(m.named_parameters())
    assert sorted(got) == sorted(wg)
    for name, p in got.items():
        scale = max(float(wg[name].abs().max()), 1e-6)
        np.testing.assert_allclose(p.grad.numpy(), wg[name].numpy(),
                                   rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=name)


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_init_rms_and_init_mlp_draw_the_reference_init(mlp_type):
    """The norm scale is frozen zeros; the MLP's weights have the
    reference's names and shapes, fan-in scaled truncated normals."""
    ln = layers.init_rms(48, torch.bfloat16)
    assert ln.dtype == torch.bfloat16 and not ln.requires_grad
    assert not ln.any() and np.asarray(ref_layers.init_rms(48, jnp.bfloat16)
                                       ).shape == tuple(ln.shape)
    g = torch.Generator().manual_seed(0)
    mod = layers.init_mlp(g, 32, 48, mlp_type, torch.float32)
    ref = _np(ref_layers.init_mlp(KEY, 32, 48, mlp_type, jnp.float32))
    got = dict(mod.named_parameters())
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in ref.items()}
    for name, w in got.items():
        assert not w.requires_grad
        assert float(w.abs().max()) <= 2.0 * w.shape[0] ** -0.5 + 1e-6
        assert 0.5 < float(w.std()) * w.shape[0] ** 0.5 < 1.0, name


def test_serving_after_training_records_no_graph():
    """Weights with gradients on: `init` still writes them, and prefill and
    decode run without a graph."""
    cfg = get_config("mamba2-2.7b", "smoke")
    m = Model(cfg, "cpu")
    state = loop.init_train_state(m, seed=3)
    assert all(p.requires_grad for p in state.params.values())
    m.init(4)
    cache = m.init_cache(2, 8)
    logits = m.prefill({"tokens": torch.tensor([[1, 2], [3, 4]])}, cache)
    assert logits.grad_fn is None and not cache["ssm"].requires_grad


# ----------------------------------------------------------- optimizer

def test_weight_decay_follows_the_reference_leaf():
    """Decayed: a stacked layer's vectors (``ln1``, ``d_skip``, the MTP
    block's norm), the embedding, ``mtp.proj``; not decayed:
    ``final_norm`` and ``mtp.ln``."""
    vec, mat = torch.zeros(4), torch.zeros(4, 4)
    for name, p, want in (("layers.0.ln1", vec, True),
                          ("layers.11.ssd.d_skip", vec, True),
                          ("super.2.b1_rglru.rglru.lam", vec, True),
                          ("mtp.block.0.ln1", vec, True),
                          ("embed", mat, True), ("mtp.proj", mat, True),
                          ("final_norm", vec, False), ("mtp.ln", vec, False)):
        assert optim.decays(name, p) is want, name
    assert reference_leaf("moe_layers.3.moe.router") == ("moe_layers.moe.router",
                                                         True)
    assert reference_leaf("mtp.ln") == ("mtp.ln", False)


def _grads_like(params, seed, scale=1e-2):
    """Random gradients for a reference parameter tree (numpy)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale)
                        .astype(np.float32), params)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "deepseek-v3-671b"])
def test_adamw_clip_and_schedule_match_reference_leaf_for_leaf(arch):
    """Three AdamW steps at the schedule's rates (warmup 2) on clipped
    random gradients, from a carried tree: parameters and moments leaf
    for leaf (mamba2: decayed ``d_skip``; deepseek-v3: ``mtp.ln`` and
    ``final_norm`` not decayed)."""
    rcfg = ref_config(arch, "smoke").replace(dtype=jnp.float32)
    cfg = get_config(arch, "smoke").replace(dtype=torch.float32)
    rparams = _np(ref_build(rcfg).init(KEY))
    rstate = ref_optim.adamw_init(rparams)
    params = interop.model_params(rparams, cfg, "cpu")
    state = optim.adamw_init(params)
    rlr = ref_optim.cosine_schedule(3e-2, 2, 10)
    lr = optim.cosine_schedule(3e-2, 2, 10)
    for step in range(3):
        g = _grads_like(rparams, step, scale=10.0 ** (step - 1))
        rg, rnorm = ref_optim.clip_by_global_norm(g, 1.0)
        pg, norm = optim.clip_by_global_norm(
            interop.model_params(g, cfg, "cpu"), 1.0)
        np.testing.assert_allclose(float(norm), float(rnorm), rtol=OPT_RTOL)
        np.testing.assert_allclose(float(lr(state.step)),
                                   float(rlr(rstate.step)), rtol=OPT_RTOL)
        rparams, rstate = ref_optim.adamw_update(rg, rstate, rparams,
                                                 rlr(rstate.step))
        params, state = optim.adamw_update(pg, state, params,
                                           lr(state.step))
    assert int(state.step) == int(rstate.step) == 3
    for got, want in ((params, rparams), (state.mu, rstate.mu),
                      (state.nu, rstate.nu)):
        want = interop.model_params(_np(want), cfg, "cpu")
        for name, t in got.items():
            scale = float(want[name].abs().max())
            np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                       rtol=OPT_RTOL, atol=OPT_RTOL * scale,
                                       err_msg=name)


def test_schedule_global_norm_and_clip_match_reference():
    ref_lr = ref_optim.cosine_schedule(1e-3, warmup=10, total=100)
    lr = optim.cosine_schedule(1e-3, warmup=10, total=100)
    for s in (0, 1, 9, 10, 11, 55, 99, 100, 150):
        got = lr(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(ref_lr(jnp.asarray(s))),
                                   rtol=OPT_RTOL)
    assert float(lr(torch.tensor(0))) == 0.0
    grads = {"a": torch.full((4,), 10.0)}
    clipped, norm = optim.clip_by_global_norm(grads, 1.0)
    np.testing.assert_allclose(float(norm), 20.0)
    np.testing.assert_allclose(float(optim.global_norm(clipped)), 1.0,
                               rtol=1e-5)
    small, _ = optim.clip_by_global_norm({"a": torch.full((4,), 0.1)}, 1.0)
    assert torch.equal(small["a"], torch.full((4,), 0.1))


def test_adamw_reduces_quadratic():
    params = {"w": torch.tensor([3.0, -2.0, 5.0])}
    state = optim.adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state = optim.adamw_update(grads, state, params, lr=0.05,
                                           weight_decay=0.0)
    np.testing.assert_allclose(params["w"].numpy(), 0.0, atol=1e-2)


# ---------------------------------------------------------- compression

def test_compress_decompress_matches_reference_on_a_stacked_tree():
    """Two rounds with residuals on a mamba2 gradient tree whose layers
    differ 100x in scale: one int8 scale per reference leaf (the layer
    stack's), so the port's unstacked tensors are grouped; dequantized
    gradients and residuals bitwise."""
    rcfg = ref_config("mamba2-2.7b", "smoke").replace(dtype=jnp.float32)
    cfg = get_config("mamba2-2.7b", "smoke").replace(dtype=torch.float32)
    tree = _np(ref_build(rcfg).init(KEY))
    rres = ref_comp.init_error_feedback(tree)
    res = compression.init_error_feedback(
        interop.model_params(tree, cfg, "cpu"))
    for rnd in range(2):
        g = _grads_like(tree, 10 + rnd)
        g["layers"] = jax.tree.map(lambda x: x * np.array(
            [1.0, 100.0], np.float32).reshape(-1, *[1] * (x.ndim - 1)),
            g["layers"])
        rdeq, rres = ref_comp.compress_decompress(g, rres)
        deq, res = compression.compress_decompress(
            interop.model_params(g, cfg, "cpu"), res)
        for got, want in ((deq, rdeq), (res, rres)):
            want = interop.model_params(_np(want), cfg, "cpu")
            assert sorted(got) == sorted(want)
            for name, t in got.items():
                np.testing.assert_array_equal(t.numpy(), want[name].numpy(),
                                              err_msg=name)


def test_quantize_rounds_half_to_even():
    q, scale = compression._quantize(torch.tensor([0.5, 1.5, 2.5, 127.0]))
    assert float(scale) == pytest.approx(1.0)
    assert q.tolist() == [0, 2, 2, 127] and q.dtype == torch.int8
    want, _ = ref_comp._quantize(jnp.asarray([0.5, 1.5, 2.5, 127.0]))
    assert q.tolist() == np.asarray(want).tolist()


def test_error_feedback_keeps_the_cumulative_error_bounded():
    params = {"w": torch.zeros(64, 64)}
    res = compression.init_error_feedback(params)
    rng = np.random.default_rng(0)
    total_in = np.zeros((64, 64))
    total_out = np.zeros((64, 64))
    for _ in range(20):
        g = {"w": torch.from_numpy(rng.normal(0, 1e-2, (64, 64))
                                   .astype(np.float32))}
        total_in += g["w"].numpy()
        deq, res = compression.compress_decompress(g, res)
        total_out += deq["w"].numpy()
    assert np.abs(total_in - total_out).max() < 1e-3


# --------------------------------------------------------- data pipeline

@pytest.mark.parametrize("frontend", [None, (5, 8)])
def test_token_pipeline_is_the_reference_bit_for_bit(frontend):
    for shard in (0, 1):
        kw = dict(seed=3, shard_index=shard, num_shards=2,
                  frontend_shape=frontend)
        ref = RefPipeline(1000, 16, 8, **kw)
        port = TokenPipeline(1000, 16, 8, device="cpu", **kw)
        for step in (0, 1, 17):
            want, got = _np(ref.batch_at(step)), port.batch_at(step)
            assert sorted(got) == sorted(want)
            for k in got:
                assert got[k].dtype == (torch.int32 if k == "tokens"
                                        else torch.float32)
                np.testing.assert_array_equal(got[k].numpy(), want[k])
    it = TokenPipeline(1000, 16, 8, device="cpu").iterate(start_step=5)
    for want_step in (5, 6):
        step, batch = next(it)
        assert step == want_step
        assert torch.equal(batch["tokens"], TokenPipeline(
            1000, 16, 8, device="cpu").batch_at(step)["tokens"])
    it.close()


# ---------------------------------------------------------- train steps

@pytest.mark.parametrize("arch,accum,compress", [
    ("qwen3-0.6b", 1, False), ("qwen3-0.6b", 4, False),
    ("qwen3-0.6b", 1, True), ("mamba2-2.7b", 1, False),
    ("deepseek-v3-671b", 2, True)])
def test_train_steps_match_reference(arch, accum, compress):
    """3 steps of `make_train_step` (lr 1e-2, warmup 1: step 0 trains at
    lr 0) from the reference's `init_train_state`, carried across, on the
    reference pipeline's batches: metrics, every parameter, moment and
    residual against the reference's jitted step."""
    rm, _, m, _ = _setup(arch)
    cfg = m.cfg
    rstate = ref_loop.init_train_state(rm, KEY, compress=compress)
    state = interop.train_state(_np(rstate), m)
    assert state.params["embed"] is m.embed and m.embed.requires_grad
    kw = dict(base_lr=1e-2, warmup=1, total_steps=10, accum_steps=accum,
              compress=compress)
    rstep = jax.jit(ref_loop.make_train_step(rm, **kw))
    step = loop.make_train_step(m, **kw)
    pipe = RefPipeline(cfg.vocab_size, 12, 4, seed=1,
                       frontend_shape=_frontend_shape(cfg))
    for i in range(3):
        batch = pipe.batch_at(i)
        rstate, rmet = rstep(rstate, batch)
        state, met = step(state, _t(_np(batch)))
        assert sorted(met) == sorted(rmet)
        for k in met:
            np.testing.assert_allclose(float(met[k]), float(rmet[k]),
                                       rtol=1e-4, err_msg=k)
    assert int(state.opt.step) == 3
    lr_sum = sum(float(optim.cosine_schedule(1e-2, 1, 10)(s))
                 for s in range(3))
    rstate = _np(rstate)
    share = 1e-2 if compress else 1e-3
    want_p = interop.model_params(rstate.params, cfg, "cpu")
    for name, p in state.params.items():
        want = want_p[name].numpy()
        _agree(p.detach().numpy(), want, 1e-6 + 1e-6 * np.abs(want),
               (1.0 if compress else 0.02) * lr_sum, share, name)
    trees = [(state.opt.mu, rstate.opt.mu, GRAD_TOL, 0.03),
             (state.opt.nu, rstate.opt.nu, GRAD_TOL, 0.03)]
    if compress:
        trees.append((state.ef, rstate.ef, 0.05, 3.0))
    for got, want, tight, flip in trees:
        want = interop.model_params(want, cfg, "cpu", dtype=torch.float32)
        for name, t in got.items():
            scale = max(float(want[name].abs().max()), 1e-12)
            _agree(t.numpy(), want[name].numpy(), tight * scale,
                   (flip if compress else tight) * scale, share, name)


def _agree(got, want, tight, loose: float, share: float, name: str) -> None:
    """Every entry within ``loose``, and all but ``share`` of them within
    ``tight``."""
    err = np.abs(got - want)
    assert err.max() <= loose, (name, float(err.max()), loose)
    assert np.mean(err > tight) <= share, (name, float(np.mean(err > tight)))


def test_serve_and_prefill_steps_match_reference():
    rm, params, m, batch = _setup("qwen3-0.6b")
    want = ref_loop.make_prefill_step(rm)(params, batch)
    got = loop.make_prefill_step(m)(_t(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    rcache = rm.init_cache(2, 8)
    cache = m.init_cache(2, 8)
    tok = np.array([[3], [7]], np.int32)
    rcache, rlog = ref_loop.make_serve_step(rm)(params, rcache,
                                                jnp.asarray(tok))
    cache, log = loop.make_serve_step(m)(cache, torch.from_numpy(tok))
    np.testing.assert_allclose(log.numpy(), np.asarray(rlog), rtol=1e-4,
                               atol=1e-4)
    assert cache["length"].tolist() == [1, 1]


# ---------------------------------------------------------- launch.train

LAUNCH = ["--arch", "qwen3-0.6b", "--batch", "2", "--seq", "16",
          "--ckpt-every", "2"]


def _labels(ckpt):
    """Step label -> the manifest's metadata, of every entry in ``ckpt``."""
    import json
    return {int(p.name.split("_")[1]):
            json.loads((p / "manifest.json").read_text())["metadata"]
            for p in ckpt.glob("step_*")}


def _replay(order, ckpt_args=LAUNCH):
    """An in-process run of the launcher's build and step over the batch
    order given: its state."""
    from repro_torch.launch import train
    _, model, pipe, step_fn = train.build("qwen3-0.6b", "smoke", 16, 2, 6,
                                          False, 3e-4, device="cpu")
    state = loop.init_train_state(model, seed=0)
    for step in order:
        state, _ = step_fn(state, pipe.batch_at(step))
    return state


def _same_as_entry(state, entry):
    """Every leaf of ``(state,)`` bitwise the stored one of ``entry``."""
    from repro_torch.checkpoint.store import _flatten, _host, restore_named
    arrays, _ = restore_named(entry.parent, entry.name)
    leaves = [_host(x)[0] for x in _flatten((state,))]
    assert len(leaves) == len(arrays)
    for a, b in zip(leaves, arrays):
        assert a.shape == b.shape and np.array_equal(a, b)


def test_launch_train_cli_resumes_as_the_reference_does(tmp_path):
    """Both CLIs in subprocesses, to --steps 4 and then --steps 6 over the
    same directory: the same step labels (2, 4, 6) and manifest metadata;
    the port's last entry bitwise an in-process run of batches 0..3 (the
    first run) then 4..5 (the resumed one, from the step-4 save)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src"),
           "JAX_PLATFORMS": "cpu"}
    for pkg, extra in (("repro", []), ("repro_torch", ["--device", "cpu"])):
        for steps in ("4", "6"):
            out = subprocess.run(
                [sys.executable, "-m", f"{pkg}.launch.train", *LAUNCH,
                 "--steps", steps, "--ckpt-dir", str(tmp_path / pkg),
                 *extra], capture_output=True, text=True, env=env, cwd=root,
                timeout=300)
            assert out.returncode == 0, out.stderr[-3000:]
        assert "[resume] restored step 4" in out.stdout
    want = _labels(tmp_path / "repro")
    assert sorted(want) == [2, 4, 6]
    assert _labels(tmp_path / "repro_torch") == want
    assert want[6] == {"step": 6, "arch": "qwen3-0.6b"}
    _same_as_entry(_replay([0, 1, 2, 3, 4, 5]),
                   tmp_path / "repro_torch" / "step_6")


def _flaky(build_fn, calls, fail_at):
    """``build_fn`` whose step function records each batch's token sum and
    raises on call ``fail_at`` (0-based)."""
    def build(*args, **kwargs):
        cfg, model, pipe, step_fn = build_fn(*args, **kwargs)

        def step(state, batch):
            calls.append(int(np.asarray(batch["tokens"]).sum()))
            if len(calls) == fail_at + 1:
                raise RuntimeError("injected step failure")
            return step_fn(state, batch)

        return cfg, model, pipe, step

    return build


def test_launch_train_elastic_path_matches_reference(tmp_path, monkeypatch,
                                                     capsys):
    """A step function that raises once, at step 3: each driver shrinks the
    mesh over its visible devices to (1, 1), restores the step-2 save and
    goes on with step 4 (the for loop does not rewind, so batch 3 is never
    trained); the same batches in the same order, the same labels and
    metadata; the port's last entry bitwise an in-process run of batches
    0, 1, 2, 4, 5."""
    import sys

    from repro.distributed import sharding as ref_shd
    from repro.launch import train as ref_train
    from repro_torch.distributed import sharding
    from repro_torch.launch import train
    args = [*LAUNCH, "--steps", "6"]
    ref_calls, calls = [], []
    monkeypatch.setattr(ref_train, "build", _flaky(ref_train.build,
                                                   ref_calls, 3))
    monkeypatch.setattr(train, "build", _flaky(train.build, calls, 3))
    monkeypatch.setattr(sys, "argv", ["train", *args, "--ckpt-dir",
                                      str(tmp_path / "repro")])
    try:
        ref_train.main()
        ref_mesh = ref_shd.active_mesh()
        assert dict(ref_mesh.shape) == {"data": 1, "model": 1}
        out = train.main([*args, "--ckpt-dir", str(tmp_path / "repro_torch"),
                          "--device", "cpu"])
        mesh = sharding.active_mesh()
        assert mesh.shape == {"data": 1, "model": 1}
        assert mesh.devices.tolist() == [["cpu"]]
    finally:
        ref_shd.clear_mesh()
        sharding.clear_mesh()
    printed = capsys.readouterr().out
    assert printed.count("[elastic] step 3 failed (RuntimeError)") == 2
    assert out["failed_steps"] == [3]
    assert calls == ref_calls and len(calls) == 6
    assert calls[3] != calls[4]                       # batch 3, then 4
    assert _labels(tmp_path / "repro_torch") == _labels(tmp_path / "repro")
    _same_as_entry(_replay([0, 1, 2, 4, 5]),
                   tmp_path / "repro_torch" / "step_6")
