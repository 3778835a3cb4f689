"""Port distribution substrate (`repro_torch.distributed`: sharding
rules, collectives, pipeline; `repro_torch.train.loop`'s sharded train,
prefill and serve steps) vs the reference `repro.distributed`, the
one-process steps and the reference's jitted prefill and serve steps, on
the CPU.

The rules are pure functions of path, shape and axis sizes: the port's
specs on a `MeshSpec` equal the reference's on an `AbstractMesh` exactly,
leaf for leaf of every config's full parameter tree and decode cache,
and so do their fallback logs. The collectives, the pipeline and the
sharded step run on gloo process groups of 4 and 8 CPU ranks
(`torch_dist_workers`, spawned once per group); tolerances are the
reference tests': the two-hop sum rtol 1e-6 of a flat all_reduce, the
pipeline rtol and atol 2e-5 of the sequential stages, the sharded train
step test_torch_train.py's bounds against the one-process step, the
sharded prefill and serve steps test_torch_serve.py's (1e-5) against the
one-process steps and against the reference's on weights carried across
by `interop.model_params`.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import torch_dist_workers as workers
from repro.configs import get_config as ref_config
from repro.configs import list_archs
from repro.distributed import pipeline as ref_pipeline
from repro.distributed import sharding as ref_shd
from repro.models import build_model as ref_build
from repro.train import loop as ref_loop
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.distributed import pipeline, sharding
from repro_torch.models import Model
from repro_torch.models.moe import routing_grid
from repro_torch.train import loop, optim

ROOT = Path(__file__).resolve().parent.parent
KEY = jax.random.PRNGKey(0)
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
BATCH_SHAPES = ((1, 524288), (256, 4096), (3, 7), (32, 1), (8,))
CACHE_SHAPES = ((32, 128), (1, 4096))
STACKS = ("layers", "super", "tail", "encoder", "decoder", "dense_layers",
          "moe_layers")


@pytest.fixture()
def meshes(request):
    """The reference's AbstractMesh and the port's MeshSpec of one shape,
    both installed; the fallback logs emptied before and after."""
    sizes, names = request.param
    ref, port = AbstractMesh(sizes, names), sharding.MeshSpec(names, sizes)
    ref_shd.set_mesh(ref)
    sharding.set_mesh(port)
    ref_shd.FALLBACK_LOG.clear()
    sharding.FALLBACK_LOG.clear()
    yield ref, port
    ref_shd.clear_mesh()
    sharding.clear_mesh()
    ref_shd.FALLBACK_LOG.clear()
    sharding.FALLBACK_LOG.clear()


def _ref_leaves(tree):
    return [(ref_shd._path_str(kp), leaf.shape)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


_FULL = {}


def _full_tree(arch):
    if arch not in _FULL:
        model = ref_build(ref_config(arch, "full"))
        _FULL[arch] = _ref_leaves(jax.eval_shape(model.init, KEY))
    return _FULL[arch]


# ------------------------------------------------------------ (a) parity

@pytest.mark.parametrize("meshes", list(MESHES.values()), ids=list(MESHES),
                         indirect=True)
@pytest.mark.parametrize("arch", list_archs())
def test_param_pspec_equals_reference_on_every_full_leaf(arch, meshes):
    """Every leaf of the full parameter tree, fsdp and zero each on and
    off: the spec and the fallback log entries, exactly."""
    leaves = _full_tree(arch)
    for fsdp in (False, True):
        for zero in (False, True):
            for path, shape in leaves:
                want = ref_shd.param_pspec(path, shape, fsdp=fsdp, zero=zero)
                got = sharding.param_pspec(path, shape, fsdp=fsdp, zero=zero)
                assert got == tuple(want), (path, shape, fsdp, zero)
    assert sharding.FALLBACK_LOG == ref_shd.FALLBACK_LOG
    # the active mode is the reference's too
    for mode in (True, False):
        ref_shd.set_fsdp(mode)
        sharding.set_fsdp(mode)
        path, shape = leaves[-1]
        assert sharding.param_pspec(path, shape) == \
            tuple(ref_shd.param_pspec(path, shape))


@pytest.mark.parametrize("meshes", list(MESHES.values()), ids=list(MESHES),
                         indirect=True)
@pytest.mark.parametrize("arch", list_archs())
def test_cache_shardings_equal_reference_on_every_leaf(arch, meshes):
    """Every leaf of the full config's decode cache at two (batch, length)
    shapes (batch 1 takes the sequence fallback): the port's cache on the
    meta device, the reference's from `jax.eval_shape`."""
    ref_mesh, port_mesh = meshes
    rm = ref_build(ref_config(arch, "full"))
    m = Model(get_config(arch, "full"), "meta")
    for b, s in CACHE_SHAPES:
        rc = jax.eval_shape(lambda: rm.init_cache(b, s))
        want = {path: tuple(sh.spec) for path, sh in
                _ref_leaves_sharding(ref_shd.cache_shardings(rc, ref_mesh))}
        got = sharding.cache_shardings(m.init_cache(b, s, device="meta"),
                                       port_mesh)
        flat = {}

        def walk(tree, prefix):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}/")
                else:
                    assert v.mesh is port_mesh
                    flat[prefix + k] = v.spec

        walk(got, "")
        assert flat == want, (b, s)


def _ref_leaves_sharding(tree):
    return [(ref_shd._path_str(kp), leaf) for kp, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("meshes", list(MESHES.values()), ids=list(MESHES),
                         indirect=True)
def test_batch_pspec_and_axis_size_equal_reference(meshes):
    for shape in BATCH_SHAPES:
        for fallback in (True, False):
            assert sharding.batch_pspec(shape, fallback) == \
                tuple(ref_shd.batch_pspec(shape, fallback)), shape
    for name in ("data", "model"):
        assert sharding.axis_size(name) == ref_shd.axis_size(name)
    assert sharding.active_mesh() is meshes[1]


def test_rules_without_a_mesh_equal_reference():
    ref_shd.clear_mesh()
    sharding.clear_mesh()
    assert sharding.active_mesh() is None and sharding.axis_size("data") == 1
    for path, shape in _full_tree("qwen3-0.6b"):
        assert sharding.param_pspec(path, shape, zero=True) == \
            tuple(ref_shd.param_pspec(path, shape, zero=True))
    x = torch.ones(4, 4)
    assert sharding.constrain(x, ("data", None)) is x
    sharding.set_mesh(sharding.MeshSpec(("data", "model"), (2, 2)))
    assert sharding.constrain(x, ("data", None)) is x   # a plain tensor
    sharding.clear_mesh()


def test_mesh_spec_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    spec = sharding.MeshSpec(("pod", "data", "model"), (2, 2, 2),
                             tuple(f"cuda:{i}" for i in range(8)))
    assert spec.shape == {"pod": 2, "data": 2, "model": 2}
    assert spec.devices.shape == (2, 2, 2) and spec.devices[1, 0, 1] == \
        "cuda:5"
    assert sharding.placements((("pod", "data"), None, "model"), spec) == \
        (Shard(0), Shard(0), Shard(2))
    assert sharding.placements((None, None), spec) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        sharding.MeshSpec(("data",), (2,), (0, 1, 2))


# ------------------------------------------- (b) param_shardings, unstacked

def _expected(ref_leaves, path_spec):
    """The port names of a reference tree's leaves, each with the
    reference's spec minus the layer dim, and the names whose layer dim
    carried an axis."""
    want, layer_axis = {}, set()
    for path, shape in ref_leaves:
        keys = path.split("/")
        spec = tuple(path_spec(path, shape))
        stack = keys[0] if keys[0] in STACKS else \
            "mtp.block" if keys[:2] == ["mtp", "block"] else None
        if stack is None:
            want[".".join(keys)] = spec
            continue
        rest = keys[2:] if stack == "mtp.block" else keys[1:]
        for i in range(shape[0]):
            name = ".".join([stack, str(i), *rest])
            want[name] = spec[1:]
            if spec[0] is not None:
                layer_axis.add(name)
    return want, layer_axis


def _check_param_shardings(m, ref_leaves, mesh_sizes, names, zero, fsdp):
    ref_mesh = AbstractMesh(mesh_sizes, names)
    port_mesh = sharding.MeshSpec(names, mesh_sizes)
    ref_shd.set_mesh(ref_mesh)
    sharding.FALLBACK_LOG.clear()
    try:
        want, layer_axis = _expected(ref_leaves, lambda p, s: (
            ref_shd.param_pspec(p, s, fsdp=fsdp, zero=zero)))
        got = sharding.param_shardings(m, port_mesh, fsdp=fsdp, zero=zero)
    finally:
        ref_shd.clear_mesh()
    assert {n: s.spec for n, s in got.items()} == want
    logged = {line.split(":")[0] for line in sharding.FALLBACK_LOG
              if "on the layer axis" in line}
    assert logged == layer_axis
    return len(layer_axis)


@pytest.mark.parametrize("arch", list_archs())
def test_param_shardings_drop_the_layer_dim_of_the_reference_spec(arch):
    """The port's smoke model on four (data, model) meshes and the full
    config on the meta device on both production meshes, zero and fsdp
    each on and off: each tensor's spec is the reference's for its
    stacked leaf with the layer dim dropped, and every layer-axis case is
    in FALLBACK_LOG (mamba2-2.7b, qwen3-32b, nemotron-4-15b and
    internvl2-76b have such cases at full size)."""
    smoke = Model(get_config(arch, "smoke"), "cpu")
    rsmoke = _ref_leaves(jax.eval_shape(
        ref_build(ref_config(arch, "smoke")).init, KEY))
    full = Model(get_config(arch, "full"), "meta")
    cases = 0
    for zero in (False, True):
        for fsdp in (False, True):
            for sizes in ((4, 2), (2, 2), (2, 4), (8, 1)):
                cases += _check_param_shardings(smoke, rsmoke, sizes,
                                                ("data", "model"), zero,
                                                fsdp)
            for sizes, names in MESHES.values():
                cases += _check_param_shardings(full, _full_tree(arch),
                                                sizes, names, zero, fsdp)
    if arch in ("mamba2-2.7b", "qwen3-32b", "nemotron-4-15b",
                "internvl2-76b"):
        assert cases > 0
    sharding.FALLBACK_LOG.clear()


def test_param_shardings_need_a_mesh():
    sharding.clear_mesh()
    with pytest.raises(ValueError, match="no active mesh"):
        sharding.param_shardings(Model(get_config("qwen3-0.6b", "smoke"),
                                       "meta"))


# ------------------------------------------ (c)-(e) collectives, pipeline

@pytest.fixture(scope="module")
def gloo4(tmp_path_factory):
    """One 4-rank gloo group runs the collectives and the pipeline; each
    rank's results, by rank."""
    out = tmp_path_factory.mktemp("gloo4")
    workers.spawn(workers.collectives_worker, 4, str(out))
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(4)]


def test_mesh_coordinates_are_row_major(gloo4):
    assert [list(r["coord"]) for r in gloo4] == [[0, 0], [0, 1], [1, 0],
                                                 [1, 1]]


def test_hierarchical_psum_equals_flat(gloo4):
    """The reference test's x = arange(8 * 16) split over (pod 2, data 2)
    (tests/test_distributed.py:126), rtol 1e-6; and shapes that scatter
    on dim 1 or take the flat fallback, against a flat all_reduce and the
    numpy sum of the ranks' inputs."""
    x = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    for rank in gloo4:
        hier, flat = rank["psum_ref"]
        np.testing.assert_allclose(hier.numpy(), flat.numpy(), rtol=1e-6)
        np.testing.assert_allclose(hier.numpy(),
                                   x.reshape(4, 2, 16).sum(0), rtol=1e-6)
    for shape in workers.PSUM_SHAPES:
        total = sum(r[("psum", shape)][2].numpy() for r in gloo4)
        for rank in gloo4:
            hier, flat, _ = rank[("psum", shape)]
            assert tuple(hier.shape) == shape
            np.testing.assert_allclose(hier.numpy(), flat.numpy(),
                                       rtol=1e-6)
            np.testing.assert_allclose(hier.numpy(), total, rtol=1e-6)


def test_ring_all_gather_equals_all_gather(gloo4):
    for rank in gloo4:
        for axis in ("pod", "data"):
            for shape in workers.GATHER_SHAPES:
                got, want = rank[("gather", axis, shape)]
                assert torch.equal(got, want), (axis, shape)


def test_constrain_redistributes_a_dtensor_without_changing_it(gloo4):
    """On a (pod, data) DeviceMesh, 'data' is both axes: rows of 8 shard
    over them (pod-major), rows of 3 do not divide 4 and stay replicated;
    the values never change."""
    for rank in gloo4:
        for shape, want in (((8, 16), ["S(0)", "S(0)"]),
                            ((3, 16), ["R", "R"])):
            placements, got, before = rank[("constrain", shape)]
            assert placements == want
            assert torch.equal(got, before)


def test_pipeline_forward_matches_sequential(gloo4):
    """4 stages, S = 4, M = 6, B = 2, D = 8 (tests/test_distributed.py:105
    on 4 ranks), rtol and atol 2e-5; every stage holds the outputs, from
    plain and from DTensor stage parameters alike."""
    p = workers.PIPE
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((p["S"], p["D"], p["D"])) * 0.3).astype(
        np.float32)
    want = rng.standard_normal((p["M"], p["B"], p["D"])).astype(np.float32)
    for s in range(p["S"]):
        want = np.tanh(want @ w[s])
    for rank in gloo4:
        np.testing.assert_allclose(rank["pipe"].numpy(), want, rtol=2e-5,
                                   atol=2e-5)
        assert torch.equal(rank["pipe_dtensor"], rank["pipe"])


@pytest.mark.parametrize("micro,stages", [(6, 4), (1, 1), (8, 2), (32, 16)])
def test_bubble_fraction_equals_reference(micro, stages):
    assert pipeline.bubble_fraction(micro, stages) == \
        ref_pipeline.bubble_fraction(micro, stages)


# ----------------------------------------------- (f) the sharded train step

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


def _agree(got, want, tight, loose, share, name):
    err = np.abs(got - want)
    assert err.max() <= loose, (name, float(err.max()), loose)
    assert np.mean(err > tight) <= share, (name, float(np.mean(err > tight)))


@pytest.fixture(scope="module")
def sharded8(tmp_path_factory):
    """One 8-rank (data 4, model 2) gloo group runs the sharded steps;
    rank 0's results."""
    out = tmp_path_factory.mktemp("sharded8")
    workers.spawn(workers.sharded_train_worker, 8, str(out), (4, 2))
    return torch.load(out / "train.pt", weights_only=False)


def test_sharded_train_step_on_8_ranks_equals_one_process(sharded8):
    """granite-3-2b smoke, float32, batch (8, 33), on 8 gloo ranks as (data
    4, model 2) (the twin of tests/test_distributed.py:151), 3 steps at
    test_torch_train.py's schedule (lr 1e-2, warmup 1: step 0 trains at
    lr 0), for which its bounds hold: the losses and the global gradient norm
    within 1e-5 relative of the one-process `make_train_step`'s on the
    same weights and batches, the gathered parameters and moments within
    test_torch_train.py's bounds; the moments' placements are the ZeRO
    layout's (data on a free dim)."""
    got = sharded8
    model = workers.train_model()
    t = workers.TRAIN
    state = loop.init_train_state(model, seed=None)
    step = loop.make_train_step(model, base_lr=t["base_lr"],
                                warmup=t["warmup"],
                                total_steps=t["total_steps"])
    for i, batch in enumerate(workers.train_batches()):
        state, met = step(state, batch)
        for k in ("loss", "grad_norm", "lr", "ce"):
            np.testing.assert_allclose(got["metrics"][i][k], float(met[k]),
                                       rtol=LOSS_RTOL, err_msg=k)
    assert got["step"] == int(state.opt.step) == t["steps"]
    lr_fn = optim.cosine_schedule(t["base_lr"], t["warmup"],
                                  t["total_steps"])
    lr_sum = sum(float(lr_fn(s)) for s in range(t["steps"]))
    for name, p in state.params.items():
        want = p.detach().numpy()
        _agree(got["params"][name].numpy(), want, 1e-6 + 1e-6 * np.abs(want),
               0.02 * lr_sum, 1e-3, name)
    for tree in ("mu", "nu"):
        for name, want in getattr(state.opt, tree).items():
            scale = max(float(want.abs().max()), 1e-12)
            _agree(got[tree][name].numpy(), want.numpy(), GRAD_TOL * scale,
                   GRAD_TOL * scale, 1e-3, f"{tree}.{name}")
    assert got["placements"]["layers.0.attn.wq"] == ["S(0)", "S(1)"]
    assert got["placements"]["embed"] == ["S(1)", "S(0)"]


def test_sharded_train_step_refuses_a_batch_the_data_axes_do_not_divide(
        sharded8):
    """6 rows on 4 data ranks raise ValueError on every rank, before any
    collective, instead of training on 4 rows and dropping 2."""
    assert sharded8["refused"] == ("make_sharded_train_step: a batch of 6 "
                                   "rows on 4 data ranks")


# ------------------------------ (g) the sharded prefill and serve steps

SERVE_TOL = dict(rtol=1e-5, atol=1e-5)     # tests/test_torch_serve.py's
SERVE_ROWS = [workers.SERVE["batch"], workers.SERVE["odd_batch"]]


@pytest.fixture(scope="module")
def serve_weights(tmp_path_factory):
    """The reference's qwen3 models in float32 at smoke width and at
    SERVE_WIDE's and the WIDE archs' widened, weights drawn from SERVE's
    seed: {wide, or ("wide", arch): (model, params)}, and the directory
    whose weights.pt, weights_wide.pt and weights_wide_{arch}.pt hold
    them as the port's state dicts (`interop.model_params`)."""
    out = tmp_path_factory.mktemp("serve4")
    refs = {}
    runs = [(False, None, "weights.pt"), (True, None, "weights_wide.pt")]
    runs += [(("wide", arch), arch, f"weights_wide_{arch}.pt")
             for arch in workers.WIDE]
    for key, arch, name in runs:
        cfg = ref_config(arch or workers.SERVE["arch"], "smoke").replace(
            dtype=jnp.float32)
        wide = key is True or isinstance(key, tuple)
        if wide:
            cfg = cfg.replace(**(workers.WIDE[arch] if arch
                                 else workers.SERVE_WIDE))
        rm = ref_build(cfg)
        params = rm.init(jax.random.PRNGKey(workers.SERVE["seed"]))
        torch.save(interop.model_params(jax.tree.map(np.asarray, params),
                                        workers.serve_config(wide, arch),
                                        "cpu"),
                   out / name)
        refs[key] = (rm, params)
    for arch, wide in workers.PREFILL_CASES:
        cfg = ref_config(arch, "smoke").replace(dtype=jnp.float32)
        if wide:
            cfg = cfg.replace(**workers.PREFILL_WIDE[arch])
        rm = ref_build(cfg)
        params = rm.init(jax.random.PRNGKey(workers.SERVE["seed"]))
        torch.save(interop.model_params(jax.tree.map(np.asarray, params),
                                        workers.prefill_config(arch, wide),
                                        "cpu"),
                   workers.prefill_weights(str(out), arch, wide))
        refs["prefill", arch, wide] = (rm, params)
    for arch, wide in workers.TRAIN_CASES:
        cfg = ref_config(arch, "smoke").replace(dtype=jnp.float32)
        if wide:
            cfg = cfg.replace(**workers.PREFILL_WIDE[arch])
        rm = ref_build(cfg)
        params = rm.init(jax.random.PRNGKey(workers.TRAIN["seed"]))
        torch.save(interop.model_params(jax.tree.map(np.asarray, params),
                                        workers.prefill_config(arch, wide),
                                        "cpu"),
                   workers.train_weights(str(out), arch, wide))
        refs["train", arch, wide] = (rm, params)
    return refs, out


@pytest.fixture(scope="module")
def sharded_serve4(serve_weights):
    """One 4-rank (data 2, model 2) gloo group runs the sharded prefill
    and serve steps (`torch_dist_workers.sharded_serve_worker`); rank 0's
    results by run ("smoke", "wide", "fsdp") and batch rows."""
    out = serve_weights[1]
    workers.spawn(workers.sharded_serve_worker, 4, str(out), (2, 2))
    return torch.load(out / "serve4.pt", weights_only=False)


@pytest.fixture(scope="module")
def sharded_serve8(serve_weights):
    """One 8-rank (data 2, model 4) gloo group runs the wide models'
    serve steps; rank 0's results by run and batch rows."""
    out = serve_weights[1] / "mesh24"
    out.mkdir()
    for weights in serve_weights[1].glob("weights*.pt"):
        shutil.copy(weights, out / weights.name)
    workers.spawn(workers.sharded_serve_worker, 8, str(out), (2, 4))
    return torch.load(out / "serve8.pt", weights_only=False)


def _one_process(weights, rows, wide=False, arch=None):
    """The one-process prefill logits (None for the wide models), each
    decode step's logits and the cache after them, on the same weights,
    tokens and first cache."""
    model = workers.serve_model(weights, wide, arch)
    tokens = workers.serve_tokens(rows, arch)
    prefill = None if wide or arch else loop.make_prefill_step(model)(
        {"tokens": tokens})
    cache = workers.serve_cache(model, rows, arch is not None)
    step = loop.make_serve_step(model)
    logits = []
    for t in range(workers.SERVE["steps"]):
        cache, out = step(cache, tokens[:, t:t + 1])
        logits.append(out)
    return prefill, logits, cache


def _reference(rm, params, rows, arch=None, wide=False):
    """The reference's jitted `make_prefill_step` (not for the WIDE
    archs: None) and `make_serve_step` on the same weights,
    tokens and first cache: the prefill logits, each decode step's
    logits and the cache after them (as the port's tensors)."""
    tokens = jnp.asarray(workers.serve_tokens(rows, arch).numpy())
    prefill = None if arch else torch.from_numpy(np.array(jax.jit(
        ref_loop.make_prefill_step(rm))(params, {"tokens": tokens})))
    step = jax.jit(ref_loop.make_serve_step(rm))
    if arch is None:
        cache = rm.init_cache(rows, workers.SERVE["max_len"])
    else:                                # the port's random first cache
        first = workers.serve_cache(
            Model(workers.serve_config(wide, arch), "cpu"), rows, True)
        cache = jax.tree.map(lambda t: jnp.asarray(t.numpy()), first)
    logits = []
    for t in range(workers.SERVE["steps"]):
        cache, out = step(params, cache, tokens[:, t:t + 1])
        logits.append(torch.from_numpy(np.array(out)))
    return (prefill, logits,
            interop.model_cache(jax.tree.map(np.asarray, cache), "cpu"))


def _assert_cache(got, want, path=""):
    assert set(got) == set(want), path
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_cache(got[k], w, f"{path}{k}/")
        else:
            assert got[k].dtype == w.dtype and got[k].shape == w.shape
            np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                       err_msg=path + k, **SERVE_TOL)


def _assert_steps(got, prefill, logits, cache, logits_tol=SERVE_TOL):
    """A sharded run's logits (within ``logits_tol``) and cache against
    another's (its prefill logits too where the run has them)."""
    if "prefill" in got:
        np.testing.assert_allclose(got["prefill"].numpy(), prefill.numpy(),
                                   **SERVE_TOL)
    assert len(got["logits"]) == len(logits) == workers.SERVE["steps"]
    for g, w in zip(got["logits"], logits):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), **logits_tol)
    _assert_cache(got["cache"], cache)


@pytest.mark.parametrize("rows", SERVE_ROWS)
def test_sharded_prefill_and_serve_steps_equal_one_process(
        serve_weights, sharded_serve4, rows):
    """qwen3-0.6b smoke, float32, on 4 gloo ranks as (data 2, model 2):
    the prefill's last logits, both decode steps' logits and every cache
    leaf reassembled from its shards equal the one-process
    `make_prefill_step` / `make_serve_step` within test_torch_serve.py's
    bounds. 4 rows split over 'data' (the K/V heads over 'model'); 3 rows
    do not divide it, so every data rank computes all 3 and the cache
    puts its sequence over 'data'."""
    got = sharded_serve4["smoke"][rows]
    _assert_steps(got, *_one_process(serve_weights[1] / "weights.pt", rows))
    want = (["S(1)", "S(3)"] if rows == workers.SERVE["batch"]
            else ["S(2)", "S(3)"])
    assert got["placements"]["kv"]["k"] == want
    assert got["placements"]["length"] == ["R", "R"]


@pytest.mark.parametrize("rows", SERVE_ROWS)
def test_sharded_prefill_and_serve_steps_equal_reference(
        serve_weights, sharded_serve4, rows):
    """The same 4-rank run against the reference's jitted prefill and
    serve steps on the same weights and tokens: the gathered prefill
    logits, each decode step's logits and every cache leaf reassembled
    from its shards, within test_torch_serve.py's bounds."""
    rm, params = serve_weights[0][False]
    _assert_steps(sharded_serve4["smoke"][rows],
                  *_reference(rm, params, rows))


# the wide model's cache layouts: (mesh, rows) -> k's placements
WIDE_CACHE = {((2, 2), 4): ["S(1)", "S(3)"],   # rows over 'data', KV heads
              ((2, 2), 3): ["S(2)", "S(3)"],   # + the sequence over 'data'
              ((2, 4), 4): ["S(1)", "S(2)"],   # the sequence over 'model'
              ((2, 4), 3): ["S(2)", "R"]}      # over 'data'; 'model' whole


@pytest.mark.parametrize("rows", SERVE_ROWS)
@pytest.mark.parametrize("shape", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
def test_tensor_parallel_serve_step_equals_reference_and_one_process(
        serve_weights, sharded_serve4, sharded_serve8, shape, rows):
    """SERVE_WIDE's model (every parameter rule fires: wq, wo, the MLP
    and the embedding split over 'model', wk and wv replicated) on 4 gloo
    ranks as (data 2, model 2) and on 8 as (data 2, model 4): both decode
    steps' logits and every cache leaf reassembled from its shards equal
    the reference's jitted `make_serve_step` on the same weights and the
    one-process port step, within test_torch_serve.py's 1e-5. The four
    cache layouts cover the KV heads over 'model', the sequence over
    'model' (the log-sum-exp combine over 'model') and, for the 3 rows,
    over 'data' (the combine over 'data')."""
    got = (sharded_serve4 if shape == (2, 2) else sharded_serve8)["wide"][rows]
    assert got["reads_model_params"] is False
    assert got["placements"]["kv"]["k"] == WIDE_CACHE[shape, rows]
    placed = got["param_placements"]
    assert placed["layers.0.attn.wq"] == placed["layers.1.mlp.w_down"] == \
        ["R", "S(1)"]
    assert placed["layers.0.attn.wk"] == ["R", "R"]
    assert placed["embed"] == ["R", "S(0)"]
    rm, params = serve_weights[0][True]
    _, logits, cache = _reference(rm, params, rows)
    _assert_steps(got, None, logits, cache)
    _assert_steps(got, *_one_process(serve_weights[1] / "weights_wide.pt",
                                     rows, wide=True))


def test_tensor_parallel_serve_step_with_fsdp_parameters(serve_weights,
                                                         sharded_serve4):
    """The wide model's parameters in the FSDP layout (fan-in over
    'data', the embedding's width too) on (data 2, model 2): the step
    gathers each over 'data' and computes on its 'model' shard; logits
    and cache equal the one-process step within 1e-5."""
    got = sharded_serve4["fsdp"][workers.SERVE["batch"]]
    placed = got["param_placements"]
    assert placed["layers.0.attn.wq"] == ["S(0)", "S(1)"]
    assert placed["embed"] == ["S(1)", "S(0)"]
    _assert_steps(got, *_one_process(serve_weights[1] / "weights_wide.pt",
                                     workers.SERVE["batch"], wide=True))


# the moe runs' cache layouts: (arch, mesh, rows) -> each leaf's placements
MOE_CACHE = {
    ("dbrx-132b", (2, 2), 4): {"moe_kv": ["S(1)", "S(3)"]},   # KV heads
    ("dbrx-132b", (2, 2), 3): {"moe_kv": ["S(2)", "S(3)"]},
    ("dbrx-132b", (2, 4), 4): {"moe_kv": ["S(1)", "S(2)"]},   # sequence
    ("dbrx-132b", (2, 4), 3): {"moe_kv": ["S(2)", "R"]},
    ("deepseek-v3-671b", (2, 2), 4): {"dense_kv": ["S(1)", "S(3)"],
                                      "ckv": ["S(1)", "S(2)"]},
    ("deepseek-v3-671b", (2, 2), 3): {"dense_kv": ["S(2)", "S(3)"],
                                      "ckv": ["S(2)", "R"]},
    ("deepseek-v3-671b", (2, 4), 4): {"dense_kv": ["S(1)", "S(3)"],
                                      "ckv": ["S(1)", "S(2)"]},
    ("deepseek-v3-671b", (2, 4), 3): {"dense_kv": ["S(2)", "S(3)"],
                                      "ckv": ["S(2)", "R"]}}
# parameters whose placement shows each rule of the moe layout
MOE_PARAMS = {
    "dbrx-132b": {"moe_layers.0.moe.experts.w_gate": ["R", "S(0)"],
                  "moe_layers.1.moe.experts.w_down": ["R", "S(0)"],
                  "moe_layers.0.moe.router": ["R", "R"],
                  "moe_layers.0.attn.wq": ["R", "S(1)"],
                  "moe_layers.0.attn.wk": ["R", "R"]},
    "deepseek-v3-671b": {"moe_layers.0.moe.experts.w_up": ["R", "S(0)"],
                         "moe_layers.0.moe.router": ["R", "S(1)"],
                         "moe_layers.0.moe.shared.w_down": ["R", "S(1)"],
                         "moe_layers.1.attn.w_dq": ["R", "S(1)"],
                         "moe_layers.0.attn.w_dkv": ["R", "S(1)"],
                         "moe_layers.0.attn.w_ukv": ["R", "S(1)"],
                         "moe_layers.0.attn.q_norm": ["R", "S(0)"],
                         "moe_layers.0.attn.kv_norm": ["R", "S(0)"],
                         "moe_layers.0.attn.wo": ["R", "S(1)"],
                         "dense_layers.0.attn.wk": ["R", "S(1)"]}}


@pytest.mark.parametrize("rows", SERVE_ROWS)
@pytest.mark.parametrize("shape", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
@pytest.mark.parametrize("arch", list(workers.MOE_WIDE))
def test_tensor_parallel_moe_serve_step_equals_reference_and_one_process(
        serve_weights, sharded_serve4, sharded_serve8, arch, shape, rows):
    """The moe family's tensor-parallel serve step: dbrx's smoke widened
    (GQA; 4 experts over 'model', expert parallel) and deepseek's (1
    dense + 2 MLA/MoE layers, 128 experts, the router's columns split)
    on 4 gloo ranks as (data 2, model 2) and on 8 as (data 2, model 4),
    from a random first cache and random lengths (so that a sequence
    split over several ranks is attended over several of them): both
    decode steps' logits and every cache leaf (``moe_kv``; ``dense_kv``,
    ``ckv``, ``kpe``) and ``length`` reassembled from its shards equal
    the reference's jitted `make_serve_step` on the same weights and
    the one-process port step, within test_torch_serve.py's 1e-5. The
    layouts cover dbrx's KV heads and its sequence over 'model', MLA's
    latent sequence over 'model' and, for 3 rows, over 'data'."""
    got = (sharded_serve4 if shape == (2, 2) else sharded_serve8)[arch][rows]
    assert got["reads_model_params"] is False
    for leaf, want in MOE_CACHE[arch, shape, rows].items():
        assert got["placements"][leaf] == (want if leaf == "ckv" else
                                           {"k": want, "v": want})
    if arch == "deepseek-v3-671b":
        assert got["placements"]["kpe"] == got["placements"]["ckv"]
    for name, want in MOE_PARAMS[arch].items():
        assert got["param_placements"][name] == want, name
    rm, params = serve_weights[0]["wide", arch]
    _, logits, cache = _reference(rm, params, rows, arch, wide=True)
    _assert_steps(got, None, logits, cache)
    _assert_steps(got, *_one_process(
        serve_weights[1] / f"weights_wide_{arch}.pt", rows, wide=True,
        arch=arch))


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
@pytest.mark.parametrize("arch", list(workers.MOE_WIDE))
def test_expert_parallel_moe_block_drops_what_one_process_drops(
        sharded_serve4, sharded_serve8, arch, shape):
    """`moe_block` of each widened moe smoke on (1, 63) tokens that
    mostly choose the same experts, expert parallel on the rank's shards
    (dbrx 2 or 1 of 4 experts a rank, deepseek 64 or 32 of 128), equals
    the one-process block within 1e-5, its auxiliary loss too, with
    choices dropped by the capacity: the ranks drop what one process
    drops."""
    got = (sharded_serve4 if shape == (2, 2) else sharded_serve8)[
        "ep_moe", arch]
    cfg = workers.serve_config(True, arch)
    assert got["local_experts"] == cfg.n_experts // shape[1]
    assert got["dropped"] > 0
    np.testing.assert_allclose(got["out"].numpy(), got["want"].numpy(),
                               **SERVE_TOL)
    np.testing.assert_allclose(float(got["aux"]), float(got["want_aux"]),
                               **SERVE_TOL)


# the SSM, hybrid and encoder-decoder runs' cache layouts: (arch, mesh,
# rows) -> each leaf's placements; mamba2's and the hybrid's recurrent
# states lie alike on both meshes (their channels or heads over 'model'),
# and so does the hybrid's ring (its 1 KV head does not divide 'model'):
# its 16 positions over 'model' for 4 rows, over 'data' for 3; whisper's
# K/V and memory lie as WIDE_CACHE's 2 KV heads
FAMILY_CACHE = {}
for _shape in ((2, 2), (2, 4)):
    for _rows, _r in ((4, "S(1)"), (3, "R")):
        FAMILY_CACHE["mamba2-2.7b", _shape, _rows] = {
            "conv": [_r, "S(3)"], "ssm": [_r, "S(2)"]}
        _c = "S(2)" if _rows == 4 else "R"
        FAMILY_CACHE["recurrentgemma-2b", _shape, _rows] = {
            "conv": [_c, "S(4)"], "h": [_c, "S(3)"], "tail_conv": [_c, "S(4)"],
            "tail_h": [_c, "S(3)"],
            "kv": ["S(1)", "S(2)"] if _rows == 4 else ["S(2)", "R"]}
        _kv = WIDE_CACHE[_shape, _rows]
        FAMILY_CACHE["whisper-base", _shape, _rows] = {
            "kv": _kv, "mem_k": _kv, "mem_v": _kv}
# the FAMILY_WIDE models' logits: the bound of tests/test_torch_models.py
# and test_torch_ssd.py for a model's logits (TOL32), against the
# reference's and the one-process step's. At d_model 128 these logits
# reach 70-90 (a token's own embedding), where SERVE_TOL's atol of 1e-5
# is about one float32 step of the row's scale: there the one-process
# port step misses the reference's on one or two of the 2048 logits of
# mamba2's and recurrentgemma's steps, and the ring's log-sum-exp
# combine over 4 ranks misses the one-process attention on one. Every
# cache leaf is held to both at SERVE_TOL.
FAMILY_LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
# parameters whose placement shows each rule of these layouts
FAMILY_PARAMS = {
    "mamba2-2.7b": {"layers.0.ssd.in_proj": ["R", "S(1)"],
                    "layers.1.ssd.conv_w": ["R", "S(1)"],
                    "layers.0.ssd.conv_b": ["R", "S(0)"],
                    "layers.0.ssd.out_norm": ["R", "S(0)"],
                    "layers.1.ssd.out_proj": ["R", "S(1)"],
                    "layers.0.ssd.a_log": ["R", "R"],
                    "layers.0.ln": ["R", "S(0)"]},
    "recurrentgemma-2b": {"super.0.b0_rglru.rglru.w_x": ["R", "S(1)"],
                          "super.1.b1_rglru.rglru.w_r": ["R", "S(1)"],
                          "super.0.b1_rglru.rglru.conv_w": ["R", "S(1)"],
                          "tail.0.b0_rglru.rglru.lam": ["R", "S(0)"],
                          "tail.0.b0_rglru.rglru.w_out": ["R", "S(1)"],
                          "super.0.b2_attn.attn.wk": ["R", "S(1)"],
                          "super.1.b2_attn.attn.wo": ["R", "S(1)"]},
    "whisper-base": {"decoder.0.self_attn.wk": ["R", "S(1)"],
                     "decoder.1.cross_attn.wq": ["R", "S(1)"],
                     "decoder.0.cross_attn.wo": ["R", "S(1)"],
                     "decoder.0.ln_x": ["R", "S(0)"],
                     "decoder.1.mlp.w_in": ["R", "S(1)"]}}


@pytest.mark.parametrize("rows", SERVE_ROWS)
@pytest.mark.parametrize("shape", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
@pytest.mark.parametrize("arch", list(workers.FAMILY_WIDE))
def test_tensor_parallel_family_serve_step_equals_reference_and_one_process(
        serve_weights, sharded_serve4, sharded_serve8, arch, shape, rows):
    """The tensor-parallel serve step of the SSM, hybrid and
    encoder-decoder families: their smokes widened by FAMILY_WIDE
    (mamba2 on its heads and channels; recurrentgemma's RG-LRU on its
    channels, 2 super-blocks and a recurrent tail, its ring of 16
    positions split over 'model' and, for 3 rows, over 'data'; whisper's
    self-attention cache and memory on their KV heads or, on (2, 4),
    their sequence) on 4 gloo ranks as (data 2, model 2) and on 8 as
    (data 2, model 4), from a random first cache and random lengths (the
    hybrid's up to 3 windows, so that the ring wraps across its shards):
    every cache leaf and ``length`` reassembled from its shards equal
    the reference's jitted `make_serve_step` on the same weights and the
    one-process port step within test_torch_serve.py's 1e-5, and both
    decode steps' logits equal theirs within FAMILY_LOGITS_TOL. The step
    never reads the model's own parameters."""
    got = (sharded_serve4 if shape == (2, 2) else sharded_serve8)[arch][rows]
    assert got["reads_model_params"] is False
    for leaf, want in FAMILY_CACHE[arch, shape, rows].items():
        placed = got["placements"][leaf]
        assert placed == ({"k": want, "v": want} if leaf == "kv" else want)
    for name, want in FAMILY_PARAMS[arch].items():
        assert got["param_placements"][name] == want, name
    rm, params = serve_weights[0]["wide", arch]
    _, logits, cache = _reference(rm, params, rows, arch, wide=True)
    _assert_steps(got, None, logits, cache, FAMILY_LOGITS_TOL)
    _assert_steps(got, *_one_process(
        serve_weights[1] / f"weights_wide_{arch}.pt", rows, wide=True,
        arch=arch), FAMILY_LOGITS_TOL)


# parameters of the widened prefill cases whose placement shows that the
# split rules fire: the projections over 'model' (the KV heads' columns
# of qwen3's and internvl2's wk on two ranks of 4), the SSM's and the
# RG-LRU's as FAMILY_PARAMS
PREFILL_PARAMS = {
    "qwen3-0.6b": {"layers.0.attn.wo": ["R", "S(1)"],
                   "layers.0.attn.wk": ["R", "S(1)"]},
    "internvl2-76b": {"layers.0.attn.wo": ["R", "S(1)"],
                      "layers.0.attn.wk": ["R", "S(1)"]},
    "dbrx-132b": {"moe_layers.0.attn.wo": ["R", "S(1)"]},
    "deepseek-v3-671b": {"moe_layers.0.attn.wo": ["R", "S(1)"]},
    **FAMILY_PARAMS}
# the prefill cases' logits: the smokes' at SERVE_TOL; the widened
# models' at FAMILY_LOGITS_TOL (TOL32), as the widened serve steps': their
# logits reach 70-100
PREFILL_IDS = [f"{arch}-{'wide' if wide else 'smoke'}"
               for arch, wide in workers.PREFILL_CASES]
_PREFILL_WANT: dict = {}


def _prefill_wants(serve_weights, arch, wide, rows, length):
    """The reference's jitted `make_prefill_step` and the one-process
    port `make_prefill_step` on a PREFILL_CASES case's weights and
    `prefill_batch` (cached: both meshes compare with them)."""
    key = arch, wide, rows, length
    if key not in _PREFILL_WANT:
        rm, params = serve_weights[0]["prefill", arch, wide]
        cfg = workers.prefill_config(arch, wide)
        batch = workers.prefill_batch(cfg, rows, length)
        ref = torch.from_numpy(np.array(jax.jit(
            ref_loop.make_prefill_step(rm))(
                params, {k: jnp.asarray(v.numpy())
                         for k, v in batch.items()})))
        model = Model(cfg, "cpu")
        model.load_state_dict(torch.load(workers.prefill_weights(
            str(serve_weights[1]), arch, wide)))
        _PREFILL_WANT[key] = ref, loop.make_prefill_step(model)(batch)
    return _PREFILL_WANT[key]


@pytest.mark.parametrize("rows", SERVE_ROWS)
@pytest.mark.parametrize("shape", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
@pytest.mark.parametrize("case", workers.PREFILL_CASES, ids=PREFILL_IDS)
def test_tensor_parallel_prefill_step_equals_reference_and_one_process(
        serve_weights, sharded_serve4, sharded_serve8, case, shape, rows):
    """The tensor-parallel prefill of every family
    (`torch_dist_workers.PREFILL_CASES`: qwen3 and internvl2, with its
    patches, at smoke width and widened so that a KV head's columns lie
    on two of 4 ranks; dbrx's and deepseek's MLA smokes widened by
    MOE_WIDE; mamba2, recurrentgemma and whisper, with its frames, at
    smoke width and widened by FAMILY_WIDE, whose 2 heads take the heads
    rule on 2 'model' ranks and the context rule on 4) on 4 gloo ranks
    as (data 2, model 2) and on 8 as (data 2, model 4), 4 rows over
    'data' and 3 rows whole, at prompt lengths that 'model' does not
    divide (the sequence padded at its end; 71 tokens span several SSD
    chunks and hybrid windows; 27 frames pad the encoder's): the last
    logits equal the reference's jitted `make_prefill_step` and the
    one-process port step on the same weights and batch, the smokes'
    within 1e-5 and the widened models' within TOL32. The step never
    reads the model's own parameters."""
    arch, wide = case
    got = (sharded_serve4 if shape == (2, 2) else sharded_serve8)[
        "prefill"][case]
    assert got["reads_model_params"] is False
    if wide:
        placed = got["param_placements"]
        for name, want in PREFILL_PARAMS.get(arch, {}).items():
            assert placed[name] == want, name
    tol = FAMILY_LOGITS_TOL if wide else SERVE_TOL
    for length in workers.prefill_lengths(arch):
        logits = got["logits"][rows, length]
        for want in _prefill_wants(serve_weights, arch, wide, rows, length):
            assert logits.shape == want.shape
            np.testing.assert_allclose(logits.numpy(), want.numpy(),
                                       err_msg=f"length {length}", **tol)


CENSUS_SCRIPT = """
import json, torch
from torch.distributed.tensor import distribute_tensor
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import Model
from repro_torch.train.loop import make_sharded_serve_step
import torch_dist_workers as workers
dryrun._fake_group(256)
mesh = sharding.device_mesh(make_production_mesh(), "cpu")
sharding.set_mesh(mesh)
model = Model(workers.serve_config(True), "meta")
rows, max_len = {rows}, {max_len}

def placed(t, sh):
    return distribute_tensor(t, mesh, sh.placements, src_data_rank=None)

p_sh = sharding.param_shardings(model, mesh)
params = {{n: placed(p.detach(), p_sh[n])
          for n, p in model.named_parameters()}}
cache = model.init_cache(rows, max_len, device="meta")
c_sh = sharding.cache_shardings(cache, mesh)
cache = {{"length": placed(cache["length"], c_sh["length"]),
         "kv": {{k: placed(v, c_sh["kv"][k])
                for k, v in cache["kv"].items()}}}}
tokens = torch.zeros((rows, 1), dtype=torch.int32, device="meta")
counter = dryrun.OpCounter()
with counter:
    make_sharded_serve_step(model, mesh)(params, cache, tokens)
full = {{n: p.numel() * p.element_size() for n, p in params.items()
        if any(pl.is_shard() for pl in p.placements)}}
k = cache["kv"]["k"]
local = k.to_local()
print(json.dumps({{"gathers": [b for kind, b in counter.collectives
                              if kind == "all-gather"],
                  "kinds": sorted({{kind for kind, _ in counter.collectives}}),
                  "full_params": full,
                  "cache_rows": k.numel() * k.element_size() * local.shape[1]
                                // k.shape[1],
                  "kv_local": list(local.shape)}}))
torch.distributed.destroy_process_group()
"""


def test_tensor_parallel_serve_step_gathers_no_parameter_or_cache_row():
    """The census on a fake (16, 16) group of 256 ranks (no data moves),
    SERVE_WIDE's model on meta tensors, 32 rows of a 64-position cache
    (2 rows a data rank; 2 KV heads do not divide 16, so 4 positions a
    'model' rank): the all-gathers of the step (`launch.dryrun.OpCounter`)
    are exactly the activations' (a layer's two norms, whose scales
    'model' splits, q, the attention's output product and the MLP's
    three, then the logits, float32 rows of the rank's 2 rows; the 32
    lengths over 'data'), each smaller than the full tensor of every
    matrix that 'model' splits and than the rank's rows of a cache leaf
    (what gathering them would move), and of no parameter's full size;
    the only other collective is the all-reduce (the embedding's sum and
    the log-sum-exp combine)."""
    script = CENSUS_SCRIPT.format(rows=32, max_len=64)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"),
         *filter(None, [env.get("PYTHONPATH")])])
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    cfg = workers.serve_config(True)
    rows, f32 = 2, 4
    assert got["kv_local"] == [cfg.n_layers, rows, 4, 2, cfg.d_head]
    assert got["kinds"] == ["all-gather", "all-reduce"]
    layer = [rows * cfg.d_model * f32] * 5 + [rows * cfg.d_ff * f32] * 2
    want = layer * cfg.n_layers + [rows * cfg.padded_vocab * f32, 32 * 4]
    assert sorted(got["gathers"]) == sorted(want)
    # wq, wo and the MLP's three a layer, the two norm scales, the embedding
    assert len(got["full_params"]) == cfg.n_layers * 7 + 1
    matrices = [b for n, b in got["full_params"].items() if "ln" not in n]
    assert max(want) < min(min(matrices), got["cache_rows"])
    assert not set(want) & set(got["full_params"].values())


# FULL_CENSUS_SCRIPT's record in a subprocess (`torch_dist_workers`)
_full_census = workers.full_census


# the census's models: the full configs cut in depth (meta tensors, bf16)
MOE_CENSUS = {"dbrx-132b": dict(n_layers=2),
              "deepseek-v3-671b": dict(n_layers=2, n_dense_layers=1)}


@pytest.mark.parametrize("arch", list(MOE_CENSUS))
def test_tensor_parallel_moe_serve_step_gathers_no_parameter_or_cache_row(
        arch):
    """The census of the moe step on a fake (16, 16) group of 256 ranks
    (no data moves): each full config at full width, cut in depth (dbrx
    2 MoE layers; deepseek 1 dense + 1 MLA/MoE), on meta tensors, 32
    rows of an 8192-position cache (2 rows a data rank). No all-gather is
    as large as any matrix that 'model' splits or as the rank's rows of
    any cache leaf (what gathering them would move), and none is any
    matrix parameter's full size (deepseek's router logits, 256 bf16 a
    row, are as large as its kv_norm scale); the rank holds E / 16
    experts; the
    all-reduces are exactly the embedding's sum, each sequence-sharded
    attention's log-sum-exp combine (a max and a sum, float32) and each
    MoE layer's expert all-reduce of the (r, n, d) gathered slots, r x n
    x d x 2 bytes (r = 2 rows, n = top-k choices a row)."""
    cut = MOE_CENSUS[arch]
    got = _full_census(arch, cut, 32, 8192)
    cfg = get_config(arch, "full").replace(**cut)
    r, bf16, f32 = 2, 2, 4
    n_moe = cfg.n_layers - cfg.n_dense_layers
    expert = r * cfg.top_k * cfg.d_model * bf16
    if cfg.use_mla:       # MLA's context: kv_lora features, 128 heads
        combine = [r * cfg.n_heads * f32,
                   r * cfg.n_heads * (cfg.kv_lora_rank + 1) * f32]
    else:                 # dbrx's 8 KV heads: the sequence over 'model'
        combine = [r * cfg.n_heads * f32,
                   r * cfg.n_heads * (cfg.d_head + 1) * f32]
    want_reduce = [r * cfg.d_model * bf16] + (combine + [expert]) * n_moe
    reduces = [b for kind, b in got["collectives"] if kind == "all-reduce"]
    gathers = [b for kind, b in got["collectives"] if kind == "all-gather"]
    assert sorted(reduces) == sorted(want_reduce)
    assert {kind for kind, _ in got["collectives"]} == {"all-gather",
                                                        "all-reduce"}
    assert got["experts_local"][0] == cfg.n_experts // 16
    assert max(gathers) < min(min(got["split_params"]),
                              min(got["cache_rows"].values()))
    assert not set(gathers) & set(got["matrices"])


# the census's models: the full configs cut in depth (mamba2 2 of 64
# layers; recurrentgemma 5 of 26, one super-block and the recurrent
# tail; whisper 2 + 2 of 6 + 6), meta tensors, bf16
FAMILY_CENSUS = {"mamba2-2.7b": dict(n_layers=2),
                 "recurrentgemma-2b": dict(n_layers=5),
                 "whisper-base": dict(n_layers=2, n_encoder_layers=2)}


def _family_activations(cfg, r: int) -> tuple[list, list]:
    """The all-gathers (bytes, output) and the all-reduces of the
    tensor-parallel decode of ``cfg`` (full width, bf16, 16 'model'
    ranks) on ``r`` rows a rank: every product's output row, every
    split norm's row, the SSM's convolved input and y and the RG-LRU's
    convolved input and y, then the logits (float32) and the 32 lengths
    (int32); the embedding's sum and each sequence-sharded attention's
    log-sum-exp combine (a max of r x Hq and a sum of r x Hq x (D + 1),
    float32). No norm's sum of squares is reduced: the SSM gathers y
    before its norm."""
    bf16, f32 = 2, 4
    d, ff = cfg.d_model, cfg.d_ff

    def row(n):
        return r * n * bf16

    combine = [r * cfg.n_heads * f32, r * cfg.n_heads * (cfg.d_head + 1) * f32]
    mlp = [row(ff)] * (2 if cfg.mlp_type == "swiglu" else 1) + [row(d)]
    gathers, reduces = [], [row(d)]
    if cfg.family == "ssm":
        di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        per = [row(d), row(2 * di + 2 * n + h), row(di + 2 * n), row(di),
               row(di), row(d)]
        gathers += per * cfg.n_layers
    elif cfg.family == "hybrid":
        w = cfg.lru_width
        attn = [row(cfg.n_heads * cfg.d_head)] + [row(cfg.d_head)] * 2 \
            + [row(d)]
        for kind in cfg.block_pattern * (cfg.n_layers // len(
                cfg.block_pattern)) + cfg.block_pattern[:cfg.n_layers % len(
                    cfg.block_pattern)]:
            if kind == "attn":
                gathers += [row(d)] + attn + [row(d)] + mlp
                reduces += combine
            else:
                gathers += [row(d), row(w), row(w), row(d), row(d)] + mlp
    else:                                            # encdec
        hd = cfg.n_heads * cfg.d_head
        self_attn = [row(hd)] * 3 + [row(d)]
        cross = [row(hd), row(d)]
        gathers += ([row(d)] + self_attn + [row(d)] + cross + [row(d)]
                    + mlp) * cfg.n_layers
        reduces += combine * 2 * cfg.n_layers
    return gathers + [r * cfg.padded_vocab * f32, 32 * 4], reduces


@pytest.mark.parametrize("arch", list(FAMILY_CENSUS))
def test_tensor_parallel_family_serve_step_gathers_no_parameter_or_cache_row(
        arch):
    """The census of the SSM, hybrid and encoder-decoder serve steps on a
    fake (16, 16) group of 256 ranks (no data moves): each full config
    at full width, cut in depth (FAMILY_CENSUS), on meta tensors, 32
    rows of an 8192-position cache (2 rows a data rank; recurrentgemma's
    ring of 2048 and whisper's 8 KV heads, self and memory, split their
    sequence over 'model'; mamba2's 80 heads and every state's channels
    split over 'model'). The all-gathers are exactly the activations'
    (`_family_activations`); each but the logits (the step's output, 2
    rows x the vocabulary, float32) is smaller than every split weight
    matrix (both dims 128 or more; the (4, C) convolution filters are
    not matrices) and than the rank's rows of every cache and state
    leaf, which is what gathering them would move; none is any matrix's
    full size; the all-reduces are exactly the embedding's sum and each
    sequence-sharded attention's log-sum-exp combine. The step never
    reads the model's parameters."""
    cut = FAMILY_CENSUS[arch]
    got = _full_census(arch, cut, 32, 8192)
    cfg = get_config(arch, "full").replace(**cut)
    want_gather, want_reduce = _family_activations(cfg, 2)
    gathers = [b for kind, b in got["collectives"] if kind == "all-gather"]
    reduces = [b for kind, b in got["collectives"] if kind == "all-reduce"]
    assert got["reads_model_params"] is False
    assert {kind for kind, _ in got["collectives"]} == {"all-gather",
                                                        "all-reduce"}
    assert sorted(gathers) == sorted(want_gather)
    assert sorted(reduces) == sorted(want_reduce)
    logits = 2 * cfg.padded_vocab * 4
    activations = [b for b in gathers if b != logits]
    assert max(activations) < min(min(got["split_matrices"]),
                                  min(got["cache_rows"].values()))
    assert not set(gathers) & set(got["matrices"])


# the prefill census's models: the full configs cut in depth as the dry
# run's --layers cuts them (qwen3, internvl2 and dbrx 2 layers; deepseek 5,
# 1 dense + 4 MLA/MoE), and as FAMILY_CENSUS (mamba2 2 of 64 layers;
# recurrentgemma 5 of 26, one super-block with its attention layer and
# the recurrent tail; whisper 2 + 2 of 6 + 6), meta tensors, bf16, 32
# rows of 32768 tokens (2 a data rank; internvl2's 256 patches before
# them, whisper's encoder over its 1536 frames)
PREFILL_CENSUS = {"qwen3-0.6b": dict(n_layers=2),
                  "internvl2-76b": dict(n_layers=2),
                  "dbrx-132b": dict(n_layers=2),
                  "deepseek-v3-671b": dict(n_layers=5, n_dense_layers=1),
                  **FAMILY_CENSUS}
PREFILL_CENSUS_LEN = 32768


@pytest.fixture(scope="module")
def prefill_census():
    """FULL_CENSUS_SCRIPT's prefill record of each PREFILL_CENSUS cell,
    the subprocesses at once."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(PREFILL_CENSUS)) as pool:
        got = pool.map(lambda arch: _full_census(
            arch, PREFILL_CENSUS[arch], 32, PREFILL_CENSUS_LEN, prefill=True),
            PREFILL_CENSUS)
        return dict(zip(PREFILL_CENSUS, got))


def _prefill_expected(cfg, got: dict, rows: int, length: int, n: int = 16):
    """Rank 0's tensor-parallel prefill of ``cfg`` on ``rows`` rows of
    ``length`` tokens and 'model' of ``n``, from the layout the census
    reports (``model_split``, ``param_bytes``): its collectives by type
    as sorted output bytes (``moves``: the whole parameters it gathers and
    the weight pieces its all-to-alls bring, by name), its FLOPs, and
    the one-process model's products and attention divided by ``n`` plus
    the last position's unembedding on the rank's vocab rows. The FLOPs
    differ from the latter by exactly the products that every rank runs
    whole: the KV heads its q heads read (8 KV heads on 16 ranks: one
    whole head a rank, two ranks a head), the router and MLA's
    ``w_dq``/``w_dkv``."""
    bf16, f32 = 2, 4
    d = cfg.d_model
    split = set(got["model_split"])
    size = {name: b[0] for name, b in got["param_bytes"].items()}
    seq = length + (cfg.n_patches if cfg.family == "vlm" else 0)
    assert seq % n == 0                        # no pads at these lengths
    t, loc = rows * seq, seq // n
    out = {"all-gather": [], "reduce-scatter": [], "all-reduce": [],
           "all-to-all": []}
    moves = {}
    flops = [0, 0]                             # [this rank, one process / n]

    def mm(m, k, cols, whole=False):
        """A product of m rows by (k, cols): 1/n of it on the rank, or
        the whole."""
        flops[0] += 2 * m * k * cols // (1 if whole else n)
        flops[1] += 2 * m * k * cols / n

    def whole(name):
        if name in split:
            out["all-gather"].append(size[name])
            moves[name] = "whole"

    def rows_of(name, k):                      # a row product's weight
        mm(t, k, d)
        if name in split:
            out["all-to-all"].append(k // n * d * bf16)
            moves[name] = "rows"

    def attention(heads, dqk, dv):
        flops[0] += 2 * rows * heads // n * seq * seq * (dqk + dv)
        flops[1] += 2 * rows * heads * seq * seq * (dqk + dv) / n

    def sub_block(norm, length=seq):
        out["all-gather"].append(rows * length * d * bf16)
        out["reduce-scatter"].append(rows * length // n * d * bf16)
        whole(norm)

    def gqa(pre):
        sub_block(pre + "ln1")
        hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        if cfg.qk_norm:
            whole(pre + "attn.q_norm")
            whole(pre + "attn.k_norm")
        mm(t, d, hq * dh)
        kv = max(hkv // n, 1) * dh             # the rank's whole KV heads
        for w in ("wk", "wv"):
            flops[0] += 2 * t * d * kv
            flops[1] += 2 * t * d * hkv * dh / n
            if pre + "attn." + w in split and hkv < n:
                out["all-to-all"].append(d * kv * bf16)
                moves[pre + "attn." + w] = "kv heads"
        attention(hq, dh, dh)
        rows_of(pre + "attn.wo", hq * dh)

    def mla(pre):
        sub_block(pre + "ln1")
        h, qr, kvr = cfg.n_heads, cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        for name in ("w_dq", "attn.q_norm", "w_dkv", "attn.kv_norm"):
            whole(pre + ("attn." + name if name.startswith("w_") else name))
        mm(t, d, qr, whole=True)
        mm(t, qr, h * (dn + dr))
        mm(t, d, kvr + dr, whole=True)
        mm(t, kvr, h * (dn + dv))
        attention(h, dn + dr, dv)
        rows_of(pre + "attn.wo", h * dv)

    def ffn(pre, ff, tokens=t):
        for _ in range(2 if cfg.mlp_type == "swiglu" else 1):
            mm(tokens, d, ff)
        mm(tokens, ff, d)
        if pre + "w_down" in split:
            out["all-to-all"].append(ff // n * d * bf16)
            moves[pre + "w_down"] = "rows"

    def by_context(pre, attn, norm, length, kv_len, memory=False):
        """An attention whose q heads 'model' does not divide: the rank's
        positions through the whole wq, wk, wv and wo; K/V of the rank's
        positions gathered along the sequence, or of the whole memory on
        every rank."""
        whole(pre + norm)
        hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        for w in ("wq", "wk", "wv", "wo"):
            whole(f"{pre}{attn}.{w}")
        m = rows * length // n                 # the rank's positions
        mm(m * n, d, hq * dh)
        if memory:
            mm(rows * kv_len, d, 2 * hkv * dh, whole=True)
        else:
            mm(m * n, d, 2 * hkv * dh)
            out["all-gather"].append(rows * kv_len * 2 * hkv * dh * bf16)
        flops[0] += 2 * rows * hq * (length // n) * kv_len * 2 * dh
        flops[1] += 2 * rows * hq * length * kv_len * 2 * dh / n
        mm(m * n, hq * dh, d)

    def ssd(pre):
        sub_block(pre + "ln")
        di, ns, h, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
            cfg.ssm_headdim
        cols = 2 * (h // n) * hp + 2 * ns + h // n   # z, xs, B and C, dt
        flops[0] += 2 * t * d * cols
        flops[1] += 2 * t * d * (2 * di + 2 * ns + h) / n
        out["all-to-all"].append(cols * d * bf16)
        moves[pre + "ssd.in_proj"] = "columns"
        whole(pre + "ssd.conv_w")
        whole(pre + "ssd.conv_b")
        flops[0] += got["scan_flops"][0]
        flops[1] += got["scan_flops"][1] / n
        out["all-reduce"].append(rows * seq * f32)   # the norm's squares
        rows_of(pre + "ssd.out_proj", di)

    def rglru(pre):
        sub_block(pre + "ln1")
        w = cfg.lru_width
        mm(t, d, w)                            # w_gate
        mm(t, d, w)                            # w_x
        out["all-gather"].append(rows * seq * w * bf16)   # its channels
        mm(t, w, w)                            # w_r
        mm(t, w, w)                            # w_i
        rows_of(pre + "rglru.w_out", w)

    def moe(pre):
        sub_block(pre + "ln2")
        e, k = cfg.n_experts, cfg.top_k
        whole(pre + "moe.router")
        if pre + "moe.router" in split:        # gathered after its cast
            out["all-gather"][-1] = d * e * bf16
        mm(t, d, e, whole=True)
        # the rank's rows of the global grid: 16 data ranks' 2 x 32768
        # tokens route as 32 rows of 32768, 2 a rank (its own grid would
        # be 32 rows of 2048: the same slots, 32 x 640 = 2 x 10240 for
        # dbrx, 32 x 80 = 2 x 1280 for deepseek)
        r, length = routing_grid(t, 16)
        choices = length * k
        cap = max(int(choices / e * cfg.capacity_factor), 4)
        cap = (cap + 7) // 8 * 8
        for _ in range(3 if cfg.mlp_type == "swiglu" else 2):
            mm(e * r * cap, d, cfg.d_ff_expert)
        shared = cfg.n_shared_experts * cfg.d_ff_expert
        if shared:
            ffn(pre + "moe.shared.", shared)
        out["reduce-scatter"][-1] = rows * loc * (k + bool(shared)) * d * bf16

    def dense(pre):
        gqa(pre)
        sub_block(pre + "ln2")
        ffn(pre + "mlp.", cfg.d_ff)

    out["reduce-scatter"].append(rows * loc * d * bf16)      # the embedding
    if cfg.family == "moe":
        for i in range(cfg.n_dense_layers):
            dense(f"dense_layers.{i}.")
        for i in range(cfg.n_layers - cfg.n_dense_layers):
            pre = f"moe_layers.{i}."
            mla(pre) if cfg.use_mla else gqa(pre)
            moe(pre)
    elif cfg.family == "ssm":
        for i in range(cfg.n_layers):
            ssd(f"layers.{i}.")
    elif cfg.family == "hybrid":
        assert cfg.n_heads % n                 # the context rule
        pattern = cfg.block_pattern
        names = [f"super.{i}.b{j}_{kind}." for i in range(
            cfg.n_layers // len(pattern)) for j, kind in enumerate(pattern)]
        names += [f"tail.0.b{j}_{kind}." for j, kind in enumerate(
            pattern[:cfg.n_layers % len(pattern)])]
        for pre in names:
            if pre.endswith("attn."):
                by_context(pre, "attn", "ln1", seq, seq)
            else:
                rglru(pre)
            sub_block(pre + "ln2")
            ffn(pre + "mlp.", cfg.d_ff)
    elif cfg.family == "encdec":
        assert cfg.n_heads % n and cfg.src_len % n == 0
        src = cfg.src_len
        for i in range(cfg.n_encoder_layers):
            pre = f"encoder.{i}."
            by_context(pre, "attn", "ln1", src, src)
            sub_block(pre + "ln2", src)
            ffn(pre + "mlp.", cfg.d_ff, rows * src)
        out["all-gather"].append(rows * src * d * bf16)   # the memory
        for i in range(cfg.n_layers):
            pre = f"decoder.{i}."
            by_context(pre, "self_attn", "ln1", seq, seq)
            by_context(pre, "cross_attn", "ln_x", seq, src, memory=True)
            sub_block(pre + "ln2")
            ffn(pre + "mlp.", cfg.d_ff)
    else:
        for i in range(cfg.n_layers):
            dense(f"layers.{i}.")
    whole("final_norm")
    out["all-reduce"].append(rows * d * bf16)          # the last position
    vocab = cfg.padded_vocab
    out["all-gather"].append(rows * vocab * f32)        # its logits
    flops[0] += 2 * rows * d * vocab // n
    flops[1] += 2 * rows * d * vocab / n
    return {k: sorted(v) for k, v in out.items()}, moves, flops


# the FLOPs a rank runs over the one-process model's / 16, where more
# than 1.5 %: the products every rank runs whole (deepseek's w_dq, w_dkv
# and router, 11 %; mamba2's B and C, their columns of in_proj and their
# chunk scores, 24 %)
PREFILL_OVER = {"deepseek-v3-671b": 0.12, "mamba2-2.7b": 0.25}


@pytest.mark.parametrize("arch", list(PREFILL_CENSUS))
def test_tensor_parallel_prefill_step_gathers_no_weight_but_the_small_ones(
        prefill_census, arch):
    """The census of the tensor-parallel prefill on a fake (16, 16) group
    of 256 ranks (no data moves): each full config at full width cut in
    depth (PREFILL_CENSUS) on meta tensors, 2 rows of 32768 positions a
    data rank (internvl2's 256 patches before them; whisper's encoder
    over 1536 frames). The collectives are exactly `_prefill_expected`'s:
    one sequence all-gather and one reduce-scatter a sub-block
    (attention, MLP, MoE, SSD or RG-LRU), the embedding's reduce-scatter,
    the last position's all-reduce and the logits' all-gather; an
    attention whose 10 (recurrentgemma) or 8 (whisper) q heads 16 does
    not divide instead gathers its K/V along the sequence (the context
    rule; whisper's memory once); the SSD's norm all-reduces each
    position's sum of squares, and the RG-LRU gathers its convolved
    input's channels. The only whole parameters gathered are the split
    norm scales, deepseek's router, MLA's ``w_dq``/``w_dkv``, the SSD's
    ``conv_w``/``conv_b`` and, under the context rule, ``wq``, ``wk``,
    ``wv`` and ``wo``; the only other weight pieces moved are the rank's
    KV heads' columns of ``wk``/``wv``, the rank's heads' columns of the
    SSD's ``in_proj`` (z, xs and dt, with B and C whole) and the rank's
    rows of each row product (``wo``, ``w_down``, the shared expert's,
    ``out_proj``, ``w_out``), 1/16 of each, by all-to-all; no expert
    weight moves (the rank holds E / 16 experts); no all-gather but the
    logits is larger than a sequence's activations (whisper's: its K and
    V). The FLOPs are exactly the rank's: over the one-process products
    and attention / 16 by the products every rank runs whole, the whole
    KV head a rank's q heads read (8 KV heads on 16 ranks: qwen3 1.4 %,
    internvl2 1.2 %, dbrx 0.95 % over), deepseek's ``w_dq``/``w_dkv``
    and router (11 % over), mamba2's B and C and their chunk scores (24
    % over; the scan's FLOPs counted on the one-process `ssd_scan` at the
    rank's and at every head) and whisper's memory K/V (0.9 %). The step
    never reads the model's parameters."""
    got = prefill_census[arch]
    cfg = get_config(arch, "full").replace(**PREFILL_CENSUS[arch])
    want, moves, (flops, naive) = _prefill_expected(cfg, got, 2,
                                                    PREFILL_CENSUS_LEN)
    assert got["reads_model_params"] is False
    census = {k: sorted(b for kind, b in got["collectives"] if kind == k)
              for k in want}
    assert {kind for kind, _ in got["collectives"]} <= set(want)
    assert census == want
    allowed = {"ln1", "ln2", "ln", "ln_x", "q_norm", "k_norm", "kv_norm",
               "router", "w_dq", "w_dkv", "wk", "wv", "wo", "w_down",
               "in_proj", "conv_w", "conv_b", "out_proj", "w_out"}
    if cfg.family in ("hybrid", "encdec"):     # the context rule
        allowed.add("wq")
    assert all(name.rsplit(".", 1)[-1] in allowed for name in moves)
    assert not any("experts" in name for name in moves)
    if cfg.family == "moe":
        assert got["experts_local"][0] == cfg.n_experts // 16
        expert = {b for name, b in got["param_bytes"].items()
                  if "experts" in name for b in b}
        assert not expert & {b for _, b in got["collectives"]}
    act = 2 * (PREFILL_CENSUS_LEN + (cfg.n_patches if cfg.family == "vlm"
                                     else 0)) * cfg.d_model * 2
    if cfg.family == "encdec":                 # K and V of every position
        act = 2 * PREFILL_CENSUS_LEN * 2 * cfg.n_kv_heads * cfg.d_head * 2
    logits = 2 * cfg.padded_vocab * 4
    assert max(b for b in census["all-gather"] if b != logits) <= act
    assert got["flops"] == flops
    over = flops / naive - 1
    assert 0 <= over < PREFILL_OVER.get(arch, 0.015), over


# ----------------------------------- (h) the tensor-parallel train step

# the train census's models: the full dense and VLM configs cut in depth
# (meta tensors, bf16, internvl2 with its FSDP storage), 32 rows of 4096
# positions (2 a data rank; internvl2's 256 patches before them)
TRAIN_CENSUS = {"qwen3-0.6b": dict(n_layers=2),
                "internvl2-76b": dict(n_layers=2)}
TRAIN_CENSUS_LEN = 4096
# the norm scales that the prefill rule gathers whole where they are split
SMALL = ("ln1", "ln2", "q_norm", "k_norm", "final_norm")


@pytest.fixture(scope="module")
def train_census():
    """FULL_CENSUS_SCRIPT's train record of each TRAIN_CENSUS cell, the
    subprocesses at once."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(TRAIN_CENSUS)) as pool:
        got = pool.map(lambda arch: _full_census(
            arch, TRAIN_CENSUS[arch], 32, TRAIN_CENSUS_LEN, train=True),
            TRAIN_CENSUS)
        return dict(zip(TRAIN_CENSUS, got))


@pytest.mark.parametrize("arch", list(TRAIN_CENSUS))
def test_tensor_parallel_train_step_gathers_no_weight_but_the_small_ones(
        train_census, arch):
    """The census of the tensor-parallel train step on a fake (16, 16)
    group of 256 ranks (no data moves), qwen3-0.6b and internvl2-76b (its
    FSDP storage) at full width and 2 layers on meta tensors, 2 rows of
    4096 positions a data rank. The sequence moves as in prefill and back:
    each sub-block's all-gather of its input and reduce-scatter of its
    output, the embedding's reduce-scatter and the head's gather of the
    normed states, and in the backward each of their adjoints (4 x layers
    + 2 of each, the activations of the rows' every position and of the
    rank's). The only parameters gathered whole are the split norm scales
    (the prefill rule's small ones, and their gradients reduce-scattered
    back); a split matrix is never gathered whole, only its 'model'
    shard (internvl2's FSDP storage, over 'data', and the update's
    redistribution back from the optimizer layout); its gradient leaves
    as one reduce-scatter over 'data' of the rank's 'model' shard. The
    step never reads the model's parameters."""
    got = train_census[arch]
    cfg = get_config(arch, "full").replace(**TRAIN_CENSUS[arch])
    assert got["reads_model_params"] is False
    seq = TRAIN_CENSUS_LEN + (cfg.n_patches if cfg.family == "vlm" else 0)
    act = 2 * seq * cfg.d_model * 2
    moved = {kind: [b for k, b in got["collectives"] if k == kind]
             for kind in ("all-gather", "reduce-scatter", "all-reduce",
                          "all-to-all", "collective-permute")}
    assert moved["all-gather"].count(act) == 4 * cfg.n_layers + 2
    assert moved["reduce-scatter"].count(act // 16) == 4 * cfg.n_layers + 2
    assert not moved["collective-permute"]
    full = {name: b[0] for name, b in got["param_bytes"].items()}
    gathered = set(moved["all-gather"])
    whole = {name for name in got["model_split"] if full[name] in gathered}
    assert whole, "no norm scale gathered"
    assert all(name.rsplit(".", 1)[-1] in SMALL for name in whole), whole
    assert not gathered & set(got["split_matrices"])
    scattered = set(moved["reduce-scatter"])
    for name in got["model_split"]:
        if name.rsplit(".", 1)[-1] not in SMALL:    # 1/16 of its shard
            assert full[name] // 256 in scattered, name

TRAIN_IDS = [f"{arch}-{'wide' if wide else 'smoke'}-{length}"
             for arch, wide, length in workers.TRAIN_RUNS]


@pytest.fixture(scope="module")
def train_wants(serve_weights):
    """By TRAIN_RUNS run (arch, widened, token length), from the same
    weights and batches: the reference's ("reference": its jitted
    `make_train_step`'s metrics and state after TRAIN's steps, and the
    first batch's gradients before clipping, recovered from the first
    step's first moment: mu = (1 - b1) x the clipped gradient, from
    zeros, and the clip's scale min(1, 1 / grad_norm)) and the port's
    one-process `make_train_step`'s ("one process", the first batch's
    gradients by `torch.autograd.grad` of `Model.loss`)."""
    from repro.train.optim import adamw_init as ref_adamw_init
    t = workers.TRAIN
    kw = dict(base_lr=t["base_lr"], warmup=t["warmup"],
              total_steps=t["total_steps"])
    f32 = dict(dtype=torch.float32)
    out = {}
    for arch, wide, length in workers.TRAIN_RUNS:
        rm, params = serve_weights[0]["train", arch, wide]
        rstep = jax.jit(ref_loop.make_train_step(rm, **kw))
        cfg = workers.prefill_config(arch, wide)
        batches = workers.tp_train_batches(cfg, length)
        rstate = ref_loop.TrainState(params=params,
                                     opt=ref_adamw_init(params), ef=None)
        model = Model(cfg, "cpu")
        state = interop.train_state(jax.tree.map(np.asarray, rstate),
                                    model)
        total, _ = model.loss(batches[0])
        one = {"grads": dict(zip(state.params, torch.autograd.grad(
            total, list(state.params.values())))), "metrics": []}
        ref = {"metrics": []}
        step = loop.make_train_step(model, **kw)
        for i, batch in enumerate(batches):
            rstate, rmet = rstep(rstate, {k: jnp.asarray(v.numpy())
                                          for k, v in batch.items()})
            state, met = step(state, batch)
            ref["metrics"].append({k: float(v) for k, v in rmet.items()})
            one["metrics"].append({k: float(v) for k, v in met.items()})
            if i == 0:
                clip = min(1.0, 1.0 / ref["metrics"][0]["grad_norm"])
                ref["grads"] = {n: g / ((1 - 0.9) * clip)
                                for n, g in interop.model_params(
                    jax.tree.map(np.asarray, rstate.opt.mu), cfg, "cpu",
                    **f32).items()}
        rs = jax.tree.map(np.asarray, rstate)
        ref.update(params=interop.model_params(rs.params, cfg, "cpu"),
                   mu=interop.model_params(rs.opt.mu, cfg, "cpu", **f32),
                   nu=interop.model_params(rs.opt.nu, cfg, "cpu", **f32))
        one.update(params={n: p.detach() for n, p in state.params.items()},
                   mu=state.opt.mu, nu=state.opt.nu)
        out[arch, wide, length] = {"reference": ref, "one process": one}
    return out


@pytest.mark.parametrize("run", workers.TRAIN_RUNS, ids=TRAIN_IDS)
@pytest.mark.parametrize("shape", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
def test_tensor_parallel_train_step_equals_reference_and_one_process(
        train_wants, sharded_serve4, sharded_serve8, shape, run):
    """The tensor-parallel `make_sharded_train_step` (granite and qwen3
    smokes, qwen3 and internvl2 widened by PREFILL_WIDE, internvl2 with
    its FSDP storage and 8 patches; float32) on 4 gloo ranks as (data 2,
    model 2) and on 8 as (data 2, model 4), 4 rows of 72 tokens (71
    positions: 'model' leaves pads) and, widened, of 65 too (64 positions,
    72 with the patches: no pad), against the reference's
    jitted `make_train_step` and the port's one-process step on the same
    weights and batches: every leaf's gradient of the first batch before
    clipping (`sharded_gradients`, reassembled from the optimizer
    layout's shards) within GRAD_TOL of the leaf's largest magnitude;
    each of TRAIN's steps' loss, ce and grad_norm within 1e-5 relative;
    the parameters and moments after them within the 8-rank test's
    bounds. The step never reads the model's parameters; the FSDP
    storage splits the widened projections' fan-in over 'data'."""
    arch, wide, length = run
    got = (sharded_serve4 if shape == (2, 2) else sharded_serve8
           )["train"][run]
    assert got["reads_model_params"] is False
    placed = got["param_placements"]
    assert placed["embed"] == (["S(1)", "S(0)"] if arch == "internvl2-76b"
                               else ["R", "S(0)"])
    if wide:
        assert placed["layers.0.attn.wq"] == (
            ["S(0)", "S(1)"] if arch == "internvl2-76b" else ["R", "S(1)"])
    t = workers.TRAIN
    lr_fn = optim.cosine_schedule(t["base_lr"], t["warmup"],
                                  t["total_steps"])
    lr_sum = sum(float(lr_fn(s)) for s in range(t["steps"]))
    for which, want in train_wants[arch, wide, length].items():
        assert sorted(got["grads"]) == sorted(want["grads"])
        for name, g in want["grads"].items():
            scale = max(float(g.abs().max()), 1e-12)
            np.testing.assert_allclose(got["grads"][name].numpy(), g.numpy(),
                                       rtol=0, atol=GRAD_TOL * scale,
                                       err_msg=f"{which} {name}")
        assert len(got["metrics"]) == len(want["metrics"]) == t["steps"]
        for i, (gm, wm) in enumerate(zip(got["metrics"], want["metrics"])):
            for k in ("loss", "ce", "grad_norm"):
                np.testing.assert_allclose(gm[k], wm[k], rtol=LOSS_RTOL,
                                           err_msg=f"{which} {k} step {i}")
        for name, w in want["params"].items():
            w = w.numpy()
            _agree(got["params"][name].numpy(), w, 1e-6 + 1e-6 * np.abs(w),
                   0.02 * lr_sum, 1e-3, f"{which} {name}")
        for tree in ("mu", "nu"):
            for name, w in want[tree].items():
                scale = max(float(w.abs().max()), 1e-12)
                _agree(got[tree][name].numpy(), w.numpy(), GRAD_TOL * scale,
                       GRAD_TOL * scale, 1e-3, f"{which} {tree}.{name}")


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
def test_tensor_parallel_train_step_runs_on_a_meta_model(
        sharded_serve4, sharded_serve8, shape):
    """A step of PREFILL_WIDE's qwen3 whose model lives on the meta device
    (the step reads only the state's shards) equals, bit for bit, the
    same step of the model on the CPU: metrics, parameters and moments.
    The moe family's step is tensor parallel too (the dbrx smoke:
    ``reads_model_params`` False); the ssm family keeps the gathering
    step (the mamba2 smoke: True)."""
    got = (sharded_serve4 if shape == (2, 2) else sharded_serve8)["train"]
    (meta_met, meta), (cpu_met, cpu) = got["meta"]
    assert meta_met == cpu_met
    for tree in ("params", "mu", "nu"):
        assert sorted(meta[tree]) == sorted(cpu[tree])
        for name, want in cpu[tree].items():
            assert torch.equal(meta[tree][name], want), (tree, name)
    assert got["reads_model_params", "dbrx-132b"] is False
    assert got["reads_model_params", "mamba2-2.7b"] is True
