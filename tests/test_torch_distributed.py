"""Port distribution substrate (`repro_torch.distributed`: sharding
rules, collectives, pipeline; `repro_torch.train.loop.
make_sharded_train_step`) vs the reference `repro.distributed` and the
one-process train step, on the CPU.

The rules are pure functions of path, shape and axis sizes: the port's
specs on a `MeshSpec` equal the reference's on an `AbstractMesh` exactly,
leaf for leaf of every config's full parameter tree and decode cache,
and so do their fallback logs. The collectives, the pipeline and the
sharded step run on gloo process groups of 4 and 8 CPU ranks
(`torch_dist_workers`, spawned once per group); tolerances are the
reference tests': the two-hop sum rtol 1e-6 of a flat all_reduce, the
pipeline rtol and atol 2e-5 of the sequential stages, the sharded step
test_torch_train.py's bounds against the one-process step.
"""

import jax
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
from repro_torch.configs import get_config
from repro_torch.distributed import pipeline, sharding
from repro_torch.models import Model
from repro_torch.train import loop, optim

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
