"""Port dry-run specs (`repro_torch.launch.specs`) vs the reference's
`repro.launch.specs`, on the CPU, for every (arch, shape) cell of the
registry on both production meshes.

The port's leaves are meta tensors with a `NamedSharding` on a
`MeshSpec`; the reference's are `ShapeDtypeStruct`s on
`AbstractMesh((16, 16), ("data", "model"))` and `AbstractMesh((2, 16,
16), ("pod", "data", "model"))`. Batch leaves must be equal in shape,
type and spec. Per-device argument bytes must be the reference's sum of
``shard_shape`` x itemsize, but for the leaves whose reference spec puts
a mesh axis on the stacked layer dim (ZeRO on a stacked norm): the port
keeps one tensor a layer and replicates that axis (`FALLBACK_LOG`), so
each such leaf holds exactly (axis size) x the reference's bytes.
"""

import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs.registry import cells as ref_cells
from repro.configs.registry import get_config as ref_config
from repro.distributed import sharding as ref_shd
from repro.launch import specs as ref_specs
from repro.models import build_model as ref_build
from repro_torch.configs.registry import SHAPES, cells, get_config, list_archs
from repro_torch.distributed import sharding
from repro_torch.launch import specs
from repro_torch.models import Model

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
STACKS = ("layers", "super", "tail", "encoder", "decoder", "dense_layers",
          "moe_layers")


def _ref_bytes(leaf) -> int:
    return int(np.prod(leaf.sharding.shard_shape(leaf.shape))) * \
        np.dtype(leaf.dtype).itemsize


def _ref_accounting(tree, stacked: bool):
    """(the reference's bytes, the port's expected bytes, the number of
    port tensors whose layer-axis entry is replicated) over a tree's
    leaves; ``stacked`` for parameter-shaped trees (params, moments)."""
    ref = want = logged = 0
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        n = _ref_bytes(leaf)
        ref += n
        keys = [k.key for k in kp if hasattr(k, "key")]
        on_layers = stacked and (keys[0] in STACKS or
                                 keys[:2] == ["mtp", "block"])
        axis = leaf.sharding.spec[0] if on_layers and leaf.ndim else None
        if axis is None:
            want += n
            continue
        size = int(np.prod([leaf.sharding.mesh.shape[a] for a in
                            (axis if isinstance(axis, tuple) else (axis,))]))
        want += n * size
        logged += leaf.shape[0]
    return ref, want, logged


def _layer_axis_logged() -> int:
    return sum("on the layer axis" in line for line in sharding.FALLBACK_LOG)


@pytest.fixture(scope="module")
def models():
    """Each arch's reference model and the port's meta model, built once."""
    return {arch: (ref_build(ref_config(arch, "full")),
                   Model(get_config(arch, "full"), "meta"))
            for arch in list_archs()}


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_specs_equal_reference_on_every_cell(models, arch, mesh_kind):
    """For each of the arch's registry cells: every batch leaf's shape,
    type and spec; the state's per-device bytes, leaf by leaf accounted
    as the module docstring says; and the cell's whole argument bytes
    through `cell_lowerable` on a `MeshSpec`."""
    sizes, names = MESHES[mesh_kind]
    ref_mesh, port_mesh = AbstractMesh(sizes, names), \
        sharding.MeshSpec(names, sizes)
    rm, pm = models[arch]
    rcfg, cfg = rm.cfg, pm.cfg
    ref_shd.set_mesh(ref_mesh)
    sharding.set_mesh(port_mesh)
    try:
        for cell_arch, shape, _ in cells():
            if cell_arch != arch:
                continue
            kind = SHAPES[shape]["kind"]
            for_train = kind == "train"
            rb = ref_specs.batch_specs(rcfg, shape, ref_mesh, for_train)
            pb = specs.batch_specs(cfg, shape, port_mesh, for_train)
            assert set(pb) == set(rb), shape
            for key, want in rb.items():
                got = pb[key]
                assert got.shape == tuple(want.shape), (shape, key)
                assert str(got.dtype) == f"torch.{np.dtype(want.dtype)}"
                assert got.sharding.spec == tuple(want.sharding.spec)
                assert got.sharding.mesh is port_mesh
            batch_bytes = sum(_ref_bytes(v) for v in rb.values())
            assert specs.argument_bytes(pb) == batch_bytes

            sharding.FALLBACK_LOG.clear()
            rs = ref_specs.model_state_specs(rm, ref_mesh, kind, shape)
            ps = specs.model_state_specs(pm, port_mesh, kind, shape)
            # (reference, port, parameter-shaped, logged): both moments
            # share one zero=True layout, which logs once
            if kind == "train":
                parts = [(rs.params, ps.params, True, True),
                         (rs.opt.mu, ps.opt.mu, True, True),
                         (rs.opt.nu, ps.opt.nu, True, False),
                         (rs.opt.step, ps.opt.step, False, False)]
                assert rs.ef is None and ps.ef is None
            elif kind == "decode":
                parts = [(rs[0], ps[0], True, True),
                         (rs[1], ps[1], False, False)]
            else:
                parts = [(rs, ps, True, True)]
            total_ref = total_want = logged = 0
            for ref_tree, port_tree, stacked, logs in parts:
                r, w, n = _ref_accounting(ref_tree, stacked)
                assert specs.argument_bytes(port_tree) == w, (shape, r, w)
                total_ref, total_want = total_ref + r, total_want + w
                logged += n if logs else 0
            assert _layer_axis_logged() == logged, shape
            _, args = specs.cell_lowerable(arch, shape, port_mesh)
            assert specs.argument_bytes(args) == total_want + batch_bytes
            if logged == 0:
                assert total_want == total_ref
    finally:
        ref_shd.clear_mesh()
        sharding.clear_mesh()
        ref_shd.set_fsdp(False)
        sharding.set_fsdp(False)
        sharding.FALLBACK_LOG.clear()


def test_cells_and_shapes_are_the_reference_grid():
    assert cells() == ref_cells() and len(cells()) == 32


def test_meta_leaves_carry_local_shapes():
    """A `MetaLeaf`'s shard shape divides each sharded dim by its axes;
    the decode state's cache is a nested dict of leaves."""
    mesh = sharding.MeshSpec(("pod", "data", "model"), (2, 16, 16))
    sharding.set_mesh(mesh)
    try:
        m = Model(get_config("qwen3-0.6b", "full"), "meta")
        params, cache = specs.model_state_specs(m, mesh, "decode",
                                                "decode_32k")
        k = cache["kv"]["k"]
        assert k.shape == (28, 128, 32768, 8, 128)
        assert k.sharding.spec == (None, ("pod", "data"), "model", None,
                                   None)
        assert k.local_shape == (28, 4, 2048, 8, 128)
        assert params["embed"].local_shape == (m.cfg.padded_vocab // 16, 1024)
    finally:
        sharding.clear_mesh()


@pytest.mark.parametrize("arch", list_archs())
def test_reduce_layers_equals_reference(arch):
    """Field for field at n in {1, 2, 3, 5, 8} (types by name)."""
    from repro.launch.specs import _reduce_layers as ref_reduce
    for n in (1, 2, 3, 5, 8):
        got = specs._reduce_layers(get_config(arch, "full"), n)
        want = ref_reduce(ref_config(arch, "full"), n)
        for f in dataclasses.fields(got):
            g, w = getattr(got, f.name), getattr(want, f.name)
            if f.name == "dtype":
                assert str(g) == f"torch.{np.dtype(w)}", n
            else:
                assert g == w, (arch, n, f.name, g, w)
