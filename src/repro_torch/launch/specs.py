"""Meta-tensor stand-ins for every (arch x input-shape) dry-run cell
(port of `repro.launch.specs`).

Nothing here allocates: model parameters, optimizer state, decode caches
and input batches are tensors on the meta device, each with the
`NamedSharding` of the production layout (`repro_torch.distributed.
sharding`). On a `MeshSpec` a leaf is a `MetaLeaf` (the reference's
`ShapeDtypeStruct` with a sharding), a pure function of the config, the
shape name and the mesh's sizes; on a `DeviceMesh` `cell_lowerable` turns
each into a meta DTensor holding this rank's shard, which the rank's
sharded step (`repro_torch.train.loop`) runs on.

`cell_lowerable` builds `Model(cfg, device="meta")` and never calls
`Model.init`: a generator cannot be made on the meta device.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.configs.registry import SHAPES, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.mesh import MeshSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.train.loop import (TrainState, make_sharded_prefill_step,
                                    make_sharded_serve_step,
                                    make_sharded_train_step)
from repro_torch.train.optim import AdamWState


class MetaLeaf(NamedTuple):
    """A meta tensor of a leaf's global shape and type, and its
    `NamedSharding`."""

    tensor: torch.Tensor
    sharding: shd.NamedSharding

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.tensor.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.tensor.dtype

    @property
    def local_shape(self) -> tuple[int, ...]:
        """The shape of one device's shard (every sharded dim divides
        its axes, by the rules' construction)."""
        sizes = shd._sizes(self.sharding.mesh)
        out = []
        for dim, ax in zip(self.shape, self.sharding.spec):
            axes = () if ax is None else (ax if isinstance(ax, tuple)
                                          else (ax,))
            out.append(dim // math.prod(sizes[a] for a in axes))
        return tuple(out)


def _leaf(tensor: torch.Tensor, mesh, spec: tuple) -> MetaLeaf:
    return MetaLeaf(torch.empty(tensor.shape, dtype=tensor.dtype,
                                device="meta"),
                    shd.NamedSharding(mesh, tuple(spec)))


def _map(tree, fn):
    """``fn`` over the leaves of a tree of dicts, `TrainState` /
    `AdamWState` and tuples (None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (TrainState, AdamWState)):
        return type(tree)(*(_map(v, fn) for v in tree))
    if isinstance(tree, tuple) and not isinstance(tree, MetaLeaf):
        return tuple(_map(v, fn) for v in tree)
    return fn(tree)


def leaves(tree) -> list:
    """The leaves of a tree as `_map` walks it."""
    out: list = []
    _map(tree, out.append)
    return out


def local_nbytes(leaf) -> int:
    """Bytes of one device's shard of a `MetaLeaf`, a DTensor or a
    plain tensor (all of it)."""
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, MetaLeaf):
        return math.prod(leaf.local_shape) * leaf.dtype.itemsize
    if isinstance(leaf, DTensor):
        leaf = leaf.to_local()
    return leaf.numel() * leaf.element_size()


def argument_bytes(tree) -> int:
    """Per-device bytes of a tree of step arguments in their layouts."""
    return sum(local_nbytes(leaf) for leaf in leaves(tree))


def batch_specs(cfg: ModelConfig, shape_name: str, mesh,
                for_train: bool) -> dict:
    """`MetaLeaf`s for one input batch: int32 tokens (B, 1) for decode,
    (B, S + 1) for train (the shifted inputs are then exactly S), (B, S)
    for prefill; a float32 frontend for encdec (B, src_len, d) and vlm
    (B, n_patches, d) outside decode. Specs from `batch_pspec` on the
    active mesh."""
    spec = SHAPES[shape_name]
    b, s = spec["global_batch"], spec["seq_len"]
    if spec["kind"] == "decode":
        shape = (b, 1)
    elif spec["kind"] == "train":
        shape = (b, s + 1)
    else:
        shape = (b, s)

    def leaf(shape, dtype):
        return _leaf(torch.empty(shape, dtype=dtype, device="meta"), mesh,
                     shd.batch_pspec(shape))

    out: dict[str, Any] = {"tokens": leaf(shape, torch.int32)}
    if cfg.family == "encdec" and spec["kind"] != "decode":
        out["frontend"] = leaf((b, cfg.src_len, cfg.d_model), torch.float32)
    if cfg.family == "vlm" and spec["kind"] != "decode":
        out["frontend"] = leaf((b, cfg.n_patches, cfg.d_model), torch.float32)
    return out


def model_state_specs(model: Model, mesh, kind: str, shape_name: str):
    """`MetaLeaf`s of the step's state: the parameters (a dict by name;
    ``kind`` "prefill"), a `TrainState` ("train") or the parameters and
    the decode cache ("decode").

    As the reference: training stores the parameters FSDP-sharded only
    where the config asks (``cfg.fsdp_train``), serving never; the AdamW
    moments (float32) take the ZeRO layout (``zero=True``) and the step
    count is a replicated int32 scalar; the cache of
    ``model.init_cache(B, S)`` takes `cache_shardings`' layout."""
    cfg = model.cfg
    shd.set_fsdp(cfg.fsdp_train if kind == "train" else False)
    named = dict(model.named_parameters())
    pshard = shd.param_shardings(model, mesh)
    params = {n: _leaf(p, mesh, pshard[n].spec) for n, p in named.items()}
    if kind == "train":
        oshard = shd.param_shardings(model, mesh, zero=True)

        def moments():
            return {n: _leaf(p.float(), mesh, oshard[n].spec)
                    for n, p in named.items()}

        step = _leaf(torch.empty((), dtype=torch.int32, device="meta"),
                     mesh, ())
        return TrainState(params=params,
                          opt=AdamWState(step=step, mu=moments(),
                                         nu=moments()),
                          ef=None)
    if kind == "decode":
        spec = SHAPES[shape_name]
        cache = model.init_cache(spec["global_batch"], spec["seq_len"],
                                 device="meta")
        cshard = shd.cache_shardings(cache, mesh)

        def zipped(c, sh):
            return {k: zipped(v, sh[k]) if isinstance(v, dict)
                    else _leaf(v, mesh, sh[k].spec) for k, v in c.items()}

        return params, zipped(cache, cshard)
    return params


def _dtensor(leaf: MetaLeaf):
    """A meta DTensor of ``leaf``'s global shape holding this rank's
    shard (the mesh is a `DeviceMesh`)."""
    from torch.distributed.tensor import DTensor
    local = torch.empty(leaf.local_shape, dtype=leaf.dtype, device="meta")
    return DTensor.from_local(local, leaf.sharding.mesh,
                              leaf.sharding.placements,
                              shape=leaf.tensor.shape,
                              stride=leaf.tensor.stride())


def cell_lowerable(arch: str, shape_name: str, mesh,
                   n_layers_override: int | None = None):
    """(step, args) for one dry-run cell; ``step(*args)`` runs it.

    On a `DeviceMesh` (over a process group with one rank per mesh
    point) ``step`` is this rank's sharded step (`make_sharded_train_step`,
    `make_sharded_prefill_step` or `make_sharded_serve_step`) over a
    meta model, and ``args`` are meta DTensors. On a `MeshSpec` there is
    no process group to run on: ``step`` is None and ``args`` are
    `MetaLeaf`s (their `argument_bytes` are the same)."""
    return build_cell(arch, shape_name, mesh, n_layers_override)[1:]


def build_cell(arch: str, shape_name: str, mesh,
               n_layers_override: int | None = None):
    """`cell_lowerable`'s (step, args), preceded by the meta `Model` the
    step runs."""
    cfg = get_config(arch, "full")
    if n_layers_override is not None:
        cfg = _reduce_layers(cfg, n_layers_override)
    spec = SHAPES[shape_name]
    from repro_torch.models import flags
    if flags.SCAN_UNROLL:
        # the reference's analysis lowerings: one full-width q-block
        cfg = cfg.replace(q_block=max(spec["seq_len"], cfg.q_block))
    model = Model(cfg, device="meta")
    shd.set_mesh(mesh)
    kind = spec["kind"]
    if kind == "train":
        args = (model_state_specs(model, mesh, "train", shape_name),
                batch_specs(cfg, shape_name, mesh, True))
    elif kind == "prefill":
        args = (model_state_specs(model, mesh, "prefill", shape_name),
                batch_specs(cfg, shape_name, mesh, False))
    else:
        params, cache = model_state_specs(model, mesh, "decode", shape_name)
        args = (params, cache,
                batch_specs(cfg, shape_name, mesh, False)["tokens"])
    if isinstance(mesh, MeshSpec):
        return model, None, args
    args = _map(args, _dtensor)
    if kind == "train":
        state, batch = args
        for p in model.parameters():
            p.requires_grad_(True)
        # the step count is replicated: every rank holds it as a plain
        # tensor, as `init_sharded_train_state` does
        opt = state.opt._replace(step=state.opt.step.to_local())
        return (model, make_sharded_train_step(model, mesh, total_steps=1000),
                (state._replace(opt=opt), batch))
    if kind == "prefill":
        return model, make_sharded_prefill_step(model, mesh), args
    return model, make_sharded_serve_step(model, mesh), args


def _reduce_layers(cfg: ModelConfig, n: int) -> ModelConfig:
    """Depth-reduced variant preserving the layer mix."""
    kw: dict[str, Any] = {"n_layers": n}
    if cfg.family == "moe" and cfg.n_dense_layers:
        kw["n_dense_layers"] = min(1, n - 1) if n > 1 else 0
    if cfg.family == "hybrid":
        pat = len(cfg.block_pattern)
        kw["n_layers"] = max(pat, (n // pat) * pat)
    if cfg.family == "encdec":
        kw["n_encoder_layers"] = n
    return cfg.replace(**kw)
