"""Sharding rules: logical-axis activation constraints and per-parameter
partition specs with divisibility-aware fallbacks (port of
`repro.distributed.sharding`).

Scheme, as in the reference:
  * activations: batch over 'data' (composed with 'pod' on multi-pod
    meshes), model-internal dims unsharded between constraint points;
  * parameters: fan-out over 'model' (Megatron TP), with ``fsdp`` also
    fan-in over the data axes; the experts' dim over 'model' (EP);
  * optimizer state: ``zero=True`` also puts the data axes on the largest
    free dim (ZeRO).

Every tensor dim is checked for divisibility by its mesh axes; on failure
the dim falls back to replication and the decision is appended to
`FALLBACK_LOG`.

A mesh is either a `MeshSpec` (`repro_torch.distributed.mesh`: names
and sizes, no process group: the rules are pure functions of path, shape and axis sizes) or a real
`torch.distributed.device_mesh.DeviceMesh` (`device_mesh` builds one).
A spec is a tuple in the reference's `PartitionSpec` layout: per tensor
dim ``None``, an axis name, or a tuple of names (major first);
`placements` maps it to DTensor placements, one per mesh dim.

**The layer axis.** The reference stacks each layer list on a leading
axis (``layers/attn/wq`` is (L, d, h d_head)); the port keeps one tensor a
layer (``layers.3.attn.wq``, (d, h d_head)). `param_shardings` maps each
port name back to its reference path and stacked shape, takes the
reference's spec, and drops the layer dim. Where the reference put a
mesh axis on the layer dim (ZeRO on a stacked norm: ``layers/ln1`` of
(64, 5120) gives ('data', 'model')), that axis is replicated for the
unstacked tensor and the decision is appended to `FALLBACK_LOG`. This is
a deliberate difference of layout, never of values.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np

from repro_torch.distributed.mesh import MeshSpec

# ---------------------------------------------------------------- context
_ACTIVE: dict[str, Any] = {"mesh": None, "data_axes": ("data",),
                           "fsdp": False}
FALLBACK_LOG: list[str] = []


def _names(mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names if isinstance(mesh, MeshSpec)
                 else mesh.mesh_dim_names)


def _sizes(mesh) -> dict[str, int]:
    if isinstance(mesh, MeshSpec):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def device_mesh(spec: MeshSpec, device_type: str = "cuda"):
    """A `DeviceMesh` of ``spec``'s shape and names over the ranks of the
    default process group (which must be up, with one rank per mesh
    point)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(spec.sizes),
                            mesh_dim_names=tuple(spec.axis_names))


def set_fsdp(enabled: bool) -> None:
    """FSDP parameter storage (fan-in sharded over the data axes). Off by
    default: TP/EP-only parameter specs, ZeRO-sharded optimizer state."""
    _ACTIVE["fsdp"] = enabled


def set_mesh(mesh, multi_pod: bool | None = None) -> None:
    """Install the active mesh (a `MeshSpec` or a `DeviceMesh`) for the
    constraints and the specs. ``multi_pod=None`` autodetects from the
    axis names."""
    if mesh is None:
        _ACTIVE.update(mesh=None, data_axes=("data",))
        return
    if multi_pod is None:
        multi_pod = "pod" in _names(mesh)
    _ACTIVE.update(mesh=mesh,
                   data_axes=(("pod", "data") if multi_pod else ("data",)))


def clear_mesh() -> None:
    set_mesh(None)


def active_mesh():
    return _ACTIVE["mesh"]


def _data_axes(mesh) -> tuple[str, ...]:
    if mesh is _ACTIVE["mesh"]:
        return _ACTIVE["data_axes"]
    return ("pod", "data") if "pod" in _names(mesh) else ("data",)


def _phys(axis, mesh):
    """Map a logical axis name to physical axes of ``mesh``."""
    if axis != "data":
        return axis
    ax = ("data",) if mesh is None else _data_axes(mesh)
    return ax if len(ax) > 1 else ax[0]


def _axis_size(axis, mesh) -> int:
    if axis is None or mesh is None:
        return 1
    sizes = _sizes(mesh)
    if isinstance(axis, tuple):
        return int(np.prod([sizes[a] for a in axis]))
    return sizes[axis]


def axis_size(name: str) -> int:
    """Size of a logical axis on the active mesh (1 without a mesh)."""
    mesh = _ACTIVE["mesh"]
    if mesh is None:
        return 1
    return _axis_size(_phys(name, mesh), mesh)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of a spec on ``mesh``: for each mesh dim,
    ``Shard(d)`` where tensor dim d names that axis (alone or in a tuple),
    else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in _names(mesh):
        dims = [d for d, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def constrain(x, logical_spec):
    """No-op without a `DeviceMesh` or on a plain tensor; a DTensor is
    redistributed to the placements of ``logical_spec`` (entries 'data',
    'model' or None), a dim that its axes do not divide replicated.
    Values never change."""
    mesh = _ACTIVE["mesh"]
    if mesh is None or isinstance(mesh, MeshSpec):
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    phys = []
    for ax, dim in zip(logical_spec, x.shape):
        p = _phys(ax, mesh) if ax else None
        if p is not None and dim % _axis_size(p, mesh) != 0:
            p = None
        phys.append(p)
    phys += [None] * (x.dim() - len(phys))
    return x.redistribute(mesh, placements(tuple(phys), mesh))


# ------------------------------------------------------------ param rules
def param_pspec(path: str, shape: tuple[int, ...],
                fsdp: bool | None = None, zero: bool = False,
                mesh=None) -> tuple:
    """Spec of one parameter, by name pattern + shape, on ``mesh`` (the
    active one when None). ``fsdp=None`` uses the active mode;
    ``zero=True`` also shards the largest free dim over the data axes
    (the optimizer-state layout)."""
    mesh = _ACTIVE["mesh"] if mesh is None else mesh
    if fsdp is None:
        fsdp = _ACTIVE["fsdp"]
    data = _phys("data", mesh)
    model = "model"
    spec: list = [None] * len(shape)

    def shardable(dim: int, axis) -> bool:
        return dim % _axis_size(axis, mesh) == 0

    def try_assign(dim_idx: int, axis) -> bool:
        if spec[dim_idx] is None and shardable(shape[dim_idx], axis):
            spec[dim_idx] = axis
            return True
        FALLBACK_LOG.append(f"{path}: dim{dim_idx}={shape[dim_idx]} "
                            f"not divisible by {axis}; replicated")
        return False

    leaf = path.split("/")[-1]
    if leaf == "embed":                        # (V, d)
        try_assign(0, model)
        if fsdp:
            try_assign(1, data)
    elif "experts" in path and len(shape) == 4:  # (L, E, d_in, d_out)
        try_assign(1, model)                   # expert parallelism
        if fsdp:
            try_assign(2, data)
    elif leaf in ("conv_w",):                  # (L, W, C)
        try_assign(len(shape) - 1, model)
    elif len(shape) >= 2 and shape[-1] >= 128 and shape[-2] >= 128:
        try_assign(len(shape) - 1, model)      # fan-out TP
        if fsdp:
            try_assign(len(shape) - 2, data)   # fan-in FSDP storage
    elif len(shape) >= 2 and shape[-1] >= 128:
        try_assign(len(shape) - 1, model)
    if zero and data not in spec:
        frees = [(shape[i], i) for i in range(len(shape)) if spec[i] is None]
        for _, i in sorted(frees, reverse=True):
            if shardable(shape[i], data):
                spec[i] = data
                break
    return tuple(spec)


class NamedSharding(NamedTuple):
    """A spec on a mesh (the reference's `jax.sharding.NamedSharding`)."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def param_shardings(model, mesh=None, fsdp: bool | None = None,
                    zero: bool = False) -> dict[str, NamedSharding]:
    """`NamedSharding` of each of ``model``'s parameters by name: the
    reference's spec of its stacked leaf (path and shape with the layer
    axis) with the layer dim dropped; a mesh axis that the reference put
    on the layer dim is replicated and logged (see the module docstring).
    ``zero=True`` gives the optimizer-state layout."""
    from repro_torch.models.model import stacked_leaf
    mesh = mesh if mesh is not None else _ACTIVE["mesh"]
    if mesh is None:
        raise ValueError("no active mesh; call set_mesh first")
    params = dict(model.named_parameters())
    leaves = {name: stacked_leaf(name) for name in params}
    depth: dict[str, int] = {}
    for leaf in leaves.values():
        if leaf is not None:
            stack, i, _ = leaf
            depth[stack] = max(depth.get(stack, 0), i + 1)
    out = {}
    for name, p in params.items():
        shape = tuple(p.shape)
        if leaves[name] is None:
            out[name] = NamedSharding(mesh, param_pspec(
                name.replace(".", "/"), shape, fsdp=fsdp, zero=zero,
                mesh=mesh))
            continue
        stack, _, rest = leaves[name]
        path = f"{stack}.{rest}".replace(".", "/")
        stacked = (depth[stack], *shape)
        spec = param_pspec(path, stacked, fsdp=fsdp, zero=zero, mesh=mesh)
        if spec[0] is not None:
            FALLBACK_LOG.append(f"{name}: {spec[0]} on the layer axis of "
                                f"{path} {stacked}; replicated")
        out[name] = NamedSharding(mesh, spec[1:])
    return out


def batch_pspec(shape: tuple[int, ...], seq_axis_fallback: bool = True
                ) -> tuple:
    """Spec of a batch-leading tensor on the active mesh; if the batch
    does not divide the data axes (batch 1), shard the sequence axis
    instead."""
    mesh = _ACTIVE["mesh"]
    data = _phys("data", mesh)

    def shardable(dim):
        return dim % _axis_size(data, mesh) == 0

    if shardable(shape[0]):
        return (data, *([None] * (len(shape) - 1)))
    if seq_axis_fallback and len(shape) > 1 and shardable(shape[1]):
        return (None, data, *([None] * (len(shape) - 2)))
    return (None,) * len(shape)


def cache_batch_dim(leafname: str, ndim: int) -> int:
    """The batch dim of a decode-cache leaf, by its name: ``length`` (B,),
    ``conv`` / ``tail_conv`` (..., B, W, C), ``h`` / ``tail_h`` (..., B,
    W), every other leaf (L, B, ...)."""
    if leafname in ("conv", "tail_conv"):
        return ndim - 3
    if leafname in ("h", "tail_h"):
        return ndim - 2
    return 0 if leafname == "length" else 1


def shard_offset(mesh, placements, dim: int, length: int
                 ) -> tuple[int, tuple[str, ...]]:
    """This rank's first index along tensor dim ``dim`` (of global
    ``length``) of a tensor placed by ``placements`` on the `DeviceMesh`
    ``mesh``, and the names of the mesh dims that split that dim, major
    first (DTensor's order: the first such mesh dim outermost). For a
    decode-cache leaf (L, B, S, ...) in `cache_shardings`' layout, dim 2
    gives the offset of the rank's positions in the sequence, which the
    tensor-parallel decode writes and attends by
    (`repro_torch.distributed.tensor_parallel.KVShard`)."""
    names = mesh.mesh_dim_names
    idx, n, axes = 0, 1, []
    for i, pl in enumerate(placements):
        if pl.is_shard(dim):
            size = mesh.size(i)
            idx, n = idx * size + mesh.get_local_rank(i), n * size
            axes.append(names[i])
    return idx * (length // n), tuple(axes)


def cache_shardings(cache: dict, mesh=None):
    """Decode-cache shardings, nested as ``cache`` (a dict of tensors or
    anything with a ``shape``), as the reference lays them out: KV-like
    leaves (L, B, S, [H,] D) batch over the data axes (else the sequence
    axis), kv-heads over 'model' when divisible, else the sequence axis
    over 'model'; recurrent states heads / channels over 'model'."""
    mesh = mesh if mesh is not None else _ACTIVE["mesh"]
    data = _phys("data", mesh)

    def spec(leafname: str, shape) -> tuple:
        s: list = [None] * len(shape)

        def assign(dim, axis):
            if (0 <= dim < len(shape) and s[dim] is None and axis not in s
                    and shape[dim] % _axis_size(axis, mesh) == 0):
                s[dim] = axis
                return True
            return False

        batch = cache_batch_dim(leafname, len(shape))
        if leafname in ("k", "v", "ckv", "kpe", "mem_k", "mem_v") \
                and len(shape) >= 4:
            assign(batch, data) or assign(2, data)  # batch, else sequence
            if len(shape) >= 5:
                assign(3, "model") or assign(2, "model")
            else:
                assign(2, "model")
        elif leafname == "ssm" and len(shape) >= 4:  # (L, B, H, P, N)
            assign(batch, data)
            assign(2, "model")
        elif leafname in ("conv", "tail_conv", "h", "tail_h"):
            assign(batch, data)
            assign(len(shape) - 1, "model")
        return tuple(s)

    def walk(tree):
        return {k: (walk(v) if isinstance(v, dict)
                    else NamedSharding(mesh, spec(k, tuple(v.shape))))
                for k, v in tree.items()}

    return walk(cache)
