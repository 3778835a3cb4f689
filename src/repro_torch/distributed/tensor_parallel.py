"""Tensor-parallel decode: the sharded serve step of every family computes
on the rank's own shards of the parameters and of every cache leaf, as
XLA partitions the reference's decode under the fan-out layout of
`repro.distributed.sharding` (parameters Shard(last) over 'model', the
embedding Shard(0), the routed experts Shard(0), their expert dim; the
convolutions' ``conv_w`` their channels; the cache's KV heads over
'model' where they divide it, else its sequence; MLA's latent caches
``ckv`` and ``kpe`` and the encoder memory ``mem_k``/``mem_v`` their
sequence where the heads do not divide; the recurrent states ``conv``,
``h`` and their tail's their channels, the SSM state ``ssm`` its heads).

At decode the activations are a few rows, so they move, and the weights
and the cache never do:

  * a product ``x @ w`` with ``w`` a 'model' shard of its columns
    multiplies by the rank's columns, then an all-gather over 'model'
    rebuilds the full output (`matmul`); a weight that the layout
    replicates is multiplied whole;
  * a norm whose scale is a 'model' shard (a stacked norm scale of 128
    or more features, which the fan-out rule splits) scales the rank's
    slice of the normalised activation, the slices then all-gathered
    (`repro_torch.models.layers.rms_norm`);
  * the embedding is a masked lookup of the rank's vocab rows, summed
    over 'model' (`layers.embed`); the unembedding
    takes logits from the rank's vocab rows, the padded ids masked, and
    all-gathers them over 'model' (`layers.unembed`);
  * decode attention runs on the rank's shard of the cache it reads
    (`KVShard`, one an attention cache: ``kv``, ``dense_kv``,
    ``moe_kv``, ``ckv``, ``mem_k`` with ``mem_v``): with the KV heads
    over 'model', on the q heads of the rank's KV heads, the outputs
    then all-gathered; with the sequence over one or more axes, on the
    local positions, the ranks' outputs then combined by their
    log-sum-exps (`combine`); a ring buffer (the hybrid's local
    attention) takes its slot and valid length modulo the whole window,
    then as the rank's positions;
  * a recurrent layer runs its channel-wise recurrence on the rank's
    channels or heads of its state (`StateShard`, one a state leaf:
    ``conv``, ``h``, ``tail_conv``, ``tail_h``, ``ssm``): the products
    into those channels take the rank's columns, the convolution its
    ``conv_w`` and ``conv_b`` shards, and the activations a product
    needs whole (the convolved input of the RG-LRU's gates and of the
    SSM's heads, the output into ``w_out`` / ``out_proj``) are
    all-gathered (`repro_torch.models.rglru.rglru_decode_step`,
    `repro_torch.models.ssd.ssd_decode_step`);
  * a mixture-of-experts layer routes every row on every 'model' rank
    alike (the router's product gathered where its columns are split),
    runs the rank's own experts on the choices they were given, and sums
    the choices' expert outputs over 'model' before weighting them:
    each kept choice's output is not zero on exactly one rank
    (`repro_torch.models.moe.moe_block`);
  * MLA's absorbed decode forms the absorbed query of the rank's heads
    of ``w_ukv`` and gathers it, scores every head over the rank's
    positions of the latent cache, combines the ranks' contexts by their
    log-sum-exps, and gathers the rank's heads' outputs
    (`repro_torch.models.mla.mla_decode_step`).

Norms, rope, activations and the residual run on the gathered activations
of the rank's rows, redundantly over 'model'.

The sites consult the `TensorParallel` context that `active` installs
(`repro_torch.train.loop.make_sharded_serve_step` does, around the
model's `decode_step`); with none installed each computes what the
one-process model computes. The collectives are the `_c10d_functional`
ops, so they run alike on NCCL, on gloo and on the dry run's fake process
group over meta tensors, whose census counts them
(`repro_torch.launch.dryrun`).
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass

import torch

#: The decode cache's attention caches, each read through a `KVShard` of
#: its own (``mem_v`` lies as ``mem_k``, ``kpe`` as ``ckv``).
KV_CACHES = ("kv", "dense_kv", "moe_kv", "ckv", "mem_k")
#: The recurrent state leaves and the dim of each that the layout splits
#: over 'model': the channels, or the SSM state's heads (L, B, H, P, N).
STATE_DIMS = {"conv": -1, "tail_conv": -1, "h": -1, "tail_h": -1, "ssm": 2}

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "tensor_parallel", default=None)


def _gather(x: torch.Tensor, dim: int, groups) -> torch.Tensor:
    """``x`` concatenated along ``dim`` over the ranks of ``groups`` (the
    process groups of the mesh dims that split it, major first)."""
    import torch.distributed as dist
    c10d = torch.ops._c10d_functional
    dim = dim % x.dim()
    for group in reversed(groups):          # the minor axis first
        n = dist.get_world_size(group)
        out = c10d.wait_tensor(c10d.all_gather_into_tensor(
            x.contiguous(), n, group.group_name))
        x = out if dim == 0 else torch.cat(out.chunk(n), dim=dim)
    return x


def _all_reduce(x: torch.Tensor, op: str, groups) -> torch.Tensor:
    """``x`` reduced (``op`` "sum" or "max") over the ranks of
    ``groups``; a new tensor."""
    c10d = torch.ops._c10d_functional
    for group in groups:
        x = c10d.wait_tensor(c10d.all_reduce(x.contiguous(), op,
                                             group.group_name))
    return x


def combine(out: torch.Tensor, lse: torch.Tensor, reduce) -> torch.Tensor:
    """The attention output over a whole sequence from the outputs
    ``out`` (..., B, H, D) over its pieces and the pieces' log-sum-exps
    ``lse`` (..., B, H) float32 (`decode_attention(..., return_lse=True)`):
    with M the maximum of the pieces' ``lse``, sum_r exp(lse_r - M) out_r
    / sum_r exp(lse_r - M), in float32 and returned in ``out``'s type.
    ``reduce(x, op)`` ("max" or "sum") reduces over the pieces: an
    all-reduce over the ranks that hold them (one max, then one sum of
    the weighted outputs beside their weights), or `reduce_pieces` over
    a leading dim of pieces held in one process. A piece with no valid
    position (lse -inf) weighs exactly 0; a row with none anywhere gives
    zeros."""
    m = reduce(lse, "max")
    m = torch.where(torch.isfinite(m), m, 0.0)         # rows empty everywhere
    w = torch.exp(lse - m)[..., None]
    part = reduce(torch.cat([out.float() * w, w], dim=-1), "sum")
    num, den = part[..., :-1], part[..., -1:]
    return (num / den.clamp(min=1e-30)).to(out.dtype)


def reduce_pieces(x: torch.Tensor, op: str) -> torch.Tensor:
    """`combine`'s reduction over pieces stacked on dim 0 in one process
    (the result keeps that dim, of size 1)."""
    return x.amax(0, keepdim=True) if op == "max" else x.sum(0, keepdim=True)


@dataclass(frozen=True)
class KVShard:
    """Where this rank's shard of a KV cache (L, B, S, Hkv, D) lies: the
    first of its positions, the groups that split the sequence and its
    whole length, the first of its KV heads, how many, and the groups
    that split the heads (empty tuples where that dim is whole)."""

    seq_offset: int
    seq_groups: tuple
    seq_len: int
    head_offset: int
    heads: int
    head_groups: tuple

    @classmethod
    def of(cls, leaf) -> "KVShard":
        """The shard of a cache leaf DTensor: K or V (L, B, S, Hkv, D),
        or a latent cache (L, B, S, R) with no head dim (one whole
        "head")."""
        from repro_torch.distributed.sharding import shard_offset
        mesh, placements = leaf.device_mesh, leaf.placements
        seq, seq_axes = shard_offset(mesh, placements, 2, leaf.shape[2])
        if leaf.dim() < 5:
            head, head_axes, heads = 0, (), 1
        else:
            head, head_axes = shard_offset(mesh, placements, 3,
                                           leaf.shape[3])
            heads = leaf.to_local().shape[3]
        return cls(seq, tuple(mesh.get_group(a) for a in seq_axes),
                   leaf.shape[2], head, heads,
                   tuple(mesh.get_group(a) for a in head_axes))

    def positions(self, slot, new_len, s: int):
        """A write slot and valid lengths (B,), global, as this shard's:
        less the offset of its positions, the lengths clipped to [0,
        ``s``] (its positions)."""
        return (slot - self.seq_offset,
                (new_len - self.seq_offset).clamp(0, s))

    def local_q(self, q, kv_heads: int):
        """q (B, 1, Hq, D) cut to the q heads that share this shard's KV
        heads (of ``kv_heads`` in all)."""
        g = q.shape[2] // kv_heads
        return q[:, :, self.head_offset * g:(self.head_offset + self.heads)
                 * g]

    def local_heads(self, q, k, v):
        """q (B, 1, Hq, D) and the new k, v (B, 1, Hkv, D) cut to this
        shard's KV heads and the q heads that share them."""
        lo, n = self.head_offset, self.heads
        return (self.local_q(q, k.shape[2]), k[:, :, lo:lo + n],
                v[:, :, lo:lo + n])

    def merge(self, out, lse) -> torch.Tensor:
        """This shard's attention output over its positions combined with
        the other sequence pieces' by ``lse`` (`combine` over the
        sequence's groups)."""
        return combine(out, lse, lambda x, op: _all_reduce(
            x, op, self.seq_groups))

    def finish(self, out, lse=None) -> torch.Tensor:
        """The full (B, Hq, D) output from this shard's (B, Hq_local, D):
        combined over the sequence's groups by ``lse``, then gathered
        over the heads' groups."""
        if self.seq_groups:
            out = self.merge(out, lse)
        return _gather(out, 1, self.head_groups)


@dataclass(frozen=True)
class StateShard:
    """Where this rank's shard of a recurrent state leaf lies along the
    dim that the layout splits (`STATE_DIMS`: the channels of ``conv``,
    ``h`` and the tail's, the heads of ``ssm``): the first of its
    entries, how many, and the groups that split that dim (empty where
    it is whole). Outside a tensor-parallel step `state_shard` gives the
    whole dim, and every method is then the identity or a view of it."""

    offset: int
    count: int
    groups: tuple

    @classmethod
    def of(cls, leaf, dim: int) -> "StateShard":
        """The shard of a state leaf DTensor along ``dim``."""
        from repro_torch.distributed.sharding import shard_offset
        dim %= leaf.dim()
        mesh = leaf.device_mesh
        offset, axes = shard_offset(mesh, leaf.placements, dim,
                                    leaf.shape[dim])
        return cls(offset, leaf.to_local().shape[dim],
                   tuple(mesh.get_group(a) for a in axes))

    def take(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """``t``'s entries of this shard along ``dim``: ``t`` itself where
        it is a 'model' shard (a parameter that the layout splits as it
        splits the state: ``conv_w``, ``conv_b``, ``lam``), else the
        shard's block cut from the whole ``t``."""
        ctx = _CURRENT.get()
        if ctx is not None and ctx.model_shard(t) is not None:
            block = ctx.local_block(t, dim % t.dim())
            if block != (self.offset, self.count):
                raise ValueError(f"tensor parallel: a parameter's block "
                                 f"{block} is not its state's "
                                 f"{(self.offset, self.count)}")
            return t
        return t.narrow(dim, self.offset, self.count)

    def columns(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """This shard's columns of ``x @ w``: the product itself where
        ``w`` is a 'model' shard of its columns (the rank's, checked by
        `take`), else cut from the whole product."""
        y = x @ w
        ctx = _CURRENT.get()
        if ctx is None or ctx.model_shard(w) is None:
            return y.narrow(-1, self.offset, self.count)
        self.take(w)
        return y

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """``x``, this shard's entries along ``dim``, all-gathered over
        the groups that split the state: the whole dim."""
        return _gather(x, dim, self.groups)


class TensorParallel:
    """The context of one tensor-parallel step: the 'model' axis of
    ``mesh`` (its group and this rank's index on it), the local
    parameter tensors that are 'model' shards and the dim each is split
    on (``shards``, by tensor identity), the `KVShard` of each attention
    cache by name (``kv``, `KV_CACHES`) and the `StateShard` of each
    recurrent state leaf by name (``states``, `STATE_DIMS`)."""

    def __init__(self, mesh, shards: dict[int, int],
                 kv: dict[str, KVShard],
                 states: dict[str, StateShard] | None = None):
        on_model = "model" in mesh.mesh_dim_names
        self.groups = (mesh.get_group("model"),) if on_model else ()
        self.rank = mesh.get_local_rank("model") if on_model else 0
        self.shards = shards
        self.kv = kv
        self.states = states or {}

    @classmethod
    def of_cache(cls, mesh, shards: dict[int, int], cache: dict
                 ) -> "TensorParallel":
        """The context of a step over ``cache`` (the decode cache's
        DTensors by name): a `KVShard` for each attention cache in it and
        a `StateShard` for each recurrent state leaf."""
        kv = {k: KVShard.of(v["k"] if isinstance(v, dict) else v)
              for k, v in cache.items() if k in KV_CACHES}
        states = {k: StateShard.of(cache[k], dim)
                  for k, dim in STATE_DIMS.items() if k in cache}
        return cls(mesh, shards, kv, states)

    def model_shard(self, w: torch.Tensor) -> int | None:
        """The dim of ``w`` split over 'model', or None (a whole
        tensor)."""
        return self.shards.get(id(w))

    def local_block(self, w: torch.Tensor, dim: int,
                    unit: int = 1) -> tuple[int, int] | None:
        """(the first, the count) of the blocks of ``unit`` along ``dim``
        that this rank holds of ``w``, a 'model' shard split on ``dim``
        in whole blocks; None where ``w`` is whole."""
        split = self.model_shard(w)
        if split is None:
            return None
        if split != dim or w.shape[dim] % unit:
            raise ValueError(f"tensor parallel: {tuple(w.shape)} split on "
                             f"dim {split}, not on {dim} in whole blocks "
                             f"of {unit}")
        n = w.shape[dim] // unit
        return self.rank * n, n

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x`` all-gathered over 'model' along ``dim``."""
        return _gather(x, dim, self.groups)

    def all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        return _all_reduce(x, op, self.groups)


def current() -> TensorParallel | None:
    """The installed context, None outside a tensor-parallel step."""
    return _CURRENT.get()


def kv_shard(cache: str) -> KVShard | None:
    """The installed context's shard of the attention cache ``cache``,
    None outside a tensor-parallel step."""
    ctx = _CURRENT.get()
    return None if ctx is None else ctx.kv[cache]


def state_shard(leaf: str, size: int) -> StateShard:
    """The installed context's shard of the recurrent state leaf
    ``leaf``; outside a tensor-parallel step the whole dim of ``size``
    entries."""
    ctx = _CURRENT.get()
    return StateShard(0, size, ()) if ctx is None else ctx.states[leaf]


@contextlib.contextmanager
def active(ctx: TensorParallel):
    """Install ``ctx`` for the sites while the block runs (in this thread
    and context only)."""
    token = _CURRENT.set(ctx)
    try:
        yield ctx
    finally:
        _CURRENT.reset(token)


def matmul(x: torch.Tensor, w: torch.Tensor,
           dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ w`` (``w`` cast to ``dtype`` first where it is given); in a
    tensor-parallel step where ``w`` is a 'model' shard of its columns,
    the full product, all-gathered over 'model'."""
    y = x @ (w if dtype is None else w.to(dtype))
    ctx = _CURRENT.get()
    dim = None if ctx is None else ctx.model_shard(w)
    if dim is None:
        return y
    if dim != w.dim() - 1:
        raise ValueError(f"tensor parallel: a product's weight {tuple(w.shape)}"
                         f" split on dim {dim}, not its columns")
    return ctx.gather(y, -1)
