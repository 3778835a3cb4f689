"""Tensor-parallel decode, prefill and training.

Decode: the sharded serve step of every family computes
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

Tensor-parallel prefill (every family) is sequence parallel with
tensor-parallel sub-blocks, as in Megatron-LM (Korthikanti et al.,
2022), under the reference's layout constraints: the residual stream
between sub-blocks holds the rank's block of the sequence's positions,
padded at its end to a multiple of 'model' (`seq_local`). A prefill
holds far more positions than a weight has rows, so there the weights
stay and the activations move twice a sub-block:

  * into an attention, MLP, MoE, SSD or RG-LRU sub-block the normed
    activations of the rank's positions are all-gathered along the
    sequence (`seq_gather`); out of it the partial sums of its row
    product are summed over 'model' onto the rank's positions by one
    reduce-scatter (`seq_scatter`);
  * the column products take the rank's block of the columns (its q
    heads of ``wq``, its ff columns of ``w_gate``/``w_up``/``w_in``,
    its heads of MLA's ``w_uq``/``w_ukv``, its channels of the RG-LRU's
    ``w_x``/``w_gate``/``w_r``/``w_i``: `column_block`), and the row
    products the rank's rows of ``wo``, ``w_down``, ``out_proj`` and
    ``w_out`` (`row_block`: one all-to-all brings a column-split
    weight's rows, 1/n of it);
  * where the KV heads do not divide 'model' the rank still needs the
    whole KV heads its q heads read (the reference's repeat-KV rule):
    their columns of ``wk``/``wv`` come by one all-to-all from the
    ranks that hold them (`columns_of`), as the SSD's ``in_proj``
    columns of the rank's heads do (z, xs and dt, with B and C whole,
    four spans in one all-to-all);
  * where the q heads do not divide 'model' (recurrentgemma's 10,
    whisper's 8, on 16 ranks) an attention keeps the rank's positions,
    as the reference's layout falls back to: every head from the whole
    ``wq``/``wk``/``wv``, the K/V of the rank's positions all-gathered
    along the sequence and cut to its real positions (`seq_whole`), the
    queries at their global positions, and the whole ``wo``, with no
    reduce-scatter;
  * an encoder's frames run under a context of their own length
    (`with_seq_len`), on the rank's frames; its output is gathered once
    and cut to the real frames, the memory that every cross-attention
    reads whole;
  * the SSD's gated norm over the whole ``d_inner`` all-reduces each
    position's sum of squares of the rank's heads' channels; the
    RG-LRU's gates read every channel of the convolved input, which is
    all-gathered over the channels;
  * a norm's scale, the router, MLA's ``w_dq``/``w_dkv`` (whose latents
    every head reads) and the SSD's convolution are gathered whole
    (`whole`, `entries`; `matmul` gathers a split weight whole in
    prefill), never their outputs;
  * the embedding is a masked lookup of the rank's vocab rows at every
    position, a VLM's patches prepended, reduce-scattered onto the
    rank's positions; the final norm and the unembedding run on the last
    real position alone, sent from the rank that holds it
    (`seq_last`), the vocab shards' logits then all-gathered;
  * a MoE layer routes the gathered rows' real positions alike on every
    rank, runs the rank's own experts, and its choices' outputs (each
    nonzero on one rank) and the shared expert's partial product are
    reduce-scattered onto the rank's positions together, then weighted
    and summed in the one-process order.

Pads sit after every real position, so causal attention, the causal
convolutions and the scans never let a real position see one, K/V are
cut to the real positions before any attention, and the MoE never routes
them.

Where a step splits the batch's rows over the data axes, a MoE layer
routes the rank's tokens on the global batch's row grid, as the
reference's jitted step routes the whole batch: the rows are the
largest divisor of every data rank's tokens together that is at most
32, each data rank holds whole rows of it (its rows of the batch are
contiguous, pod-major), and the capacity comes from their length. A
grid row that would straddle two data ranks raises ValueError.

Tensor-parallel training (the dense, VLM and moe families so far) runs
`Model.loss` forward under the prefill rule and backward through it: the
final norm on the rank's positions, the normed states of every real
position all-gathered, the head on the rank's vocabulary rows and a
vocab-parallel cross-entropy (`repro_torch.models.layers.cross_entropy`),
never gathering the logits or the embedding. Each collective is an
autograd function whose backward is its exact adjoint: an all-gather's
a sum reduce-scatter along the same dim and groups, a reduce-scatter's an
all-gather, a sum all-reduce's a sum all-reduce, an all-to-all's the
all-to-all with the blocks' sizes swapped; a "max" all-reduce only
shifts a log-sum-exp and is detached. The loss convention: the global
loss is the sum over every rank of the rank's term, its data rows' mean
loss divided by (data ranks x 'model' ranks), and each rank's backward
is seeded with its term. A term that every 'model' rank computes alike
(the cross-entropy, whole on each after its all-reduces) then counts n
times 1/n; a term of the rank's own positions sums over the ranks to the
whole sequence. So a 'model' shard of a parameter gets its whole
gradient from the adjoints, and a parameter that the layout replicates
over an axis gets its gradient by summing the ranks' over that axis
(`repro_torch.train.loop.sharded_gradients`).

In the moe family's train step the expert-parallel block runs backward
through its sequence all-gather, the router's whole gather (its
gradient reduce-scattered back where 'model' splits its columns) and the
reduce-scatter of the choices' outputs with the shared expert's partial
product; each of the rank's experts gets gradient only from the choices
it took, and where the experts are whole (every choice 'model' rank
0's) the other ranks' experts get zeros. The auxiliary loss is the
global batch's: the router probabilities' column means and the choices'
counts are summed over the data axes before it is formed (the means by
the differentiable sum, the counts by a plain one), so it is equal on
all data x 'model' ranks and, by the convention, counts once; the sum's
adjoint brings each data rank's router its share. MLA runs backward on
the rank's heads of ``w_uq``/``w_ukv`` and rows of ``wo``, its
``w_dq``/``w_dkv`` and norms whole (their gradients reduce-scattered
back). DeepSeek-V3's multi-token-prediction depth gathers the trunk's
real positions once, cut to all but the last, and runs under a context
of that length (`with_seq_len`): its norm on the rank's positions, the
embedding of the next tokens reduce-scattered onto them, ``proj``
gathered whole (14336 x 7168 bf16, 205 MB at full width, where
gathering the positions' merged input instead would move 1.9 GB a
rank at 16 rows of 4096), the block under the prefill rule and a
vocab-parallel head, so its loss is whole and equal on every 'model'
rank, counted once like the cross-entropy.

The sites consult the `TensorParallel` context that `active` installs
(`repro_torch.train.loop.make_sharded_serve_step` does, around the
model's `decode_step`, `make_sharded_prefill_step` around its
`last_logits`, and `sharded_gradients` around its `loss`, both with the
sequence's length: `sequence_parallel`); with none installed each
computes what the one-process model computes. The collectives, the
backward's too, are the `_c10d_functional` ops, so they run alike on
NCCL, on gloo and on the dry run's fake process group over meta tensors,
whose census counts them (`repro_torch.launch.dryrun`).
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
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


def _gather_one(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x`` concatenated along ``dim`` over the ranks of ``group``."""
    import torch.distributed as dist
    c10d = torch.ops._c10d_functional
    n = dist.get_world_size(group)
    out = c10d.wait_tensor(c10d.all_gather_into_tensor(
        x.contiguous(), n, group.group_name))
    return out if dim == 0 else torch.cat(out.chunk(n), dim=dim)


def _reduce_scatter_one(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` and split along ``dim``
    into their equal blocks: this rank's block."""
    import torch.distributed as dist
    c10d = torch.ops._c10d_functional
    n = dist.get_world_size(group)
    y = c10d.wait_tensor(c10d.reduce_scatter_tensor(
        x.movedim(dim, 0).contiguous(), "sum", n, group.group_name))
    return y.movedim(0, dim)


def _all_reduce_one(x: torch.Tensor, op: str, group) -> torch.Tensor:
    c10d = torch.ops._c10d_functional
    return c10d.wait_tensor(c10d.all_reduce(x.contiguous(), op,
                                            group.group_name))


def _all_to_all_one(x: torch.Tensor, recv: list[int], send: list[int],
                    group) -> torch.Tensor:
    c10d = torch.ops._c10d_functional
    return c10d.wait_tensor(c10d.all_to_all_single(
        x.contiguous(), recv, send, group.group_name))


class _AllGather(torch.autograd.Function):
    """All-gather along a dim; its adjoint the sum reduce-scatter."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_one(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_one(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    """Sum reduce-scatter along a dim; its adjoint the all-gather."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter_one(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_one(g, ctx.dim, ctx.group), None, None


class _AllReduceSum(torch.autograd.Function):
    """Sum all-reduce; its own adjoint."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_one(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_one(g, "sum", ctx.group), None


class _AllToAll(torch.autograd.Function):
    """All-to-all of row blocks; its adjoint the all-to-all with the
    blocks' sizes swapped."""

    @staticmethod
    def forward(ctx, x, recv, send, group):
        ctx.recv, ctx.send, ctx.group = recv, send, group
        return _all_to_all_one(x, recv, send, group)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all_one(g, ctx.send, ctx.recv, ctx.group), None,
                None, None)


def all_gather(x: torch.Tensor, dim: int, groups) -> torch.Tensor:
    """``x`` concatenated along ``dim`` over the ranks of ``groups`` (the
    process groups of the mesh dims that split it, major first); its
    gradient is reduce-scattered back (`_AllGather`)."""
    dim = dim % x.dim()
    for group in reversed(groups):          # the minor axis first
        x = _AllGather.apply(x, dim, group)
    return x


def _all_reduce(x: torch.Tensor, op: str, groups) -> torch.Tensor:
    """``x`` reduced (``op`` "sum" or "max") over the ranks of
    ``groups``; a new tensor. A "max" only ever stabilises (a
    log-sum-exp's shift): it is detached and carries no gradient."""
    if op == "max":
        x = x.detach()
        for group in groups:
            x = _all_reduce_one(x, op, group)
        return x
    for group in groups:
        x = _AllReduceSum.apply(x, group)
    return x


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` and split along ``dim``
    into their equal blocks: this rank's block."""
    return _ReduceScatter.apply(x, dim % x.dim(), group)


def _all_to_all(x: torch.Tensor, recv: list[int], send: list[int],
                group) -> torch.Tensor:
    """``x``'s rows sent in blocks of ``send`` rows to the ranks of
    ``group`` in order, and the blocks of ``recv`` rows received from
    them, in order."""
    return _AllToAll.apply(x, recv, send, group)


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
        return all_gather(out, 1, self.head_groups)


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
        """This shard's columns of ``x @ w``: ``x`` times ``w`` where it is
        a 'model' shard of its columns (the rank's, checked by `take`),
        else times this shard's columns cut from the whole ``w``."""
        return x @ self.take(w)

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """``x``, this shard's entries along ``dim``, all-gathered over
        the groups that split the state: the whole dim."""
        return all_gather(x, dim, self.groups)


class TensorParallel:
    """The context of one tensor-parallel step: the 'model' axis of
    ``mesh`` (its group, its size and this rank's index on it), the
    local parameter tensors that are 'model' shards and the dim each is
    split on (``shards``, by tensor identity), the `KVShard` of each
    attention cache by name (``kv``, `KV_CACHES`) and the `StateShard` of
    each recurrent state leaf by name (``states``, `STATE_DIMS`); in a
    prefill step ``seq_len``, the sequence's length, which selects the
    prefill rule (`sequence_parallel`). Where the step splits the batch's
    rows over the data axes, ``data`` is (this rank's index along them,
    pod-major; their size; their process groups), so that a MoE layer
    routes on the global batch's row grid (``data_rank``, ``data_size``,
    ``data_groups``; one data rank where ``data`` is None); ``train``
    makes its auxiliary loss the global batch's, summed over them."""

    def __init__(self, mesh, shards: dict[int, int],
                 kv: dict[str, KVShard],
                 states: dict[str, StateShard] | None = None,
                 seq_len: int | None = None,
                 data: tuple[int, int, list] | None = None,
                 train: bool = False):
        names = mesh.mesh_dim_names
        on_model = "model" in names
        self.groups = (mesh.get_group("model"),) if on_model else ()
        self.rank = mesh.get_local_rank("model") if on_model else 0
        self.size = mesh.size(names.index("model")) if on_model else 1
        self.shards = shards
        self.kv = kv
        self.states = states or {}
        self.data_rank, self.data_size, self.data_groups = data or (0, 1, [])
        self.train = train
        # prefill's rule (`sequence_parallel`): the sequence's length, its
        # length padded to a multiple of 'model', the rank's positions
        self._set_seq_len(seq_len)

    def _set_seq_len(self, seq_len: int | None) -> None:
        self.seq_len = seq_len
        if seq_len is not None:
            self.seq_block = -(-seq_len // self.size)
            self.seq_padded = self.seq_block * self.size

    def with_seq_len(self, seq_len: int) -> "TensorParallel":
        """This context over another sequence of ``seq_len`` positions (an
        encoder's frames): the same mesh and shards, the prefill rule on
        the new sequence's positions."""
        ctx = copy.copy(self)
        ctx._set_seq_len(seq_len)
        return ctx

    @classmethod
    def of_cache(cls, mesh, shards: dict[int, int], cache: dict,
                 data: tuple[int, int, list] | None = None
                 ) -> "TensorParallel":
        """The context of a step over ``cache`` (the decode cache's
        DTensors by name): a `KVShard` for each attention cache in it and
        a `StateShard` for each recurrent state leaf."""
        kv = {k: KVShard.of(v["k"] if isinstance(v, dict) else v)
              for k, v in cache.items() if k in KV_CACHES}
        states = {k: StateShard.of(cache[k], dim)
                  for k, dim in STATE_DIMS.items() if k in cache}
        return cls(mesh, shards, kv, states, data=data)

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
        return all_gather(x, dim, self.groups)

    def all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        return _all_reduce(x, op, self.groups)

    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data axes (its adjoint the same sum)."""
        return _all_reduce(x, "sum", self.data_groups)

    # ------------------------------------------- prefill (sequence parallel)
    def block(self, total: int) -> tuple[int, int]:
        """(the first, the count) of this rank's equal block of ``total``
        units (heads, ff columns, rows) over 'model'."""
        if total % self.size:
            raise ValueError(f"tensor parallel: {total} heads or columns "
                             f"on {self.size} 'model' ranks")
        n = total // self.size
        return self.rank * n, n

    def whole(self, w: torch.Tensor) -> torch.Tensor:
        """``w`` whole: all-gathered over 'model' where it is a shard."""
        dim = self.model_shard(w)
        return w if dim is None else self.gather(w, dim)

    def entries(self, t: torch.Tensor, lo: int, n: int,
                dim: int = -1) -> torch.Tensor:
        """Entries [lo, lo + n) of ``t`` along ``dim``: ``t`` itself where
        it is a 'model' shard that holds exactly them, else cut from the
        whole ``t`` (gathered where it is a shard of other entries)."""
        dim %= t.dim()
        if self.model_shard(t) == dim and t.shape[dim] == n \
                and self.rank * n == lo:
            return t
        return self.whole(t).narrow(dim, lo, n)

    def column_block(self, w: torch.Tensor, unit: int = 1) -> torch.Tensor:
        """This rank's block of ``w``'s columns in whole units of ``unit``
        (a head's columns): ``w`` itself where it is a 'model' shard of
        its columns, else cut from the whole ``w``."""
        if self.model_shard(w) is None:
            lo, n = self.block(w.shape[-1] // unit)
            return w.narrow(-1, lo * unit, n * unit)
        self.local_block(w, w.dim() - 1, unit)
        return w

    def columns(self, x: torch.Tensor, w: torch.Tensor,
                unit: int = 1) -> torch.Tensor:
        """``x`` times this rank's block of ``w``'s columns."""
        return x @ self.column_block(w, unit)

    def row_block(self, w: torch.Tensor) -> torch.Tensor:
        """This rank's block of the rows of a 2-D ``w`` with all its
        columns: cut from the whole ``w``, or, where ``w`` is a 'model'
        shard of its columns, brought by one all-to-all over 'model'
        (each rank sends every rank that rank's rows of its columns):
        1/n of the weight moves."""
        lo, m = self.block(w.shape[0])
        dim = self.model_shard(w)
        if dim is None:
            return w.narrow(0, lo, m)
        if dim != 1:
            raise ValueError(f"tensor parallel: a row product's weight "
                             f"{tuple(w.shape)} split on dim {dim}")
        n, c = self.size, w.shape[1]
        out = _all_to_all(w, [m] * n, [m] * n, self.groups[0])
        return out.reshape(n, m, c).permute(1, 0, 2).reshape(m, n * c)

    def columns_of(self, w: torch.Tensor, ranges) -> torch.Tensor:
        """Columns [lo, hi) of a 2-D ``w``, (lo, hi) this rank's entry of
        ``ranges`` (one a 'model' rank, the same list on every rank), or
        where the entry is a list of such spans (ascending, disjoint) their
        columns one after another: cut from the whole ``w``, or, where
        ``w`` is a 'model' shard of its columns, brought by one all-to-all
        over 'model' from the ranks that hold them (each sends every rank
        the part of its columns that rank asks for); the identity where
        every rank asks for its own."""
        def merged(entry):                  # adjacent spans joined
            out = []
            for lo, hi in [entry] if isinstance(entry[0], int) else entry:
                if out and out[-1][1] == lo:
                    out[-1] = (out[-1][0], hi)
                else:
                    out.append((lo, hi))
            return out

        wants = [merged(e) for e in ranges]
        spans = wants[self.rank]
        if any(a[1] > b[0] for a, b in zip(spans, spans[1:])):
            raise ValueError(f"tensor parallel: column spans {spans} are "
                             f"not ascending and disjoint")
        dim = self.model_shard(w)
        if dim is None:
            return torch.cat([w[:, lo:hi] for lo, hi in spans], 1) \
                if len(spans) > 1 else w[:, spans[0][0]:spans[0][1]]
        if dim != 1:
            raise ValueError(f"tensor parallel: {tuple(w.shape)} split on "
                             f"dim {dim}, not its columns")
        c = w.shape[1]
        held = [(r * c, (r + 1) * c) for r in range(self.size)]
        if all(want == [h] for want, h in zip(wants, held)):
            return w

        def part(a, b):
            return max(a[0], b[0]), min(a[1], b[1])

        mine = held[self.rank]
        # to each rank the part of each of its spans that this rank holds;
        # from each rank the part of each of this rank's spans it holds: the
        # spans ascend, so both orders are ascending columns
        sends = [[part(mine, s) for s in want] for want in wants]
        send = [sum(max(b - a, 0) for a, b in parts) for parts in sends]
        recv = [sum(max(b - a, 0) for a, b in (part(h, s) for s in spans))
                for h in held]
        wt = w.T
        pieces = [wt[a - mine[0]:b - mine[0]] for parts in sends
                  for a, b in parts if b > a]
        x = torch.cat(pieces) if pieces else wt[:0]
        return _all_to_all(x, recv, send, self.groups[0]).T

    def seq_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's positions (dim 1) all-gathered over 'model': every
        position of the padded sequence."""
        return all_gather(x, 1, self.groups)

    def seq_whole(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's positions (dim 1) all-gathered over 'model' and cut
        to the sequence's real positions: the pads at its end dropped."""
        return self.seq_gather(x)[:, :self.seq_len]

    def _padded(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (B, L <= the padded length, ...) zero-padded along dim
        1 to the padded length."""
        pad = self.seq_padded - x.shape[1]
        if pad == 0:
            return x
        return torch.cat([x, x.new_zeros(x.shape[0], pad, *x.shape[2:])], 1)

    def seq_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (B, L, ...), a rank's partial sum over the sequence's
        first L positions, padded, summed over 'model' and split onto the
        ranks' positions by one reduce-scatter: the rank's (B, local,
        ...)."""
        x = self._padded(x)
        return _reduce_scatter(x, 1, self.groups[0]) if self.groups else x

    def seq_local(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's positions of ``x`` (B, L, ...), a tensor every rank
        holds whole, padded."""
        return self._padded(x).narrow(1, self.rank * self.seq_block,
                                      self.seq_block)

    def seq_last(self, h: torch.Tensor) -> torch.Tensor:
        """(B, ...) of the sequence's last real position from ``h`` (B,
        local, ...), the rank's positions: the holder's row, zeros on
        every other rank, summed over 'model' (exact: one term is not
        zero)."""
        owner, j = divmod(self.seq_len - 1, self.seq_block)
        row = h[:, j]
        if not self.groups:
            return row
        return self.all_reduce(row if self.rank == owner
                               else torch.zeros_like(row), "sum")

    def kv_ranges(self, n_heads: int, n_kv_heads: int, d_head: int
                  ) -> list[tuple[int, int]]:
        """Each 'model' rank's (lo, hi) columns of ``wk``/``wv``: the
        whole KV heads its block of the q heads reads."""
        g = n_heads // n_kv_heads
        _, hl = self.block(n_heads)
        return [((r * hl // g) * d_head, (((r + 1) * hl - 1) // g + 1)
                 * d_head) for r in range(self.size)]


def current() -> TensorParallel | None:
    """The installed context, None outside a tensor-parallel step."""
    return _CURRENT.get()


def kv_shard(cache: str) -> KVShard | None:
    """The installed context's shard of the attention cache ``cache``,
    None outside a tensor-parallel step."""
    ctx = _CURRENT.get()
    return None if ctx is None else ctx.kv[cache]


def sequence_parallel() -> TensorParallel | None:
    """The installed context where it is a prefill's (sequence parallel:
    it knows the sequence's length), else None."""
    ctx = _CURRENT.get()
    return None if ctx is None or ctx.seq_len is None else ctx


def last_position(h: torch.Tensor) -> torch.Tensor:
    """(B, ...) of the last position of the hidden states ``h``: ``h[:,
    -1]``, or in a prefill step the sequence's last real position, sent
    from the rank that holds it (`TensorParallel.seq_last`)."""
    ctx = sequence_parallel()
    return h[:, -1] if ctx is None else ctx.seq_last(h)


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
    the full product: at decode its output all-gathered over 'model', in
    prefill (whose rows outnumber the weight's) the weight gathered
    whole."""
    ctx = _CURRENT.get()
    dim = None if ctx is None else ctx.model_shard(w)
    w = w if dtype is None else w.to(dtype)
    if dim is not None and ctx.seq_len is not None:
        return x @ ctx.gather(w, dim)
    y = x @ w
    if dim is None:
        return y
    if dim != w.dim() - 1:
        raise ValueError(f"tensor parallel: a product's weight {tuple(w.shape)}"
                         f" split on dim {dim}, not its columns")
    return ctx.gather(y, -1)
