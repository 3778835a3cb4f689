"""Shared layer primitives: norms, rotary embeddings, MLP variants,
embeddings, initialization and the training loss. Plain functions on
tensors, in the reference's arithmetic (`repro.models.layers`): norms and
rotary embeddings in float32 and cast back, swiglu's ``silu`` in float32
and cast before the product, logits as a product in the weights' type
cast to float32, the cross-entropy in float32.

`rms_norm`, the MLP's products, `embed` and `unembed` consult the
tensor-parallel context (`repro_torch.distributed.tensor_parallel`):
inside the sharded serve step they compute on the rank's shards of the
weights, and inside the sharded prefill step on the rank's positions of
the sequence (the MLP on the gathered sequence's rank's ff columns, its
row product reduce-scattered onto the positions; the embedding
reduce-scattered onto them), which the sharded train step of the dense,
VLM and moe families runs too, with `unembed` left on the rank's vocabulary
rows and a vocab-parallel `cross_entropy`; elsewhere exactly as
written."""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tp

_F32 = torch.float32


def truncated_normal(generator: torch.Generator, shape, scale: float,
                     dtype: torch.dtype) -> torch.Tensor:
    """A standard normal truncated to [-2, 2], times ``scale``, drawn in
    float32 from ``generator`` on its device and cast to ``dtype``."""
    x = torch.empty(shape, dtype=_F32, device=generator.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (x * scale).to(dtype)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype) -> torch.Tensor:
    """Fan-in scaled (d_in, d_out) init."""
    return truncated_normal(generator, (d_in, d_out), d_in ** -0.5, dtype)


def init_rms(d: int, dtype: torch.dtype, device=None) -> torch.nn.Parameter:
    """A norm scale: zeros (gain 1), frozen until training turns its
    gradient on."""
    return torch.nn.Parameter(torch.zeros(d, dtype=dtype, device=device),
                              requires_grad=False)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             width: int | None = None) -> torch.Tensor:
    """RMS norm over the last dim, gain ``1 + scale``. Where ``scale`` is
    a 'model' shard (a stacked norm scale the fan-out rule splits): at
    decode the rank scales its slice of the normalised ``x`` and the
    slices are all-gathered, the scale never moving; in prefill, whose
    ``x`` is the rank's positions, the scale (a few KB) is gathered.
    Where ``width`` is given, ``x`` is this rank's block of a last dim of
    ``width`` entries whose other blocks lie on the other 'model' ranks,
    and ``scale`` is the block's own entries: the sums of squares are
    all-reduced over 'model' and divided by ``width``."""
    dt = x.dtype
    x = x.float()
    ctx = tp.current()
    if width is None:
        var = x.square().mean(dim=-1, keepdim=True)
    else:
        var = ctx.all_reduce(x.square().sum(dim=-1, keepdim=True),
                             "sum") / width
    out = x * torch.rsqrt(var + eps)
    if width is not None or ctx is None or ctx.model_shard(scale) is None:
        return (out * (1.0 + scale.float())).to(dt)
    if ctx.seq_len is not None:
        return (out * (1.0 + ctx.whole(scale).float())).to(dt)
    n = scale.shape[-1]
    part = out[..., ctx.rank * n:(ctx.rank + 1) * n]
    return ctx.gather((part * (1.0 + scale.float())).to(dt), -1)


@functools.cache
def _rope_freq(theta: float, half: int, device: torch.device) -> torch.Tensor:
    """exp(-log(theta) * i / half) for i < half, in float32 as the
    reference computes it; made once per device (a decode step would
    otherwise copy theta to the card in every layer)."""
    log_theta = torch.log(torch.tensor(theta, dtype=_F32))
    freq = torch.exp(-log_theta * torch.arange(0, half, dtype=_F32) / half)
    return freq.to(device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0,
         rotary_dim: int | None = None,
         has_head_axis: bool | None = None) -> torch.Tensor:
    """Rotary position embedding, half-split (not interleaved).

    x: (B, S, H, D) with a head axis (the default when x.dim() >= 4) or
    (B, S, D)/(S, D) without one; positions: (S,) or (B, S).
    ``rotary_dim`` rotates the first ``rotary_dim`` features only and
    passes the rest through."""
    dt = x.dtype
    d = x.shape[-1] if rotary_dim is None else rotary_dim
    half = d // 2
    if has_head_axis is None:
        has_head_axis = x.dim() >= 4
    freq = _rope_freq(float(theta), half, x.device)
    pos = torch.as_tensor(positions, device=x.device)
    ang = pos.float()[..., None] * freq                      # (..., S, half)
    if has_head_axis:
        ang = ang[..., None, :]                              # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:d].float()
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                    dim=-1).to(dt)
    if d < x.shape[-1]:
        rot = torch.cat([rot, x[..., d:]], dim=-1)
    return rot


# ----------------------------------------------------------------- MLPs
class MLP(torch.nn.Module):
    """MLP weights under the reference's names: ``w_gate``, ``w_up``,
    ``w_down`` (swiglu) or ``w_in``, ``w_down`` (gelu, relu2), each
    (fan-in, fan-out)."""

    def __init__(self, d: int, ff: int, mlp_type: str, dtype: torch.dtype,
                 device=None):
        super().__init__()
        names = (("w_gate", d, ff), ("w_up", d, ff), ("w_down", ff, d)) \
            if mlp_type == "swiglu" else (("w_in", d, ff), ("w_down", ff, d))
        for name, a, b in names:
            self.register_parameter(name, torch.nn.Parameter(
                torch.empty(a, b, dtype=dtype, device=device),
                requires_grad=False))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for w in self.parameters():
            w.copy_(dense_init(generator, w.shape[0], w.shape[1], w.dtype))


def init_mlp(generator: torch.Generator, d: int, ff: int, mlp_type: str,
             dtype: torch.dtype) -> MLP:
    """An `MLP` on the generator's device with fan-in scaled weights."""
    mod = MLP(d, ff, mlp_type, dtype, device=generator.device)
    mod.init(generator)
    return mod


def mlp_hidden(p, x: torch.Tensor, mlp_type: str,
               product=tp.matmul) -> torch.Tensor:
    """The MLP's activations before ``w_down``, each column product
    ``product(x, w)``."""
    if mlp_type == "swiglu":
        g = product(x, p.w_gate)
        u = product(x, p.w_up)
        return F.silu(g.float()).to(x.dtype) * u
    if mlp_type == "gelu":
        return F.gelu(product(x, p.w_in).float(),
                      approximate="tanh").to(x.dtype)
    if mlp_type == "relu2":  # squared ReLU (nemotron-4)
        return F.relu(product(x, p.w_in).float()).square().to(x.dtype)
    raise ValueError(mlp_type)


def mlp_partial(ctx, p, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    """Prefill's MLP on the gathered sequence ``x``: the rank's ff
    columns, then their rows of ``w_down``: the rank's partial sum of
    the output."""
    return mlp_hidden(p, x, mlp_type, ctx.columns) @ ctx.row_block(p.w_down)


def mlp(p, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    """The MLP. In a prefill step ``x`` is the rank's positions: gathered
    over the sequence, the rank's partial sum (`mlp_partial`)
    reduce-scattered back onto them."""
    ctx = tp.sequence_parallel()
    if ctx is not None:
        return ctx.seq_scatter(mlp_partial(ctx, p, ctx.seq_gather(x),
                                           mlp_type))
    return tp.matmul(mlp_hidden(p, x, mlp_type), p.w_down)


# ----------------------------------------------------------- embeddings
def init_embed(generator: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype) -> torch.Tensor:
    return truncated_normal(generator, (vocab, d), 1.0, dtype)


def _vocab_shard(table: torch.Tensor):
    """The tensor-parallel context when ``table`` is its rank's 'model'
    shard of the vocabulary rows, else None."""
    ctx = tp.current()
    dim = None if ctx is None else ctx.model_shard(table)
    if dim not in (None, 0):
        raise ValueError(f"tensor parallel: the embedding split on dim {dim}")
    return None if dim is None else ctx


def embed(table: torch.Tensor, tokens: torch.Tensor,
          prefix: torch.Tensor | None = None) -> torch.Tensor:
    """Rows of ``table`` by id, after the embeddings ``prefix`` (B, P,
    d) where it is given (a VLM's patches). On a vocab shard: the rank's
    rows, zeros for the ids other ranks hold, summed over 'model'
    (exactly the lookup: one term is not zero). In a prefill step the
    rank's positions of the sequence: on a vocab shard the sum is a
    reduce-scatter onto them, the prefix entering on 'model' rank 0."""
    ctx = _vocab_shard(table)
    seq = tp.sequence_parallel()
    if ctx is None:
        out = F.embedding(tokens, table)
        if prefix is not None:
            out = torch.cat([prefix, out], dim=1)
        return out if seq is None else seq.seq_local(out)
    rows = table.shape[0]
    local = tokens - ctx.rank * rows
    hit = ((local >= 0) & (local < rows))[..., None]
    out = torch.where(hit, F.embedding(local.clamp(0, rows - 1), table), 0.0)
    if seq is not None:
        if prefix is not None:
            first = prefix if ctx.rank == 0 else torch.zeros_like(prefix)
            out = torch.cat([first, out], dim=1)
        return seq.seq_scatter(out)
    out = ctx.all_reduce(out, "sum")
    return out if prefix is None else torch.cat([prefix, out], dim=1)


def unembed(table: torch.Tensor, x: torch.Tensor, valid_vocab: int,
            gather: bool = True) -> torch.Tensor:
    """Tied output head; padded vocab ids masked to -1e30. On a vocab
    shard: the logits of the rank's rows, masked, all-gathered over
    'model' (with ``gather`` False left on the rank: its block of the
    vocabulary, as `cross_entropy(..., vocab_parallel=True)` reads
    them)."""
    ctx = _vocab_shard(table)
    logits = (x @ table.T).float()
    v = table.shape[0]
    lo = 0 if ctx is None else ctx.rank * v
    if valid_vocab < lo + v:
        logits[..., max(valid_vocab - lo, 0):] = -1e30
    return logits if ctx is None or not gather else ctx.gather(logits, -1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  z_weight: float = 1e-4,
                  vocab_parallel: bool = False) -> torch.Tensor:
    """Mean token cross-entropy (float32) plus the z-loss ``z_weight *
    logz^2`` against logit drift; with ``mask`` (float, the labels'
    shape), the masked mean over at least one token.

    With ``vocab_parallel`` the logits are this 'model' rank's block of
    the vocabulary in the installed tensor-parallel step (`unembed(...,
    gather=False)` on a vocab shard): logz and the gold logit are reduced
    over 'model' from the local maximum (all-reduced with "max" and
    detached: a shift, it carries no gradient), and the local sum of
    exp beside the gold logit where the rank holds the label (one
    all-reduce with "sum"), so every 'model' rank holds the whole loss
    and no logit moves."""
    logits = logits.float()
    if not vocab_parallel:
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    else:
        ctx = tp.current()
        v = logits.shape[-1]
        m = ctx.all_reduce(logits.amax(dim=-1), "max")
        local = labels.long() - ctx.rank * v
        hit = (local >= 0) & (local < v)
        own = logits.gather(-1, local.clamp(0, v - 1)[..., None])[..., 0]
        part = ctx.all_reduce(torch.stack(
            [torch.exp(logits - m[..., None]).sum(dim=-1),
             torch.where(hit, own, 0.0)], dim=-1), "sum")
        logz = m + torch.log(part[..., 0])
        gold = part[..., 1]
    loss = logz - gold + z_weight * logz.square()
    if mask is not None:
        loss = loss * mask
        return loss.sum() / mask.sum().clamp(min=1.0)
    return loss.mean()
