"""Mixture-of-Experts layer: top-k routing with row-parallel, capacity-based
dispatch (port of `repro.models.moe`).

Tokens are viewed as (rows, t_local), rows = the largest divisor of the
token count that is <= 32 (in a step that splits the batch over the data
axes, of the global batch's token count: each data rank routes its whole
rows of that grid, `routing_grid`), and all routing (sort, slotting,
gather, combine) happens within a row, in the reference's order: a stable
descending sort of each token's router probabilities picks its top k
(ties to the lower expert id, as `jax.lax.top_k` takes them), a stable
argsort of the row's flat expert ids gives each choice its slot within
its expert, and a choice whose slot reaches the row's capacity is
dropped (it contributes zero). The expert products are batched matrix
products over the experts' stacked (E, d, ff) weights, as the
reference's einsums, outside any kernel.

Covers dbrx (16 routed, top-4) and deepseek-v3 (1 shared + 256 routed,
top-8, d_ff 2048), with the switch-style load-balancing auxiliary loss.

In a tensor-parallel step (`repro_torch.distributed.tensor_parallel`)
the block is expert parallel: every 'model' rank routes the same rows
alike (the router's product gathered where 'model' splits its columns;
softmax, top-k, capacity and slots as above, over all E experts), fills
dispatch buffers for its own experts alone (the 'model' shard of the
stacked weights, E / n of them) and runs them, and the choices' expert
outputs, exact zeros on every rank but their expert's, are summed over
'model' before the top-k weighting. No expert weight moves.

In a prefill step (`tensor_parallel.sequence_parallel`) the block's
input is the rank's positions: they are all-gathered over the sequence
and every rank routes the rows' real positions alike (the capacity and
the drops of one process), runs its own experts, and reduce-scatters the
choices' outputs, with the shared expert's partial product as one more
slot, onto its positions; there it weights and sums them in the
one-process order.

In the train step (the prefill rule run forward and backward) the
auxiliary loss is the global batch's: the router probabilities' means and
the choices' counts are summed over the data axes before it is formed,
the means by the differentiable sum. The serve and prefill steps, which
drop it, pay for no such sum.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models.layers import MLP, dense_init, mlp, mlp_partial


class Experts(torch.nn.Module):
    """The routed experts' MLP weights stacked on a leading expert axis,
    under the reference's names: ``w_gate``, ``w_up``, ``w_down``
    (swiglu) or ``w_in``, ``w_down``, each (E, fan-in, fan-out)."""

    def __init__(self, e: int, d: int, ff: int, mlp_type: str,
                 dtype: torch.dtype, device=None):
        super().__init__()
        names = (("w_gate", d, ff), ("w_up", d, ff), ("w_down", ff, d)) \
            if mlp_type == "swiglu" else (("w_in", d, ff), ("w_down", ff, d))
        for name, a, b in names:
            self.register_parameter(name, torch.nn.Parameter(
                torch.empty(e, a, b, dtype=dtype, device=device),
                requires_grad=False))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """Fan-in scaled, drawn one expert at a time: a whole stack drawn
        in float32 at once would take several times its own memory
        (deepseek-v3's (256, 7168, 2048) is 15 GB in float32)."""
        for w in self.parameters():
            for i in range(w.shape[0]):
                w[i].copy_(dense_init(generator, w.shape[1], w.shape[2],
                                      w.dtype))


class MoE(torch.nn.Module):
    """``router`` (d, E) in float32 whatever the config's type (the
    reference draws it so), ``experts`` and, with shared experts,
    ``shared`` (an MLP of ``n_shared_experts * d_ff_expert``)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, e, ffe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
        self.router = torch.nn.Parameter(
            torch.zeros(d, e, dtype=torch.float32, device=device),
            requires_grad=False)
        self.experts = Experts(e, d, ffe, cfg.mlp_type, cfg.dtype, device)
        if cfg.n_shared_experts:
            self.shared = MLP(d, cfg.n_shared_experts * ffe, cfg.mlp_type,
                              cfg.dtype, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        self.router.copy_(dense_init(generator, *self.router.shape,
                                     torch.float32))
        self.experts.init(generator)
        if hasattr(self, "shared"):
            self.shared.init(generator)


def init_moe(generator: torch.Generator, cfg) -> MoE:
    mod = MoE(cfg, device=generator.device)
    mod.init(generator)
    return mod


def _expert_ffn(w, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    """x: (E, C, d) -> (E, C, d) with per-expert weights (E, d, ff)."""
    if mlp_type == "swiglu":
        g = torch.bmm(x, w.w_gate)
        u = torch.bmm(x, w.w_up)
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        h = F.gelu(torch.bmm(x, w.w_in).float(),
                   approximate="tanh").to(x.dtype)
    return torch.bmm(h, w.w_down)


def _n_rows(t: int, want: int) -> int:
    """Largest divisor of t that is <= want (row-parallel grid)."""
    r = math.gcd(t, want)
    while r > 1 and t % r:
        r -= 1
    return max(r, 1)


def top_k(probs: torch.Tensor, k: int):
    """The k largest values along the last axis and their indices, in
    descending order with ties to the lower index (`jax.lax.top_k`'s
    order; `torch.topk` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def routing_grid(t: int, n_data: int = 1, rows_hint: int = 32
                 ) -> tuple[int, int]:
    """(a data rank's routing rows, tokens a row) for ``t`` tokens on each
    of ``n_data`` data ranks: the global grid of ``n_data * t`` tokens
    (`_n_rows`), whose rows the data ranks hold in equal whole blocks.
    ValueError where a row would straddle two data ranks."""
    total = n_data * t
    r = _n_rows(total, rows_hint)
    if r % n_data:
        raise ValueError(f"moe_block: {total} tokens route as {r} rows of "
                         f"{total // r}, which {n_data} data ranks do not "
                         f"divide")
    return r // n_data, total // r


def moe_block(p, x: torch.Tensor, cfg, rows_hint: int = 32):
    """x: (B, S, d) -> (out (B, S, d), aux_loss float32 scalar). Expert
    parallel in a tensor-parallel step, and in a prefill step on the
    rank's positions; where the step splits the batch's rows over the
    data axes, routed on the global batch's row grid, and in the train
    step with the global batch's auxiliary loss (see the module
    docstring)."""
    seq = tp.sequence_parallel()
    ctx = tp.current()
    n_data = 1 if ctx is None else ctx.data_size
    b, d = x.shape[0], x.shape[-1]
    s = x.shape[1] if seq is None else seq.seq_len
    r, tl = routing_grid(b * s, n_data, rows_hint)
    if seq is not None:
        x = seq.seq_gather(x)[:, :s]
    t = n_data * b * s                                  # the global tokens
    e, k = cfg.n_experts, cfg.top_k
    xr = x.reshape(r, tl, d)

    # router matmul in the model dtype; softmax, top-k and the
    # renormalisation in float32
    logits = tp.matmul(xr, p.router, dtype=xr.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_k(probs, k)                              # (r, tl, k)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)

    n = tl * k
    flat_e = top_i.reshape(r, n)

    # load-balancing auxiliary (switch-style): E * sum_e f_e * p_e, over
    # the global batch in the train step (the data ranks' sums summed)
    me = probs.mean(dim=(0, 1))
    counts = torch.zeros((r, e), dtype=torch.int64, device=x.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    chosen = counts.sum(0)
    if ctx is not None and ctx.train and n_data > 1:
        me = ctx.data_sum(me) / n_data
        chosen = ctx.data_sum(chosen)
    ce = chosen.float() / float(t * k)
    aux = cfg.router_aux_weight * e * (me * ce).sum()

    # per-row capacity, rounded to a lane-friendly multiple
    cap = max(int(n / e * cfg.capacity_factor), 4)
    cap = ((cap + 7) // 8) * 8

    # slot within its expert of each choice, by a stable sort of the row
    order = torch.argsort(flat_e, dim=1, stable=True)           # (r, n)
    sorted_e = flat_e.gather(1, order)
    starts = counts.cumsum(1) - counts                          # (r, e) excl.
    pos_sorted = torch.arange(n, device=x.device) - starts.gather(1, sorted_e)
    slot = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    keep = slot < cap
    tok_of = torch.arange(n, device=x.device) // k              # (n,) local

    # the rank's experts [lo, lo + el) (all E outside expert parallelism)
    # and the kept choices they take; in a prefill step whose experts are
    # whole every choice is 'model' rank 0's
    block = ctx and ctx.local_block(p.experts.w_down, 0)
    lo, el = block or (0, e)
    mine = keep & (flat_e >= lo) & (flat_e < lo + el)
    if seq is not None and not block and seq.rank:
        mine = torch.zeros_like(mine)
    local_e = flat_e - lo

    # local token ids into (r, el*cap) dispatch buffers; the el*cap column
    # takes the dropped choices and the other ranks' and is thrown away
    dest = torch.where(mine, local_e * cap + slot, el * cap)    # (r, n)
    buf = torch.full((r, el * cap + 1), tl, dtype=torch.int64,
                     device=x.device)
    buf.scatter_(1, dest, tok_of.expand(r, n))
    gather_ids = buf[:, :el * cap]                              # (r, el*cap)

    xpad = torch.cat([xr, xr.new_zeros(r, 1, d)], dim=1)
    xe = xpad.gather(1, gather_ids[..., None].expand(r, el * cap, d))
    xe = xe.reshape(r, el, cap, d).transpose(0, 1).reshape(el, r * cap, d)
    ye = _expert_ffn(p.experts, xe, cfg.mlp_type)
    ye = ye.reshape(el, r, cap, d).transpose(0, 1)             # (r, el, cap, d)

    # combine: each token's k slots, weighted, summed in the model dtype;
    # under expert parallelism a slot is the sum over 'model' of one
    # rank's output and exact zeros
    y_flat = ye.reshape(r, el * cap, d)
    y_slot = y_flat.gather(
        1, dest.clamp(max=el * cap - 1)[..., None].expand(r, n, d))
    y_slot = torch.where(mine[..., None], y_slot, 0)            # (r, n, d)
    w_flat = (top_p.reshape(r, n) * keep).to(y_slot.dtype)
    if seq is not None:
        return _prefill_combine(seq, p, x, y_slot, w_flat, cfg), aux
    if block:
        y_slot = ctx.all_reduce(y_slot, "sum")
    contrib = (y_slot * w_flat[..., None]).reshape(r, tl, k, d)
    out = contrib.sum(dim=2)                                    # (r, tl, d)

    if hasattr(p, "shared"):
        out = out + mlp(p.shared, xr, cfg.mlp_type)
    return out.reshape(b, s, d), aux


def _prefill_combine(seq, p, x, y_slot, w_flat, cfg) -> torch.Tensor:
    """A prefill step's MoE output on the rank's positions (B, local, d)
    from the gathered rows' real positions ``x`` (B, S, d), the rank's
    choices' outputs ``y_slot`` (r, n, d) (zeros where another rank's
    expert took the choice) and their weights ``w_flat`` (r, n): the
    slots, and the shared expert's partial product (`mlp_partial`) as
    one more, reduce-scattered onto the rank's positions, then weighted
    and summed over the choices as one process sums them."""
    b, s, d = x.shape
    k = cfg.top_k
    slots = y_slot.reshape(b, s, k, d)
    if hasattr(p, "shared"):
        shared = mlp_partial(seq, p.shared, x, cfg.mlp_type)
        slots = torch.cat([slots, shared[:, :, None]], dim=2)
    slots = seq.seq_scatter(slots)                         # (B, local, k+1, d)
    w = seq.seq_local(w_flat.reshape(b, s, k))
    out = (slots[:, :, :k] * w[..., None]).sum(dim=2)
    return out + slots[:, :, k] if hasattr(p, "shared") else out
