"""Mixture-of-Experts layer: top-k routing with row-parallel, capacity-based
dispatch (port of `repro.models.moe`).

Tokens are viewed as (rows, t_local), rows = the largest divisor of the
token count that is <= 32, and all routing (sort, slotting, gather,
combine) happens within a row, in the reference's order: a stable
descending sort of each token's router probabilities picks its top k
(ties to the lower expert id, as `jax.lax.top_k` takes them), a stable
argsort of the row's flat expert ids gives each choice its slot within
its expert, and a choice whose slot reaches the row's capacity is
dropped (it contributes zero). The expert products are batched matrix
products over the experts' stacked (E, d, ff) weights, as the
reference's einsums, outside any kernel.

Covers dbrx (16 routed, top-4) and deepseek-v3 (1 shared + 256 routed,
top-8, d_ff 2048), with the switch-style load-balancing auxiliary loss.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import MLP, dense_init, mlp


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


def moe_block(p, x: torch.Tensor, cfg, rows_hint: int = 32):
    """x: (B, S, d) -> (out (B, S, d), aux_loss float32 scalar)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    r = _n_rows(t, rows_hint)
    tl = t // r
    xr = x.reshape(r, tl, d)

    # router matmul in the model dtype; softmax, top-k and the
    # renormalisation in float32
    logits = (xr @ p.router.to(xr.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_k(probs, k)                              # (r, tl, k)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)

    n = tl * k
    flat_e = top_i.reshape(r, n)

    # load-balancing auxiliary (switch-style): E * sum_e f_e * p_e
    me = probs.mean(dim=(0, 1))
    counts = torch.zeros((r, e), dtype=torch.int64, device=x.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    ce = counts.sum(0).float() / float(t * k)
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

    # local token ids into (r, e*cap) dispatch buffers; the e*cap column
    # takes the dropped choices and is thrown away
    dest = torch.where(keep, flat_e * cap + slot, e * cap)      # (r, n)
    buf = torch.full((r, e * cap + 1), tl, dtype=torch.int64,
                     device=x.device)
    buf.scatter_(1, dest, tok_of.expand(r, n))
    gather_ids = buf[:, :e * cap]                               # (r, e*cap)

    xpad = torch.cat([xr, xr.new_zeros(r, 1, d)], dim=1)
    xe = xpad.gather(1, gather_ids[..., None].expand(r, e * cap, d))
    xe = xe.reshape(r, e, cap, d).transpose(0, 1).reshape(e, r * cap, d)
    ye = _expert_ffn(p.experts, xe, cfg.mlp_type)
    ye = ye.reshape(e, r, cap, d).transpose(0, 1)               # (r, e, cap, d)

    # combine: each token's k slots, weighted, summed in the model dtype
    y_flat = ye.reshape(r, e * cap, d)
    y_slot = y_flat.gather(
        1, dest.clamp(max=e * cap - 1)[..., None].expand(r, n, d))
    y_slot = torch.where(keep[..., None], y_slot, 0)            # (r, n, d)
    w_flat = (top_p.reshape(r, n) * keep).to(y_slot.dtype)
    contrib = (y_slot * w_flat[..., None]).reshape(r, tl, k, d)
    out = contrib.sum(dim=2)                                    # (r, tl, d)

    if hasattr(p, "shared"):
        out = out + mlp(p.shared, xr, cfg.mlp_type)
    return out.reshape(b, s, d), aux
