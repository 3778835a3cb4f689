"""Shared layer primitives: norms, rotary embeddings, MLP variants,
embeddings, initialization and the training loss. Plain functions on
tensors, in the reference's arithmetic (`repro.models.layers`): norms and
rotary embeddings in float32 and cast back, swiglu's ``silu`` in float32
and cast before the product, logits as a product in the weights' type
cast to float32, the cross-entropy in float32."""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

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


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dt)


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


def mlp(p, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    if mlp_type == "swiglu":
        g = x @ p.w_gate
        u = x @ p.w_up
        h = F.silu(g.float()).to(x.dtype) * u
    elif mlp_type == "gelu":
        h = F.gelu((x @ p.w_in).float(), approximate="tanh").to(x.dtype)
    elif mlp_type == "relu2":  # squared ReLU (nemotron-4)
        h = F.relu((x @ p.w_in).float()).square().to(x.dtype)
    else:
        raise ValueError(mlp_type)
    return h @ p.w_down


# ----------------------------------------------------------- embeddings
def init_embed(generator: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype) -> torch.Tensor:
    return truncated_normal(generator, (vocab, d), 1.0, dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, table)


def unembed(table: torch.Tensor, x: torch.Tensor,
            valid_vocab: int) -> torch.Tensor:
    """Tied output head; padded vocab ids masked to -1e30."""
    logits = (x @ table.T).float()
    v = table.shape[0]
    if valid_vocab < v:
        logits[..., valid_vocab:] = -1e30
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  z_weight: float = 1e-4) -> torch.Tensor:
    """Mean token cross-entropy (float32) plus the z-loss ``z_weight *
    logz^2`` against logit drift; with ``mask`` (float, the labels'
    shape), the masked mean over at least one token."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    loss = logz - gold + z_weight * logz.square()
    if mask is not None:
        loss = loss * mask
        return loss.sum() / mask.sum().clamp(min=1.0)
    return loss.mean()
