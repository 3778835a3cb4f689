"""AdamW with mixed-precision discipline (port of `repro.train.optim`).

Parameters may live in bf16; the first and second moments are float32 and
the update is computed in float32 before it is cast back to each
parameter's type. Trees are dicts of tensors keyed by parameter name
(``dict(model.named_parameters())``), and the moments carry the same
names.

Weight decay follows the reference's rule, decoupled decay on leaves of
rank >= 2, taken on the reference's leaf: the reference stacks a layer
list on a leading axis, so every tensor of a stacked layer
(``layers.<i>.ln1``, ``layers.<i>.ssd.d_skip``, ...) is decayed even
where the port's own tensor is a vector, and ``final_norm`` and
``mtp.ln`` are not (`repro_torch.models.model.reference_leaf`).

Also global-norm clipping and the linear-warmup cosine schedule; the
schedule, ``b ** t`` and the bias corrections are float32 tensors, as the
reference computes them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models.model import reference_leaf

_F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor                    # () int32, updates applied so far
    mu: dict[str, torch.Tensor]           # float32 first moments
    nu: dict[str, torch.Tensor]           # float32 second moments


def adamw_init(params: dict[str, torch.Tensor]) -> AdamWState:
    dev = next(iter(params.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu={n: torch.zeros(p.shape, dtype=_F32, device=p.device)
            for n, p in params.items()},
        nu={n: torch.zeros(p.shape, dtype=_F32, device=p.device)
            for n, p in params.items()})


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(torch.stack([x.float().square().sum()
                                   for x in tree.values()]).sum())


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float,
                        norm: torch.Tensor | None = None):
    """(grads scaled to a global norm of at most ``max_norm``, each in its
    own type, and the norm before clipping). ``norm`` gives the global
    norm where ``grads`` hold only shards of the gradients."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {n: (g.float() * scale).to(g.dtype)
            for n, g in grads.items()}, norm


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether AdamW decays the parameter: the reference's leaf has rank
    >= 2 (a stacked layer's leaf has the layer axis besides the port's
    own)."""
    return p.dim() + reference_leaf(name)[1] >= 2


@torch.no_grad()
def adamw_update(grads: dict[str, torch.Tensor], state: AdamWState,
                 params: dict[str, torch.Tensor], lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    """One AdamW step: writes each new parameter into ``params`` in place
    (cast back to its type) and returns (params, the new state)."""
    step = state.step + 1
    t = step.to(_F32)
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    mu, nu = {}, {}
    for name, p in params.items():
        g32 = grads[name].float()
        m = b1 * state.mu[name] + (1 - b1) * g32
        v = b2 * state.nu[name] + (1 - b2) * g32.square()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if decays(name, p):
            delta = delta + weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        mu[name], nu[name] = m, v
    return params, AdamWState(step=step, mu=mu, nu=nu)


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1):
    """lr(step) in float32: linear warmup from 0 over ``warmup`` steps,
    then a cosine down to ``min_ratio`` x base_lr at ``total``."""
    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(_F32)
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi
                                                                  * frac))
        return torch.where(step < warmup, warm, base_lr * cos)

    return lr
