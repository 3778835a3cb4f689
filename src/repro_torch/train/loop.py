"""Train and serve step factories (port of `repro.train.loop`).

`make_train_step` builds ``train_step(state, batch) -> (state,
metrics)``: the loss and its gradients (summed in float32 over
``accum_steps`` microbatches when that is above 1), then the optional
error-feedback int8 compression, global-norm clipping, the learning rate
of the step count *before* this update (so step 0 trains at lr 0 under
warmup) and AdamW, in the reference's order. The state's ``params`` are
the model's own parameters, updated in place; the reference returns new
ones. `make_serve_step` and `make_prefill_step` wrap the model's decode
step and full-sequence forward.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.distributed.compression import (compress_decompress,
                                                 init_error_feedback)
from repro_torch.models.model import Model
from repro_torch.train.optim import (AdamWState, adamw_init, adamw_update,
                                     clip_by_global_norm, cosine_schedule)


class TrainState(NamedTuple):
    params: dict[str, torch.Tensor]       # the model's parameters
    opt: AdamWState
    ef: dict[str, torch.Tensor] | None    # error-feedback residuals


def init_train_state(model: Model, seed: int | None = 0,
                     compress: bool = False) -> TrainState:
    """Draw the model's weights from ``seed`` (None keeps the weights it
    has), turn their gradients on, and start AdamW (and the residuals
    with ``compress``) from zeros."""
    if seed is not None:
        model.init(seed)
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return TrainState(params=params, opt=adamw_init(params),
                      ef=init_error_feedback(params) if compress else None)


def make_train_step(model: Model, base_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, clip_norm: float = 1.0,
                    accum_steps: int = 1, compress: bool = False):
    """Returns train_step(state, batch) -> (state, metrics), metrics
    ``loss``, ``grad_norm``, ``lr`` and, with ``accum_steps`` 1, the
    loss's own metrics (``ce``, ``aux``, ``mtp``), as float32 scalars.

    With ``accum_steps`` k > 1, microbatch i is rows [i B/k, (i+1) B/k)
    of every batch entry; the gradients are summed in float32 and scaled
    by 1/k, and so is the loss."""
    lr_fn = cosine_schedule(base_lr, warmup, total_steps)

    def grad_of(params, batch):
        loss, metrics = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, {
            n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(params.items(), grads)}

    def compute_grads(params, batch):
        if accum_steps == 1:
            return grad_of(params, batch)
        gsum = {n: torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device) for n, p in params.items()}
        loss_sum = 0.0
        for i in range(accum_steps):
            micro = {k: v[i * (v.shape[0] // accum_steps):
                          (i + 1) * (v.shape[0] // accum_steps)]
                     for k, v in batch.items()}
            loss, _, grads = grad_of(params, micro)
            for n, g in grads.items():
                gsum[n] += g.float()
            loss_sum = loss_sum + loss
        scale = 1.0 / accum_steps
        return loss_sum * scale, {}, {n: g * scale for n, g in gsum.items()}

    def train_step(state: TrainState, batch: dict):
        loss, metrics, grads = compute_grads(state.params, batch)
        ef = state.ef
        if compress:
            grads, ef = compress_decompress(grads, ef)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        lr = lr_fn(state.opt.step)
        params, opt = adamw_update(grads, state.opt, state.params, lr)
        out = {"loss": loss, "grad_norm": gnorm, "lr": lr, **metrics}
        return TrainState(params=params, opt=opt, ef=ef), out

    return train_step


def make_serve_step(model: Model):
    """Decode one token: serve_step(cache, tokens (B, 1)) -> (cache,
    logits), the cache updated in place."""

    def serve_step(cache: dict, tokens: torch.Tensor):
        return cache, model.decode_step(tokens, cache)

    return serve_step


def make_prefill_step(model: Model):
    """Full-sequence forward for prefill shapes: the last position's
    logits."""

    @torch.no_grad()
    def prefill_step(batch: dict) -> torch.Tensor:
        logits, _ = model.forward(batch["tokens"],
                                  frontend=batch.get("frontend"))
        return logits[:, -1]

    return prefill_step
