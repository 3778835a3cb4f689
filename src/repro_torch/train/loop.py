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

`make_sharded_train_step` is the twin of the reference's SPMD step (its
jitted `make_train_step` over parameters placed by `param_shardings` and
a batch split over 'data'), on a `DeviceMesh` with DTensor state.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.distributed.compression import (compress_decompress,
                                                 init_error_feedback)
from repro_torch.distributed.sharding import param_shardings
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


def init_sharded_train_state(model: Model, mesh, seed: int | None = 0
                             ) -> TrainState:
    """`init_train_state` on a `DeviceMesh`: the weights drawn from
    ``seed`` on every rank alike (None keeps the ones the model has),
    then held as DTensors placed by ``param_shardings(model, mesh)``, and
    the AdamW moments as float32 zeros placed by its ``zero=True``
    layout. The model's own parameters (gradients on) become the
    buffers each step gathers into."""
    from torch.distributed.tensor import distribute_tensor
    if seed is not None:
        model.init(seed)
    p_sh = param_shardings(model, mesh)
    m_sh = param_shardings(model, mesh, zero=True)
    params, mu, nu = {}, {}, {}
    for name, p in model.named_parameters():
        p.requires_grad_(True)
        params[name] = distribute_tensor(p.detach().clone(), mesh,
                                         p_sh[name].placements,
                                         src_data_rank=None)
        for tree in (mu, nu):
            tree[name] = distribute_tensor(
                torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                mesh, m_sh[name].placements, src_data_rank=None)
    step = torch.zeros((), dtype=torch.int32, device=model.device)
    return TrainState(params=params, opt=AdamWState(step=step, mu=mu, nu=nu),
                      ef=None)


def _data_rank(mesh) -> tuple[int, int, list]:
    """(this rank's index along the data axes, pod-major; their size;
    their process groups)."""
    names = mesh.mesh_dim_names
    axes = ("pod", "data") if "pod" in names else ("data",)
    idx, n = 0, 1
    for ax in axes:
        size = mesh.size(names.index(ax))
        idx, n = idx * size + mesh.get_local_rank(ax), n * size
    return idx, n, [mesh.get_group(ax) for ax in axes]


def make_sharded_train_step(model: Model, mesh, base_lr: float = 3e-4,
                            warmup: int = 100, total_steps: int = 10_000,
                            clip_norm: float = 1.0):
    """Returns train_step(state, batch) -> (state, metrics) over a state
    from `init_sharded_train_state` on ``mesh`` (a `DeviceMesh` over the
    default process group, with a 'data' axis and optionally 'pod' and
    'model'). Every rank passes the same global ``batch``, whose rows the
    data axes must divide (ValueError otherwise: no row is dropped);
    metrics as `make_train_step`'s with ``accum_steps`` 1, averaged over
    'data'. The layouts are `param_shardings`' under the active
    `set_fsdp` mode.

    One step: each parameter DTensor is gathered to a full tensor and
    written into the model's own parameter; the model's unchanged
    `Model.loss` runs on the rank's rows of the batch (split over the
    data axes, pod-major); the gradients are summed over the data axes
    and divided by their size; the global norm is taken over the
    optimizer layout's shards (each shard's sum of squares divided by
    the ranks that replicate it, summed over every rank), so it is the
    one-process clip's norm up to the order of the sums; then AdamW
    (`adamw_update`, the one-process arithmetic) updates each rank's
    shard of the ``zero=True`` layout, and the new parameters are
    redistributed to the parameters' layout.

    The 'model' ranks hold the parameters sharded but compute
    redundantly: this twin shards storage, as the reference's explicit
    step does, and leaves tensor-parallel compute for later. The model
    runs on plain tensors, not DTensors: DTensor has no sharding rule for
    the port's custom autograd functions or its kernels' wrappers. No
    gradient accumulation or compression here."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor
    lr_fn = cosine_schedule(base_lr, warmup, total_steps)
    p_sh = param_shardings(model, mesh)
    m_sh = param_shardings(model, mesh, zero=True)
    sizes = mesh.mesh.shape
    repl = {n: math.prod(s for s, pl in zip(sizes, sh.placements)
                         if pl.is_replicate()) for n, sh in m_sh.items()}
    idx, n_data, data_groups = _data_rank(mesh)
    params = dict(model.named_parameters())

    def shard(full: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's shard of a full tensor in the optimizer layout (a
        copy, never a view of ``full``)."""
        return distribute_tensor(full, mesh, m_sh[name].placements,
                                 src_data_rank=None).to_local().clone()

    def data_mean(t: torch.Tensor) -> torch.Tensor:
        for g in data_groups:
            dist.all_reduce(t, group=g)
        return t / n_data

    def train_step(state: TrainState, batch: dict):
        n_rows = next(iter(batch.values())).shape[0]
        if n_rows % n_data:
            raise ValueError(f"make_sharded_train_step: a batch of {n_rows} "
                             f"rows on {n_data} data ranks")
        rows = n_rows // n_data
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(state.params[name].full_tensor())
        local = {k: v[idx * rows:(idx + 1) * rows] for k, v in batch.items()}
        loss, metrics = model.loss(local)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        with torch.no_grad():
            g_loc = {}
            for (name, p), g in zip(params.items(), grads):
                g = torch.zeros_like(p) if g is None else data_mean(g)
                g_loc[name] = shard(g, name)
            sq = torch.stack([g.float().square().sum() / repl[name]
                              for name, g in g_loc.items()]).sum()
            dist.all_reduce(sq)
            g_loc, gnorm = clip_by_global_norm(g_loc, clip_norm,
                                               norm=torch.sqrt(sq))
            lr = lr_fn(state.opt.step)
            p_loc = {name: shard(p.detach(), name)
                     for name, p in params.items()}
            opt_loc = AdamWState(
                step=state.opt.step,
                mu={n: t.to_local() for n, t in state.opt.mu.items()},
                nu={n: t.to_local() for n, t in state.opt.nu.items()})
            p_loc, opt_loc = adamw_update(g_loc, opt_loc, p_loc, lr)

            def placed(local, name):
                return DTensor.from_local(local, mesh, m_sh[name].placements)

            new_params = {n: placed(t, n).redistribute(mesh,
                                                       p_sh[n].placements)
                          for n, t in p_loc.items()}
            opt = AdamWState(step=opt_loc.step,
                             mu={n: placed(t, n) for n, t in opt_loc.mu.items()},
                             nu={n: placed(t, n) for n, t in opt_loc.nu.items()})
            out = {"loss": data_mean(loss.detach().clone()), "grad_norm": gnorm,
                   "lr": lr, **{k: data_mean(v.detach().clone())
                               for k, v in metrics.items()}}
        return TrainState(params=new_params, opt=opt, ef=None), out

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
