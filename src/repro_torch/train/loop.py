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
a batch split over 'data'), on a `DeviceMesh` with DTensor state;
`make_sharded_prefill_step` and `make_sharded_serve_step` are the twins
of its jitted `make_prefill_step` and `make_serve_step` under the
shardings of `repro_torch.launch.specs` (the production dry run's).

In every sharded step the batch's rows are split over the data axes,
pod-major (a batch entry may be a plain global tensor, the same on every
rank, or a DTensor). The serve and prefill steps of every family are
tensor parallel, as XLA partitions the reference's. The serve step's
`Model.decode_step` runs on the rank's own shards of the parameters
(standing in for the model's own) and of every cache leaf, with the
products, the norms, the embedding, the unembedding, the decode
attention, the recurrent layers and the experts' outputs exchanging
activations over 'model' (`repro_torch.distributed.tensor_parallel`); no
parameter and no cache or state row moves. The prefill step's
`Model.last_logits` runs on the rank's own shards of the parameters
under the reference's layout constraints, with the residual stream on
the rank's positions of the sequence (an encoder's on the rank's
frames), each attention, MLP, MoE, SSD or RG-LRU sub-block gathering its
input over the sequence and reduce-scattering its output back (or, where
'model' does not divide the q heads, attending from the rank's positions
over the gathered K/V), the weights staying where they are but for the
few that every position needs whole (`tensor_parallel`'s prefill rule).
The train step of the dense, VLM and moe families
(`TENSOR_PARALLEL_TRAIN`) runs `Model.loss` forward and backward under
that same rule on the rank's own shards (gathered over the data axes
first where FSDP storage splits them there), with a vocab-parallel head
and cross-entropy (the moe family's experts expert parallel, its
auxiliary loss the global batch's, DeepSeek-V3's multi-token-prediction
depth on the rank's positions too); every collective's backward is its
adjoint, and each gradient leaves as the rank's shard of the ZeRO layout
(`sharded_gradients`). The train step of the ssm, hybrid and encdec
families still gathers each parameter DTensor to a full tensor, writes
it into the model's own parameter, and runs the unchanged `Model.loss`
on plain tensors, the 'model' ranks computing redundantly. Each sharded
step's ``reads_model_params`` says which of the two it is: True where it
gathers into the model's own parameters, False where it never reads
them (every serve and prefill step, and the dense, VLM and moe train
steps; the dry run counts the model's parameters among a rank's bytes
only when True), and ``model_call`` names the model's method it runs.

Where the data axes split the batch's rows, a moe layer routes on the
global batch's row grid in every sharded step, as the reference's
jitted step routes the whole batch (`repro_torch.models.moe`).
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch

from repro_torch.distributed import tensor_parallel as tp
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
    buffers each step gathers into, where the step gathers (the families
    not in `TENSOR_PARALLEL_TRAIN`)."""
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


def _rows_layout(mesh, dim: int, whole: bool) -> list:
    """Placements that split a tensor's dim ``dim`` over the data axes
    (pod-major), or replicate it when ``whole``, and replicate it over
    every other axis."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(dim) if name in ("pod", "data") and not whole
            else Replicate() for name in mesh.mesh_dim_names]


def _local_rows(v, mesh, idx: int, rows: int, whole: bool) -> torch.Tensor:
    """This rank's rows of a batch-leading tensor: a plain global tensor
    is sliced, a DTensor redistributed to rows over the data axes; with
    ``whole`` every row."""
    from torch.distributed.tensor import DTensor
    if isinstance(v, DTensor):
        return v.redistribute(mesh, _rows_layout(mesh, 0, whole)
                              ).to_local()
    return v if whole else v[idx * rows:(idx + 1) * rows]


def _placed_rows(local: torch.Tensor, mesh, n_rows: int, whole: bool):
    """A DTensor of ``n_rows`` global rows from this rank's ``local``
    rows (split over the data axes, or every row when ``whole``)."""
    from torch.distributed.tensor import DTensor
    shape = (n_rows, *local.shape[1:])
    stride = [1]                 # row-major, without allocating the shape
    for n in reversed(shape[1:]):
        stride.insert(0, stride[0] * n)
    return DTensor.from_local(local, mesh,
                              _rows_layout(mesh, 0, whole),
                              shape=torch.Size(shape), stride=tuple(stride))


def _load_params(params: dict[str, torch.Tensor], placed: dict) -> None:
    """Gather each DTensor of ``placed`` into the model's own parameter."""
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(placed[name].full_tensor())


#: The families whose sharded train step is tensor parallel; the others
#: gather every parameter into the model's own (`sharded_gradients`).
TENSOR_PARALLEL_TRAIN = ("dense", "vlm", "moe")


def _check_routing(model: Model, tokens: int, n_data: int) -> None:
    """ValueError, before any collective, where a moe model's global row
    grid over ``tokens`` tokens on each of ``n_data`` data ranks would
    put a routing row across two of them (`moe.routing_grid`)."""
    if model.cfg.family == "moe":
        from repro_torch.models.moe import routing_grid
        routing_grid(tokens, n_data)


def _summed(g: torch.Tensor, placed, target) -> torch.Tensor:
    """This rank's shard, in ``target``'s placements, of the gradient
    whose rank term ``g`` is that of the local tensor of ``placed`` (a
    parameter DTensor): summed over each mesh dim that replicates
    ``placed`` (a `Partial` there), by the reduce-scatter (or, where
    ``target`` replicates the dim too, the all-reduce) of one
    redistribution; along a dim that splits ``placed`` the collectives'
    adjoints have summed it already."""
    from torch.distributed.tensor import DTensor, Partial
    mesh = placed.device_mesh
    return DTensor.from_local(
        g, mesh, [pl if pl.is_shard() else Partial()
                  for pl in placed.placements],
        shape=placed.shape, stride=placed.stride()
    ).redistribute(mesh, target.placements).to_local()


def sharded_gradients(model: Model, mesh, placed: dict, batch: dict,
                      m_sh: dict):
    """(loss, metrics, grads) of one step of `make_sharded_train_step`
    before clipping: ``loss`` and ``metrics`` this rank's, the mean over
    its rows of the batch (split over the data axes, pod-major), and
    ``grads`` the gradient of the global batch's mean loss, each
    parameter's as this rank's shard in ``m_sh``'s placements (the
    optimizer layout, `param_shardings(..., zero=True)`), by name. ``placed`` holds the parameters' DTensors by name, ``batch``
    the global batch (`make_sharded_train_step`'s); rows that the data
    axes do not divide raise ValueError before any collective, and so
    does a moe model's batch whose global routing grid the data ranks do
    not divide (`moe.routing_grid`).

    For `TENSOR_PARALLEL_TRAIN`'s families the step is tensor parallel:
    each parameter's local shard (gathered over the data axes where FSDP
    storage splits it there, by the differentiable all-gather) becomes a
    leaf that stands in for the model's own parameter
    (`_parameters_replaced`: the model's parameters are never read and
    may live on the meta device), and `Model.loss` runs under the prefill
    rule's context (`tensor_parallel.TensorParallel` with the sequence's
    length, a VLM's patches included, and the data axes, so that a MoE
    layer routes on the global batch's grid and forms the global batch's
    auxiliary loss): the rank's positions, heads, ff columns, experts
    and vocabulary rows. The backward is seeded with the rank's
    term of the global loss, its rows' mean over (data ranks x 'model'
    ranks), and every collective's backward is its adjoint
    (`tensor_parallel`'s loss convention); each gradient is then summed
    over the mesh dims that replicate its parameter by one
    redistribution to the optimizer layout (`_summed`), and no full
    gradient is formed.

    For the other families (ssm, hybrid and encdec, by ``cfg.family``)
    each parameter is gathered whole into the model's own, the unchanged `Model.loss` runs on every 'model' rank
    alike, and each gradient is all-reduced over the data axes, divided
    by their size and cut to the optimizer layout's shard."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    idx, n_data, data_groups = _data_rank(mesh)
    n_rows = next(iter(batch.values())).shape[0]
    if n_rows % n_data:
        raise ValueError(f"make_sharded_train_step: a batch of {n_rows} "
                         f"rows on {n_data} data ranks")
    local = {k: _local_rows(v, mesh, idx, n_rows // n_data, False)
             for k, v in batch.items()}
    if model.cfg.family in TENSOR_PARALLEL_TRAIN:
        seq = local["tokens"].shape[1] - 1
        if model.cfg.family == "vlm":
            seq += local["frontend"].shape[1]
        _check_routing(model, n_rows // n_data * seq, n_data)
        leaves: dict[str, torch.Tensor] = {}
        params, shards = _local_params(placed, mesh, leaves)
        ctx = tp.TensorParallel(mesh, shards, {}, seq_len=seq,
                                data=(idx, n_data, data_groups), train=True)
        with tp.active(ctx), _parameters_replaced(model, params):
            loss, metrics = model.loss(local)
        grads = torch.autograd.grad(loss / (n_data * ctx.size),
                                    list(leaves.values()), allow_unused=True)
        with torch.no_grad():
            g_loc = {name: _summed(torch.zeros_like(leaf) if g is None else g,
                                   placed[name], m_sh[name])
                     for (name, leaf), g in zip(leaves.items(), grads)}
    else:
        params = dict(model.named_parameters())
        _load_params(params, placed)
        loss, metrics = model.loss(local)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        with torch.no_grad():
            g_loc = {}
            for (name, p), g in zip(params.items(), grads):
                if g is None:
                    g = torch.zeros_like(p)
                else:
                    for group in data_groups:
                        dist.all_reduce(g, group=group)
                    g = g / n_data
                g_loc[name] = distribute_tensor(
                    g, mesh, m_sh[name].placements,
                    src_data_rank=None).to_local().clone()
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            g_loc)


def make_sharded_train_step(model: Model, mesh, base_lr: float = 3e-4,
                            warmup: int = 100, total_steps: int = 10_000,
                            clip_norm: float = 1.0):
    """Returns train_step(state, batch) -> (state, metrics) over a state
    from `init_sharded_train_state` on ``mesh`` (a `DeviceMesh` over the
    default process group, with a 'data' axis and optionally 'pod' and
    'model'). Every rank passes the same global ``batch`` (its entries
    plain tensors, or DTensors), whose rows the data axes must divide
    (ValueError otherwise: no row is dropped);
    metrics as `make_train_step`'s with ``accum_steps`` 1, averaged over
    'data'. The layouts are `param_shardings`' under the active
    `set_fsdp` mode.

    One step: the gradients of `sharded_gradients`, in the ``zero=True``
    layout's shards (tensor parallel for the dense, VLM and moe
    families, `TENSOR_PARALLEL_TRAIN`; for the others gathered into the model's
    own parameters, the 'model' ranks computing redundantly); the global
    norm over those shards (each shard's sum of squares divided by the
    ranks that replicate it, summed over every rank), so it is the
    one-process clip's norm up to the order of the sums; then AdamW
    (`adamw_update`, the one-process arithmetic) updates each rank's
    shard of the ``zero=True`` layout, and the new parameters are
    redistributed to the parameters' layout.

    The model runs on plain tensors, not DTensors: DTensor has no
    sharding rule for the port's custom autograd functions or its
    kernels' wrappers. ``reads_model_params`` is False for the tensor
    parallel families (the model's parameters may live on the meta
    device) and True for the others. No gradient accumulation or
    compression here."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    lr_fn = cosine_schedule(base_lr, warmup, total_steps)
    p_sh = param_shardings(model, mesh)
    m_sh = param_shardings(model, mesh, zero=True)
    sizes = mesh.mesh.shape
    repl = {n: math.prod(s for s, pl in zip(sizes, sh.placements)
                         if pl.is_replicate()) for n, sh in m_sh.items()}
    _, n_data, data_groups = _data_rank(mesh)

    def data_mean(t: torch.Tensor) -> torch.Tensor:
        for g in data_groups:
            dist.all_reduce(t, group=g)
        return t / n_data

    def train_step(state: TrainState, batch: dict):
        loss, metrics, g_loc = sharded_gradients(model, mesh, state.params,
                                                 batch, m_sh)
        with torch.no_grad():
            sq = torch.stack([g.float().square().sum() / repl[name]
                              for name, g in g_loc.items()]).sum()
            dist.all_reduce(sq)
            g_loc, gnorm = clip_by_global_norm(g_loc, clip_norm,
                                               norm=torch.sqrt(sq))
            lr = lr_fn(state.opt.step)
            p_loc = {name: t.redistribute(mesh, m_sh[name].placements
                                          ).to_local().clone()
                     for name, t in state.params.items()}
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
            out = {"loss": data_mean(loss.clone()), "grad_norm": gnorm,
                   "lr": lr, **{k: data_mean(v.clone())
                               for k, v in metrics.items()}}
        return TrainState(params=new_params, opt=opt, ef=None), out

    tensor_parallel = model.cfg.family in TENSOR_PARALLEL_TRAIN
    train_step.reads_model_params = not tensor_parallel
    train_step.model_call = "loss"
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


def make_sharded_serve_step(model: Model, mesh):
    """Returns serve_step(params, cache, tokens (B, 1)) -> (cache,
    logits), the twin of the reference's jitted `make_serve_step` on
    ``mesh`` (a `DeviceMesh` with a 'data' axis and optionally 'pod' and
    'model'): ``params`` DTensors by name (`param_shardings`' layout),
    ``cache`` a nested dict of DTensors (`cache_shardings`' layout),
    ``tokens`` a DTensor or a plain global tensor. ``logits`` is a (B,
    padded vocab) float32 DTensor, rows over the data axes. The cache is
    updated in place. Where the data axes do not divide the rows (batch
    1), every data rank computes every row, as the reference's batch spec
    falls back to replication.

    The step is tensor parallel for every family, as
    `repro_torch.distributed.tensor_parallel` describes: the dense and
    VLM layers' products, norms, embedding and attention; a moe layer
    expert parallel (every 'model' rank routes its rows alike and runs
    its own experts, whose outputs are summed over 'model'); MLA on its
    heads of ``w_ukv`` and its positions of ``ckv``/``kpe``; the SSM and
    RG-LRU layers on the rank's heads and channels of their state; the
    hybrid's ring and the encoder-decoder's self-attention cache and
    memory on their shards. Where the data axes split the rows, a moe
    layer routes on the global batch's row grid, as the reference's
    jitted step does (ValueError, before any collective, where a grid row
    would straddle two data ranks)."""
    idx, n_data, data_groups = _data_rank(mesh)

    @torch.no_grad()
    def serve_step(placed: dict, cache: dict, tokens):
        """One step on this rank's shards. Each parameter's local shard
        (gathered over the data axes first where FSDP storage splits it
        there; serving never does) stands in for the model's own
        parameter (`_parameters_replaced`), so the model's parameters
        are never read and may live on the meta device. The context
        (`TensorParallel.of_cache`) holds a `KVShard` for each attention
        cache and a `StateShard` for each recurrent state leaf; every
        local shard is updated in place: this rank's rows (every row
        where the data axes do not divide them), its KV heads or its
        positions, its channels or heads. ``length``, replicated,
        advances on this rank's rows and is all-gathered back over the
        data axes."""
        n_rows = tokens.shape[0]
        whole = n_rows % n_data != 0
        rows = n_rows // n_data
        split = None if whole else (idx, n_data, data_groups)
        _check_routing(model, rows, 1 if whole else n_data)
        tok = _local_rows(tokens, mesh, idx, rows, whole)
        params, shards = _local_params(placed, mesh)
        length = cache["length"].to_local()
        mine = length if whole else length[idx * rows:(idx + 1) * rows]
        local = {k: ({n: leaf.to_local() for n, leaf in v.items()}
                     if isinstance(v, dict) else v.to_local())
                 for k, v in cache.items() if k != "length"}
        ctx = tp.TensorParallel.of_cache(mesh, shards, cache, data=split)
        with tp.active(ctx), _parameters_replaced(model, params):
            logits = model.decode_step(tok, {"length": mine, **local})
        if not whole:
            length.copy_(_placed_rows(mine, mesh, n_rows, False).redistribute(
                mesh, cache["length"].placements).to_local())
        return cache, _placed_rows(logits, mesh, n_rows, whole)

    serve_step.reads_model_params = False
    serve_step.model_call = "decode_step"
    return serve_step


def _local_params(placed: dict, mesh, leaves: dict | None = None
                  ) -> tuple[dict, dict]:
    """This rank's shard of each parameter DTensor of ``placed`` (by
    name), gathered over the data axes first where FSDP storage splits
    it there, and the dim 'model' splits of each that is a 'model' shard
    (by tensor identity: `tensor_parallel.TensorParallel`'s
    ``shards``). Given ``leaves`` (a dict), each local shard is first
    made a leaf that requires its gradient and stored there by name, so
    that the gather's adjoint (`tensor_parallel.all_gather`) brings each
    leaf its gradient summed over the data axes."""
    names = mesh.mesh_dim_names
    on_data = [name in ("pod", "data") for name in names]
    m_dim = names.index("model") if "model" in names else None
    params, shards = {}, {}
    for name, t in placed.items():
        local = t.to_local()
        if leaves is not None:
            local = leaves[name] = local.detach().requires_grad_(True)
        for dim in sorted({pl.dim for d, pl in zip(on_data, t.placements)
                           if d and pl.is_shard()}):
            local = tp.all_gather(local, dim, [
                mesh.get_group(i) for i, (d, pl)
                in enumerate(zip(on_data, t.placements))
                if d and pl.is_shard(dim)])
        params[name] = local
        pl = None if m_dim is None else t.placements[m_dim]
        if pl is not None and pl.is_shard():
            shards[id(local)] = pl.dim
    return params, shards


@contextlib.contextmanager
def _parameters_replaced(model: Model, tensors: dict[str, torch.Tensor]):
    """``model``'s parameters replaced by ``tensors`` (plain tensors, by
    parameter name) while the block runs, as `torch.func.functional_call`
    replaces them, but around a method call rather than a call of the
    module (whose hooks, the dry run's MemTracker among them, would take
    the tensors for trainable parameters)."""
    saved = []
    try:
        for name, t in tensors.items():
            owner, _, leaf = name.rpartition(".")
            mod = model.get_submodule(owner)
            saved.append((mod, leaf, mod._parameters[leaf]))
            mod._parameters[leaf] = t
        yield model
    finally:
        for mod, leaf, p in reversed(saved):
            mod._parameters[leaf] = p


def make_sharded_prefill_step(model: Model, mesh):
    """Returns prefill_step(params, batch) -> the last position's logits
    (B, padded vocab) float32 as a DTensor, rows over the data axes: the
    twin of the reference's jitted `make_prefill_step` on ``mesh``, with
    ``params`` as `make_sharded_serve_step`'s and ``batch`` holding
    ``tokens`` (B, S) and, for encdec and vlm, ``frontend``, each a
    DTensor or a plain global tensor. The model runs on this rank's rows
    (every row where the data axes do not divide them).

    The step is tensor parallel: each parameter's local shard stands in
    for the model's own (`_parameters_replaced`, so the model's
    parameters are never read and may live on the meta device), and
    `Model.last_logits` runs under a prefill context
    (`tensor_parallel.TensorParallel` with the sequence's length, the
    VLM's patches included): the residual stream on the rank's positions
    of the sequence, padded at its end to a multiple of 'model' (an
    encoder's on the rank's frames, under a context of their own); each
    sub-block on the gathered sequence, the rank's heads, ff columns,
    experts or recurrent channels, and reduce-scattered back (an
    attention whose q heads 'model' does not divide on the rank's
    positions, over the gathered K/V); the final norm and the head on
    the last real position alone. Where the data axes split the rows, a
    moe layer routes on the global batch's row grid, as the reference's
    jitted step does (ValueError, before any collective, where a grid row
    would straddle two data ranks)."""
    idx, n_data, data_groups = _data_rank(mesh)

    def local_rows(batch: dict):
        n_rows = batch["tokens"].shape[0]
        whole = n_rows % n_data != 0
        return n_rows, whole, {
            k: _local_rows(v, mesh, idx, n_rows // n_data, whole)
            for k, v in batch.items()}

    @torch.no_grad()
    def prefill_step(placed: dict, batch: dict):
        n_rows, whole, local = local_rows(batch)
        tokens, frontend = local["tokens"], local.get("frontend")
        seq = tokens.shape[1]
        if model.cfg.family == "vlm":
            seq += frontend.shape[1]
        split = None if whole else (idx, n_data, data_groups)
        _check_routing(model, tokens.shape[0] * seq, 1 if whole else n_data)
        params, shards = _local_params(placed, mesh)
        ctx = tp.TensorParallel(mesh, shards, {}, seq_len=seq, data=split)
        with tp.active(ctx), _parameters_replaced(model, params):
            logits = model.last_logits(tokens, frontend=frontend)
        return _placed_rows(logits, mesh, n_rows, whole)

    prefill_step.reads_model_params = False
    prefill_step.model_call = "last_logits"
    return prefill_step
