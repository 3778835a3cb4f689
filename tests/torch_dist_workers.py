"""Rank bodies of tests/test_torch_distributed.py and
tests/test_torch_moe_train.py, spawned as gloo process groups on the CPU,
and the census of a full config's sharded step that both run in a
subprocess (`full_census`). They import only torch, numpy and
`repro_torch`, so a rank does not load JAX; each writes what it computed
under the output directory, and the test compares it in the parent
process."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

PSUM_SHAPES = ((2, 16), (3, 4), (3, 5), ())
GATHER_SHAPES = ((3, 5), (2,), ())
PIPE = dict(S=4, M=6, B=2, D=8)
TRAIN = dict(arch="granite-3-2b", seed=3, batch=(8, 33), steps=3,
             base_lr=1e-2, warmup=1, total_steps=10)


def spawn(fn, world: int, out_dir: str, *args) -> None:
    """Run ``fn(rank, world, init_file, out_dir, *args)`` on ``world``
    gloo ranks (a file:// rendezvous in ``out_dir``)."""
    import torch.multiprocessing as mp
    init = os.path.join(out_dir, "rendezvous")
    mp.spawn(fn, args=(world, init, out_dir, *args), nprocs=world,
             join=True)


def _init(rank: int, world: int, init: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)


def _psum_input(shape, rank: int) -> torch.Tensor:
    n = int(np.prod(shape)) if shape else 1
    return torch.arange(n, dtype=torch.float32).reshape(shape) * (rank + 1) \
        + rank


def collectives_worker(rank: int, world: int, init: str, out_dir: str):
    """(c) hierarchical_psum and a flat all_reduce on a (pod 2, data 2)
    mesh, the reference test's x = arange(8 * 16) split over both axes
    and a few shapes that scatter on dim 1 or fall back; (d)
    ring_all_gather and all_gather_into_tensor along each axis; constrain
    on DTensors over that mesh; (e)
    pipeline_forward over a 1-D mesh of 4 stages, with plain and with
    DTensor stage parameters."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed import sharding
    from repro_torch.distributed.collectives import (hierarchical_psum,
                                                     ring_all_gather)
    from repro_torch.distributed.pipeline import pipeline_forward
    _init(rank, world, init)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
    out = {"coord": mesh.get_coordinate()}
    x = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    local = x[2 * rank:2 * rank + 2]
    flat = local.clone()
    dist.all_reduce(flat)
    out["psum_ref"] = (hierarchical_psum(local, mesh, "data", "pod"), flat)
    for shape in PSUM_SHAPES:
        v = _psum_input(shape, rank)
        flat = v.clone()
        dist.all_reduce(flat)
        out[("psum", shape)] = (hierarchical_psum(v, mesh, "data", "pod"),
                                flat, v)
    for axis in ("pod", "data"):
        g = mesh.get_group(axis)
        n = dist.get_world_size(g)
        for shape in GATHER_SHAPES:
            v = _psum_input(shape, rank)
            want = v.new_empty((n * (v.shape[0] if v.dim() else 1),
                                *v.shape[1:]))
            dist.all_gather_into_tensor(want, v.reshape(-1, *v.shape[1:])
                                        if v.dim() else v.reshape(1),
                                        group=g)
            out[("gather", axis, shape)] = (ring_all_gather(v, mesh, axis),
                                            want)
    sharding.set_mesh(mesh)
    for shape in ((8, 16), (3, 16)):
        dt = distribute_tensor(torch.arange(shape[0] * shape[1],
                                            dtype=torch.float32
                                            ).reshape(shape),
                               mesh, [Replicate(), Replicate()])
        c = sharding.constrain(dt, ("data", None))
        out[("constrain", shape)] = ([str(p) for p in c.placements],
                                     c.full_tensor(), dt.full_tensor())
    sharding.clear_mesh()
    pipe = init_device_mesh("cpu", (4,), mesh_dim_names=("pod",))
    rng = np.random.default_rng(0)
    p = PIPE
    w = torch.from_numpy((rng.standard_normal((p["S"], p["D"], p["D"]))
                          * 0.3).astype(np.float32))
    micro = torch.from_numpy(rng.standard_normal(
        (p["M"], p["B"], p["D"])).astype(np.float32))

    def stage(params, v):
        return torch.tanh(v @ params["w"])

    out["pipe"] = pipeline_forward(pipe, stage, {"w": w}, micro, axis="pod")
    w_dt = distribute_tensor(w, pipe, [Shard(0)])
    out["pipe_dtensor"] = pipeline_forward(pipe, stage, {"w": w_dt}, micro,
                                           axis="pod")
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def train_config():
    from repro_torch.configs import get_config
    return get_config(TRAIN["arch"], "smoke").replace(dtype=torch.float32)


def train_model():
    """The sharded test's model: TRAIN's arch at smoke width, float32,
    weights drawn from TRAIN's seed, on the CPU."""
    from repro_torch.models import Model
    return Model(train_config(), "cpu").init(TRAIN["seed"])


def train_batches():
    """TRAIN's global batches, one a step, from numpy."""
    rng = np.random.default_rng(TRAIN["seed"])
    vocab = train_config().vocab_size
    return [{"tokens": torch.from_numpy(rng.integers(
        0, vocab, TRAIN["batch"]).astype(np.int32))}
        for _ in range(TRAIN["steps"])]


def sharded_train_worker(rank: int, world: int, init: str, out_dir: str,
                         shape: tuple):
    """(f) make_sharded_train_step on a (data, model) mesh of ``shape``:
    TRAIN's steps, then a batch the data axes do not divide; rank 0
    writes the metrics, the gathered parameters and moments, the census of
    placements and the refusal's message."""
    from repro_torch.distributed import sharding
    from repro_torch.train.loop import (init_sharded_train_state,
                                        make_sharded_train_step)
    _init(rank, world, init)
    mesh = sharding.device_mesh(sharding.MeshSpec(("data", "model"), shape),
                                "cpu")
    sharding.set_mesh(mesh)
    model = train_model()
    state = init_sharded_train_state(model, mesh, seed=None)
    step = make_sharded_train_step(
        model, mesh, base_lr=TRAIN["base_lr"], warmup=TRAIN["warmup"],
        total_steps=TRAIN["total_steps"])
    metrics = []
    for batch in train_batches():
        state, met = step(state, batch)
        metrics.append({k: float(v) for k, v in met.items()})
    try:                       # 6 rows on 4 data ranks: refused, not cut
        step(state, {"tokens": train_batches()[0]["tokens"][:6]})
        refused = None
    except ValueError as e:
        refused = str(e)
    full = {tree: {n: t.full_tensor() for n, t in src.items()}
            for tree, src in (("params", state.params),
                              ("mu", state.opt.mu), ("nu", state.opt.nu))}
    placements = {n: [str(p) for p in t.placements]
                  for n, t in state.opt.mu.items()}
    if rank == 0:
        torch.save({"metrics": metrics, "step": int(state.opt.step),
                    "placements": placements, "refused": refused, **full},
                   os.path.join(out_dir, "train.pt"))
    sharding.clear_mesh()
    dist.destroy_process_group()


SERVE = dict(arch="qwen3-0.6b", seed=5, batch=4, odd_batch=3, prompt=6,
             max_len=16, steps=2)
# SERVE's arch widened until every `param_pspec` rule fires on a 'model'
# axis of 2 or 4: wq, wo, the MLP and the embedding split, wk and wv (32
# columns) replicated by the divisibility fallback
SERVE_WIDE = dict(d_model=128, n_heads=8, n_kv_heads=2, d_head=16, d_ff=256,
                  vocab_size=512, n_layers=2)
# the moe family's smokes widened likewise (their `serve_config(True,
# arch)`): dbrx's 4 experts split over 'model' (expert parallel), its
# router (d, 4) replicated, its 2 KV heads over 'model' or, on 4 'model'
# ranks, the sequence; deepseek's 1 dense + 2 MLA/MoE layers with 128
# experts, so that the fan-out rule splits its router's columns too, and
# every MLA projection, q_norm and kv_norm (128 features) over 'model',
# its 8 dense KV heads over 'model' and its latent caches' sequence
MOE_WIDE = {
    "dbrx-132b": dict(d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
                      d_ff=256, d_ff_expert=256),
    "deepseek-v3-671b": dict(d_model=128, n_heads=8, n_kv_heads=8,
                             d_head=16, d_ff=256, n_experts=128,
                             d_ff_expert=32, q_lora_rank=128,
                             kv_lora_rank=128, qk_nope_dim=16,
                             qk_rope_dim=8, v_head_dim=16)}


# the SSM, hybrid and encoder-decoder smokes widened likewise (their
# `serve_config(True, arch)`), so that every rule of their layouts fires
# on a 'model' axis of 2 or 4: mamba2's in_proj (128, 560) split across
# the boundaries of z, xBC and dt, conv_w / conv_b / the conv state over
# their 288 channels, out_norm (256) and out_proj, the ssm state's 16
# heads (a_log, dt_bias, d_skip (16,) replicated); recurrentgemma's
# w_x, w_gate, w_r, w_i, w_out, conv_w, conv_b and lam over its 128
# channels, with 2 super-blocks and a recurrent tail (7 layers) so that
# conv / h and tail_conv / tail_h all split, its attention's wq, wk, wv
# and wo (d_head 128, 1 KV head) too, and its ring's 16 positions over
# 'model'; whisper's 2 KV heads over 'model' on (2, 2) and, on (2, 4),
# the sequence of both its self-attention cache and its memory (the
# log-sum-exp combine), every projection of d_model 128 split
FAMILY_WIDE = {
    "mamba2-2.7b": dict(d_model=128, ssm_headdim=16),
    "recurrentgemma-2b": dict(d_model=128, lru_width=128, n_layers=7,
                              n_heads=2, d_head=128, d_ff=256),
    "whisper-base": dict(d_model=128, n_heads=2, n_kv_heads=2, d_head=64,
                         d_ff=256)}
WIDE = {**MOE_WIDE, **FAMILY_WIDE}
# the tensor-parallel prefill's cases, (arch, widened): each arch at smoke
# width as it is (there only the embedding splits over 'model'), and
# widened so that every rule of the prefill fires on a 'model' axis of 2
# or 4: qwen3's and internvl2's wq, wo and MLP split, and wk and wv (2 KV
# heads of 64 columns) too, so that on 4 ranks each KV head's columns lie
# on two ranks, which the all-to-all brings together for the two q heads
# that read it; dbrx's and deepseek's as MOE_WIDE (experts, router, every
# MLA projection and norm); mamba2's, recurrentgemma's and whisper's as
# FAMILY_WIDE (in_proj split across the boundaries of z, xBC and dt; the
# RG-LRU's channels; every projection), where recurrentgemma's and
# whisper's 2 heads take the heads rule on 2 'model' ranks and the
# context rule (the rank's own query positions) on 4. The prompts'
# lengths (internvl2's 8 patches before them) are ones that 'model' does
# not divide: 6 and 14 on 4 ranks, 7 and 15 on 2 and 4, so the sequence
# is padded at its end; the SSM, hybrid and encoder-decoder families
# also take 71 tokens, which span 3 of the smoke's 32-position SSD chunks
# and 4 of the hybrid's 16-position windows, and whisper's encoder 27 or
# 32 frames (PREFILL_FRAMES: 27 on 2 and 4 ranks pads the frames).
PREFILL_WIDE = {
    "qwen3-0.6b": dict(d_model=128, n_heads=4, n_kv_heads=2, d_head=64,
                       d_ff=256),
    "internvl2-76b": dict(d_model=128, n_heads=4, n_kv_heads=2, d_head=64,
                          d_ff=256),
    **MOE_WIDE, **FAMILY_WIDE}
PREFILL_CASES = (("qwen3-0.6b", False), ("qwen3-0.6b", True),
                 ("internvl2-76b", False), ("internvl2-76b", True),
                 ("dbrx-132b", True), ("deepseek-v3-671b", True),
                 ("mamba2-2.7b", False), ("mamba2-2.7b", True),
                 ("recurrentgemma-2b", False), ("recurrentgemma-2b", True),
                 ("whisper-base", False), ("whisper-base", True))
PREFILL_LENGTHS = (6, 7)
# the SSM, hybrid and encoder-decoder families' lengths
PREFILL_FAMILY_LENGTHS = (6, 71)
# whisper's frames by prompt length
PREFILL_FRAMES = {6: 27, 71: 32}


def prefill_lengths(arch: str) -> tuple[int, ...]:
    """The prompt lengths of a PREFILL_CASES arch."""
    return PREFILL_FAMILY_LENGTHS if arch in FAMILY_WIDE else PREFILL_LENGTHS


def serve_config(wide: bool = False, arch: str | None = None):
    """SERVE's arch (or ``arch``) at smoke width (``wide``: SERVE_WIDE's,
    or a WIDE arch's own), float32."""
    from repro_torch.configs import get_config
    cfg = get_config(arch or SERVE["arch"], "smoke").replace(
        dtype=torch.float32)
    if not wide:
        return cfg
    return cfg.replace(**(WIDE[arch] if arch else SERVE_WIDE))


def serve_model(weights: str, wide: bool = False, arch: str | None = None):
    """The sharded serving tests' model (`serve_config`) on the CPU, its
    state dict read from ``weights`` (the reference's weights carried
    across by the test)."""
    from repro_torch.models import Model
    model = Model(serve_config(wide, arch), "cpu")
    model.load_state_dict(torch.load(weights))
    return model


def serve_tokens(rows: int, arch: str | None = None) -> torch.Tensor:
    """(rows, prompt) int32 tokens from numpy, seeded by SERVE and rows."""
    rng = np.random.default_rng(SERVE["seed"] + rows)
    vocab = serve_config(arch=arch).vocab_size
    return torch.from_numpy(rng.integers(0, vocab, (rows, SERVE["prompt"])
                                         ).astype(np.int32))


def serve_cache(model, rows: int, random: bool) -> dict:
    """``model``'s decode cache of ``rows`` rows and SERVE's max_len:
    zeros, or with ``random`` every leaf drawn from numpy (seeded by
    SERVE and rows), so that an encoder memory or a recurrent state the
    steps read is not zeros: ``length`` each row's in [0, max_len -
    steps], so that the steps attend over drawn positions that span the
    shards of a sequence split over several ranks, and for the hybrid's
    ring in [0, 3 x its positions), so that rows past the window wrap
    the ring across its shards."""
    cache = model.init_cache(rows, SERVE["max_len"])
    if random:
        rng = np.random.default_rng(SERVE["seed"] + 100 + rows)

        def fill(tree):
            for k, v in tree.items():
                if isinstance(v, dict):
                    fill(v)
                elif k != "length":
                    v.copy_(torch.from_numpy(
                        0.5 * rng.standard_normal(tuple(v.shape))))

        fill(cache)
        top = SERVE["max_len"] - SERVE["steps"] + 1
        if model.cfg.family == "hybrid":
            top = 3 * cache["kv"]["k"].shape[2]
        cache["length"].copy_(torch.from_numpy(rng.integers(0, top, rows)))
    return cache


def _serve_runs(mesh, weights: str, wide: bool, prefill: bool,
                fsdp: bool = False, rows_cases=None,
                arch: str | None = None) -> dict:
    """For each row count (SERVE's batch, whose rows 'data' splits, and
    its odd batch, which every data rank computes whole): the sharded
    prefill's last logits (plain global tokens; with ``prefill``), then
    SERVE's decode steps of `make_sharded_serve_step` from the cache of
    `serve_cache` (random where ``arch`` is given) in `cache_shardings`'
    layout (the tokens as DTensors in `batch_pspec`'s layout): each
    step's logits and every cache leaf reassembled, with the leaves'
    placements and the step's ``reads_model_params``. ``fsdp`` places
    the parameters in the FSDP layout (fan-in over 'data')."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed import sharding
    from repro_torch.train.loop import (make_sharded_prefill_step,
                                        make_sharded_serve_step)
    model = serve_model(weights, wide, arch)
    p_sh = sharding.param_shardings(model, mesh, fsdp=fsdp)
    params = {n: distribute_tensor(p.detach().clone(), mesh,
                                   p_sh[n].placements, src_data_rank=None)
              for n, p in model.named_parameters()}
    serve = make_sharded_serve_step(model, mesh)

    def placed(tree, shardings):
        return {k: placed(v, shardings[k]) if isinstance(v, dict) else
                distribute_tensor(v, mesh, shardings[k].placements,
                                  src_data_rank=None)
                for k, v in tree.items()}

    def full(tree):
        return {k: full(v) if isinstance(v, dict) else v.full_tensor()
                for k, v in tree.items()}

    def census(tree):
        return {k: census(v) if isinstance(v, dict) else
                [str(p) for p in v.placements] for k, v in tree.items()}

    out = {}
    for rows in rows_cases or (SERVE["batch"], SERVE["odd_batch"]):
        tokens = serve_tokens(rows, arch)
        res = {"reads_model_params": serve.reads_model_params}
        if prefill:
            res["prefill"] = make_sharded_prefill_step(model, mesh)(
                params, {"tokens": tokens}).full_tensor()
        cache = serve_cache(model, rows, arch is not None)
        cache = placed(cache, sharding.cache_shardings(cache, mesh))
        res["placements"] = census(cache)
        res["param_placements"] = {n: [str(p) for p in t.placements]
                                   for n, t in params.items()}
        res["logits"] = []
        for t in range(SERVE["steps"]):
            tok = tokens[:, t:t + 1]
            tok = distribute_tensor(tok, mesh, sharding.placements(
                sharding.batch_pspec(tuple(tok.shape)), mesh),
                src_data_rank=None)
            cache, logits = serve(params, cache, tok)
            res["logits"].append(logits.full_tensor())
        res["cache"] = full(cache)
        out[rows] = res
    return out


def prefill_config(arch: str, wide: bool):
    """A PREFILL_CASES case's config: ``arch`` at smoke width, widened by
    PREFILL_WIDE where ``wide``, float32."""
    from repro_torch.configs import get_config
    cfg = get_config(arch, "smoke").replace(dtype=torch.float32)
    return cfg.replace(**PREFILL_WIDE[arch]) if wide else cfg


def prefill_weights(out_dir: str, arch: str, wide: bool) -> str:
    """The file of a PREFILL_CASES case's weights (the reference's,
    carried across by the test) in ``out_dir``."""
    return os.path.join(out_dir, f"weights_prefill_{arch}_{int(wide)}.pt")


def prefill_batch(cfg, rows: int, length: int) -> dict:
    """(rows, length) int32 tokens and, for a VLM, (rows, n_patches,
    d_model) float32 patches, for an encoder-decoder (rows,
    PREFILL_FRAMES[length], d_model) float32 frames, from numpy seeded by
    SERVE, rows and length."""
    rng = np.random.default_rng(SERVE["seed"] + 1000 * rows + length)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (rows, length)).astype(np.int32))}
    frames = {"vlm": cfg.n_patches,
              "encdec": PREFILL_FRAMES.get(length)}.get(cfg.family)
    if frames:
        batch["frontend"] = torch.from_numpy(rng.standard_normal(
            (rows, frames, cfg.d_model)).astype(np.float32))
    return batch


def prefill_runs(mesh, out_dir: str) -> dict:
    """Each PREFILL_CASES case's `make_sharded_prefill_step` on ``mesh``:
    the last logits gathered, by (rows, length) for SERVE's two row
    counts (4 split over 'data'; 3, which every data rank computes whole)
    and PREFILL_LENGTHS (plain global tensors), with the step's
    ``reads_model_params`` and its parameters' placements."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed import sharding
    from repro_torch.models import Model
    from repro_torch.train.loop import make_sharded_prefill_step
    out = {}
    for arch, wide in PREFILL_CASES:
        model = Model(prefill_config(arch, wide), "cpu")
        model.load_state_dict(torch.load(prefill_weights(out_dir, arch,
                                                         wide)))
        p_sh = sharding.param_shardings(model, mesh)
        params = {n: distribute_tensor(p.detach().clone(), mesh,
                                       p_sh[n].placements, src_data_rank=None)
                  for n, p in model.named_parameters()}
        step = make_sharded_prefill_step(model, mesh)
        logits = {(rows, length): step(params, prefill_batch(
            model.cfg, rows, length)).full_tensor()
            for rows in (SERVE["batch"], SERVE["odd_batch"])
            for length in prefill_lengths(arch)}
        out[arch, wide] = {
            "logits": logits, "reads_model_params": step.reads_model_params,
            "param_placements": {n: [str(pl) for pl in t.placements]
                                 for n, t in params.items()}}
    return out


def ep_moe_run(mesh, weights: str, arch: str) -> dict:
    """`moe_block` of a MOE_WIDE arch's first MoE layer on (1, 63) tokens
    drawn near one direction (so that most choose the same experts and
    their rows overflow the capacity), expert parallel under a
    tensor-parallel context whose shards are the rank's shards of the
    layer's parameters in `param_shardings`' layout, and the one-process
    block on the same weights; with the choices the capacity drops."""
    from types import SimpleNamespace

    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed import sharding
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models.moe import moe_block, top_k
    model = serve_model(weights, True, arch)
    cfg, block, prefix = model.cfg, model.moe_layers[0].moe, "moe_layers.0.moe."
    p_sh = sharding.param_shardings(model, mesh)
    m_dim = mesh.mesh_dim_names.index("model")
    shards, groups = {}, {}
    for name, t in block.named_parameters():
        pl = p_sh[prefix + name].placements
        local = distribute_tensor(t.detach().clone(), mesh, pl,
                                  src_data_rank=None).to_local()
        if pl[m_dim].is_shard():
            shards[id(local)] = pl[m_dim].dim
        owner, _, leaf = name.rpartition(".")
        groups.setdefault(owner, {})[leaf] = local
    p = SimpleNamespace(**groups.pop(""), **{
        owner: SimpleNamespace(**leaves) for owner, leaves in groups.items()})
    rng = np.random.default_rng(SERVE["seed"] + 7)
    x = torch.from_numpy((rng.standard_normal(cfg.d_model) + 0.3
                          * rng.standard_normal((1, 63, cfg.d_model))
                          ).astype(np.float32))
    with tp.active(tp.TensorParallel(mesh, shards, {})):
        out, aux = moe_block(p, x, cfg)
    want, want_aux = moe_block(block, x, cfg)
    _, top_i = top_k(torch.softmax(x[0] @ block.router, dim=-1), cfg.top_k)
    counts = torch.bincount(top_i.reshape(-1), minlength=cfg.n_experts)
    n = x.shape[1] * cfg.top_k
    cap = max(int(n / cfg.n_experts * cfg.capacity_factor), 4)
    cap = ((cap + 7) // 8) * 8
    return {"out": out, "want": want, "aux": aux, "want_aux": want_aux,
            "dropped": int((counts - cap).clamp(min=0).sum()),
            "local_experts": p.experts.w_down.shape[0]}


# the tensor-parallel train step's cases, (arch, widened): the dense
# granite and qwen3 smokes (only the embedding and the MLP's w_gate / w_up
# split over 'model', every other leaf replicated there), qwen3 widened
# by PREFILL_WIDE (its 2 KV heads take the repeat-KV rule on 4 'model'
# ranks) and the internvl2 smoke with its FSDP storage (`cfg.fsdp_train`:
# the fan-in over 'data'; at smoke width only the embedding's, widened by
# PREFILL_WIDE every projection's too) and its 8 patches. Each runs 72
# tokens (71 positions, 79 with the patches, which 'model' does not
# divide); the widened ones also 65 (64 and 72, which it divides)
TRAIN_CASES = (("granite-3-2b", False), ("qwen3-0.6b", False),
               ("qwen3-0.6b", True), ("internvl2-76b", False),
               ("internvl2-76b", True))
TRAIN_RUNS = tuple((arch, wide, length) for arch, wide in TRAIN_CASES
                   for length in ((72, 65) if wide else (72,)))
TRAIN_ROWS = 4


def train_weights(out_dir: str, arch: str, wide: bool) -> str:
    """The file of a TRAIN_CASES case's weights (the reference's, carried
    across by the test) in ``out_dir``."""
    return os.path.join(out_dir, f"weights_train_{arch}_{int(wide)}.pt")


def tp_train_batches(cfg, length: int) -> list[dict]:
    """TRAIN["steps"] global batches of TRAIN_ROWS x ``length`` int32
    tokens and, for a VLM, (TRAIN_ROWS, n_patches, d_model) float32
    patches, from numpy seeded by TRAIN and ``length``."""
    rng = np.random.default_rng(TRAIN["seed"] + length)
    out = []
    for _ in range(TRAIN["steps"]):
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (TRAIN_ROWS, length)).astype(np.int32))}
        if cfg.family == "vlm":
            batch["frontend"] = torch.from_numpy(rng.standard_normal(
                (TRAIN_ROWS, cfg.n_patches, cfg.d_model)).astype(np.float32))
        out.append(batch)
    return out


def _full_state(state) -> dict:
    return {tree: {n: t.full_tensor() for n, t in src.items()}
            for tree, src in (("params", state.params), ("mu", state.opt.mu),
                              ("nu", state.opt.nu))}


def tp_train_runs(mesh, out_dir: str) -> dict:
    """Each TRAIN_RUNS run's `make_sharded_train_step` on ``mesh`` (FSDP
    storage where the config asks, `cfg.fsdp_train`), by (arch, wide,
    length): the first batch's gradients before clipping
    (`sharded_gradients`, reassembled from the optimizer layout's
    shards), then TRAIN's steps at TRAIN's schedule: each step's metrics
    and the parameters and moments after them, gathered; the step's
    ``reads_model_params`` and its parameters' placements. Then
    ("meta",): one step of PREFILL_WIDE's qwen3 whose model lives on the
    meta device, beside the same step of the model on the CPU; and
    ("reads_model_params", arch): the flag of one moe smoke's step
    (tensor parallel) and one ssm smoke's (which keeps gathering)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding
    from repro_torch.models import Model
    from repro_torch.train.loop import (init_sharded_train_state,
                                        make_sharded_train_step,
                                        sharded_gradients)
    kw = dict(base_lr=TRAIN["base_lr"], warmup=TRAIN["warmup"],
              total_steps=TRAIN["total_steps"])
    out = {}
    for arch, wide, length in TRAIN_RUNS:
        cfg = prefill_config(arch, wide)
        sharding.set_fsdp(cfg.fsdp_train)
        model = Model(cfg, "cpu")
        model.load_state_dict(torch.load(train_weights(out_dir, arch, wide)))
        state = init_sharded_train_state(model, mesh, seed=None)
        step = make_sharded_train_step(model, mesh, **kw)
        batches = tp_train_batches(cfg, length)
        m_sh = sharding.param_shardings(model, mesh, zero=True)
        _, _, grads = sharded_gradients(model, mesh, state.params, batches[0],
                                        m_sh)
        res = {"grads": {n: DTensor.from_local(
            g, mesh, m_sh[n].placements, shape=state.params[n].shape,
            stride=state.params[n].stride()).full_tensor()
            for n, g in grads.items()},
            "reads_model_params": step.reads_model_params,
            "param_placements": {n: [str(pl) for pl in t.placements]
                                 for n, t in state.params.items()},
            "metrics": []}
        for batch in batches:
            state, met = step(state, batch)
            res["metrics"].append({k: float(v) for k, v in met.items()})
        res.update(_full_state(state))
        out[arch, wide, length] = res
        sharding.set_fsdp(False)
    cfg = prefill_config("qwen3-0.6b", True)
    batch = tp_train_batches(cfg, 72)[0]
    runs = []
    for device in ("meta", "cpu"):
        model = Model(cfg, "cpu")
        model.load_state_dict(torch.load(train_weights(out_dir, "qwen3-0.6b",
                                                       True)))
        state = init_sharded_train_state(model, mesh, seed=None)
        if device == "meta":
            model = Model(cfg, "meta")
        step = make_sharded_train_step(model, mesh, **kw)
        state, met = step(state, batch)
        runs.append(({k: float(v) for k, v in met.items()},
                     _full_state(state)))
    out["meta"] = runs
    for arch in ("dbrx-132b", "mamba2-2.7b"):
        model = Model(serve_config(arch=arch), "meta")
        out["reads_model_params", arch] = make_sharded_train_step(
            model, mesh).reads_model_params
    return out


# the moe family's tensor-parallel train step's cases, (arch, variant,
# token length, capacity factor or None for the config's): the dbrx and
# deepseek smokes ("smoke": their 4 experts over 'model') and widened by
# MOE_WIDE ("wide": dbrx's 2 KV heads; deepseek's 128 experts with the
# router's columns split, MLA, 1 dense layer and the MTP head), each with
# its FSDP storage (`cfg.fsdp_train`), at 72 tokens (71 positions, which
# 'model' does not divide); the dbrx smoke also at 129 tokens with a
# capacity factor of 0.5, so that the global grid's rows (16 tokens) drop
# choices, and with 6 experts ("odd", MOE_ODD), which 4 'model' ranks do
# not divide, so that there the experts stay whole and every choice is
# 'model' rank 0's
MOE_TRAIN_RUNS = (("dbrx-132b", "smoke", 72, None),
                  ("dbrx-132b", "smoke", 129, 0.5),
                  ("dbrx-132b", "wide", 72, None),
                  ("dbrx-132b", "odd", 72, None),
                  ("deepseek-v3-671b", "smoke", 72, None),
                  ("deepseek-v3-671b", "wide", 72, None))
MOE_ODD = dict(n_experts=6)
# the routing fault's case: the dbrx smoke, float32, capacity factor 0.5,
# 4 rows of 128 tokens, whose global grid has rows of 16 tokens (a data
# rank's own, of 8, would drop fewer choices)
MOE_FAULT = dict(arch="dbrx-132b", capacity_factor=0.5, rows=4, length=128)
# the data splits of the unit case of `moe_block` alone
MOE_SPLITS = (2, 4)


def moe_variant(arch: str, variant: str) -> dict:
    """A moe case's widths over the smoke's (MOE_TRAIN_RUNS' variant)."""
    return {"smoke": {}, "wide": MOE_WIDE[arch], "odd": MOE_ODD}[variant]


def moe_train_config(arch: str, variant: str, factor: float | None = None):
    """A moe case's config: ``arch`` at smoke width, float32, its
    variant's widths, the capacity factor ``factor`` where it is
    given."""
    from repro_torch.configs import get_config
    cfg = get_config(arch, "smoke").replace(dtype=torch.float32,
                                            **moe_variant(arch, variant))
    return cfg if factor is None else cfg.replace(capacity_factor=factor)


def moe_weights(out_dir: str, arch: str, variant: str) -> str:
    """The file of a moe case's weights (the reference's, carried across
    by the test) in ``out_dir``."""
    return os.path.join(out_dir, f"weights_moe_{arch}_{variant}.pt")


def moe_train_batches(cfg, length: int) -> list[dict]:
    """TRAIN["steps"] global batches of TRAIN_ROWS x ``length`` int32
    tokens for a moe case, from numpy seeded by TRAIN, 1000 and
    ``length``: along the one-process run no router's top-k gap falls
    below 1e-6 (tests/test_torch_moe_train.py asserts it), where the
    float32 rounding of another summation order could flip a choice (at
    TRAIN's own seed the dbrx smoke's second batch of 72 tokens holds a
    gap of 4.5e-8)."""
    rng = np.random.default_rng(TRAIN["seed"] + 1000 + length)
    return [{"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_ROWS, length)).astype(np.int32))}
        for _ in range(TRAIN["steps"])]


def moe_input(cfg) -> torch.Tensor:
    """MOE_FAULT's (rows, length, d_model) float32 MoE input, from numpy
    seeded by TRAIN."""
    rng = np.random.default_rng(TRAIN["seed"] + 11)
    return torch.from_numpy(rng.standard_normal(
        (MOE_FAULT["rows"], MOE_FAULT["length"], cfg.d_model)
    ).astype(np.float32))


def _moe_unit(mesh, weights: str) -> dict:
    """`moe_block` of MOE_FAULT's first MoE layer on `moe_input`, its rows
    split over the data axes of ``mesh``, expert parallel under a
    tensor-parallel context of the train step (the data axes, the global
    auxiliary loss): the output gathered over the data axes and the
    auxiliary loss."""
    from types import SimpleNamespace

    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed import sharding
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models import Model
    from repro_torch.models.moe import moe_block
    from repro_torch.train.loop import _data_rank
    cfg = moe_train_config(MOE_FAULT["arch"], "smoke",
                           MOE_FAULT["capacity_factor"])
    model = Model(cfg, "cpu")
    model.load_state_dict(torch.load(weights))
    block, prefix = model.moe_layers[0].moe, "moe_layers.0.moe."
    p_sh = sharding.param_shardings(model, mesh)
    m_dim = mesh.mesh_dim_names.index("model")
    shards, groups = {}, {}
    for name, t in block.named_parameters():
        pl = p_sh[prefix + name].placements
        local = distribute_tensor(t.detach().clone(), mesh, pl,
                                  src_data_rank=None).to_local()
        if pl[m_dim].is_shard():
            shards[id(local)] = pl[m_dim].dim
        owner, _, leaf = name.rpartition(".")
        groups.setdefault(owner, {})[leaf] = local
    p = SimpleNamespace(**groups.pop(""), **{
        owner: SimpleNamespace(**leaves) for owner, leaves in groups.items()})
    idx, n_data, data_groups = _data_rank(mesh)
    x = moe_input(cfg)
    rows = x.shape[0] // n_data
    ctx = tp.TensorParallel(mesh, shards, {}, data=(idx, n_data, data_groups),
                            train=True)
    with tp.active(ctx):
        out, aux = moe_block(p, x[idx * rows:(idx + 1) * rows], cfg)
        out = tp.all_gather(out, 0, data_groups)
    return {"out": out, "aux": aux}


def moe_train_runs(mesh, out_dir: str) -> dict:
    """Each MOE_TRAIN_RUNS run's `make_sharded_train_step` on ``mesh``
    (FSDP storage, `cfg.fsdp_train`), by run: the first batch's gradients
    before clipping (`sharded_gradients`, reassembled), then TRAIN's
    steps: each step's metrics and the parameters and moments after
    them, gathered, the step's ``reads_model_params`` and its parameters'
    placements; then ("meta", arch): one step of each smoke whose model
    lives on the meta device beside the same step of the model on the
    CPU, with each step's ``reads_model_params``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding
    from repro_torch.models import Model
    from repro_torch.train.loop import (init_sharded_train_state,
                                        make_sharded_train_step,
                                        sharded_gradients)
    kw = dict(base_lr=TRAIN["base_lr"], warmup=TRAIN["warmup"],
              total_steps=TRAIN["total_steps"])
    out = {}

    def model_of(arch, variant, factor):
        cfg = moe_train_config(arch, variant, factor)
        model = Model(cfg, "cpu")
        model.load_state_dict(torch.load(moe_weights(out_dir, arch, variant)))
        return model, cfg

    for arch, variant, length, factor in MOE_TRAIN_RUNS:
        model, cfg = model_of(arch, variant, factor)
        sharding.set_fsdp(cfg.fsdp_train)
        state = init_sharded_train_state(model, mesh, seed=None)
        step = make_sharded_train_step(model, mesh, **kw)
        batches = moe_train_batches(cfg, length)
        m_sh = sharding.param_shardings(model, mesh, zero=True)
        _, _, grads = sharded_gradients(model, mesh, state.params, batches[0],
                                        m_sh)
        res = {"grads": {n: DTensor.from_local(
            g, mesh, m_sh[n].placements, shape=state.params[n].shape,
            stride=state.params[n].stride()).full_tensor()
            for n, g in grads.items()},
            "reads_model_params": step.reads_model_params,
            "param_placements": {n: [str(pl) for pl in t.placements]
                                 for n, t in state.params.items()},
            "metrics": []}
        for batch in batches:
            state, met = step(state, batch)
            res["metrics"].append({k: float(v) for k, v in met.items()})
        res.update(_full_state(state))
        out[arch, variant, length, factor] = res
        sharding.set_fsdp(False)
    for arch in MOE_WIDE:
        runs = []
        for device in ("meta", "cpu"):
            model, cfg = model_of(arch, "smoke", None)
            sharding.set_fsdp(cfg.fsdp_train)
            state = init_sharded_train_state(model, mesh, seed=None)
            if device == "meta":
                model = Model(cfg, "meta")
            step = make_sharded_train_step(model, mesh, **kw)
            state, met = step(state, moe_train_batches(cfg, 72)[0])
            runs.append(({k: float(v) for k, v in met.items()},
                         _full_state(state), step.reads_model_params))
            sharding.set_fsdp(False)
        out["meta", arch] = runs
    return out


def moe_train_worker(rank: int, world: int, init: str, out_dir: str,
                     shape: tuple):
    """The moe family's tensor-parallel train step on a (data, model) mesh
    of ``shape`` (`moe_train_runs`) and, on (2, 2), the routing fault's
    case: MOE_FAULT's sharded prefill step ("prefill": the last logits of
    its 4 rows of 128 tokens, split over 'data') and `moe_block` alone
    under a data split of 2 (this mesh) and of 4 (a (4, 1) mesh of the
    same ranks) ("unit", split). Rank 0 writes the results to
    moe_train{world}.pt; the weights are `moe_weights`'."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed import sharding
    from repro_torch.models import Model
    from repro_torch.train.loop import make_sharded_prefill_step
    _init(rank, world, init)
    mesh = sharding.device_mesh(sharding.MeshSpec(("data", "model"), shape),
                                "cpu")
    sharding.set_mesh(mesh)
    out = {"train": moe_train_runs(mesh, out_dir)}
    if tuple(shape) == (2, 2):
        arch = MOE_FAULT["arch"]
        weights = moe_weights(out_dir, arch, "smoke")
        model = Model(moe_train_config(arch, "smoke",
                                       MOE_FAULT["capacity_factor"]), "cpu")
        model.load_state_dict(torch.load(weights))
        p_sh = sharding.param_shardings(model, mesh)
        params = {n: distribute_tensor(p.detach().clone(), mesh,
                                       p_sh[n].placements, src_data_rank=None)
                  for n, p in model.named_parameters()}
        batch = prefill_batch(model.cfg, MOE_FAULT["rows"],
                              MOE_FAULT["length"])
        out["prefill"] = make_sharded_prefill_step(model, mesh)(
            params, batch).full_tensor()
        out["unit", 2] = _moe_unit(mesh, weights)
        sharding.clear_mesh()
        split = sharding.device_mesh(sharding.MeshSpec(("data", "model"),
                                                       (4, 1)), "cpu")
        sharding.set_mesh(split)
        out["unit", 4] = _moe_unit(split, weights)
    if rank == 0:
        torch.save(out, os.path.join(out_dir, f"moe_train{world}.pt"))
    sharding.clear_mesh()
    dist.destroy_process_group()


# rank 0's tensor-parallel step of a full config cut in depth on meta
# tensors over a fake (16, 16) group of 256 ranks (no data moves): its
# collectives (`launch.dryrun.OpCounter`), FLOPs and the parameters'
# layout, printed as JSON (`full_census`)
FULL_CENSUS_SCRIPT = """
import json, torch
from torch.distributed.tensor import distribute_tensor
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import get_config
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import Model
from repro_torch.train.loop import (init_sharded_train_state,
                                    make_sharded_prefill_step,
                                    make_sharded_serve_step,
                                    make_sharded_train_step)
dryrun._fake_group(256)
mesh = sharding.device_mesh(make_production_mesh(), "cpu")
sharding.set_mesh(mesh)
cfg = get_config({arch!r}, "full").replace(**{cut!r})
model = Model(cfg, "meta")
rows, max_len = {rows}, {max_len}
sharding.set_fsdp({train!r} and cfg.fsdp_train)

def placed(t, sh):
    return distribute_tensor(t, mesh, sh.placements, src_data_rank=None)

p_sh = sharding.param_shardings(model, mesh)
params = {{n: placed(p.detach(), p_sh[n])
          for n, p in model.named_parameters()}}
counter = dryrun.OpCounter()
flops = FlopCounterMode(display=False)
if {train!r}:
    state = init_sharded_train_state(model, mesh, seed=None)
    params = state.params
    batch = {{"tokens": torch.zeros((rows, max_len + 1), dtype=torch.int32,
                                    device="meta")}}
    if cfg.family == "vlm":
        batch["frontend"] = torch.zeros((rows, cfg.n_patches, cfg.d_model),
                                        device="meta")
    step = make_sharded_train_step(model, mesh)
    with counter, flops:
        step(state, batch)
    leaves = []
elif {prefill!r}:
    batch = {{"tokens": torch.zeros((rows, max_len), dtype=torch.int32,
                                    device="meta")}}
    frames = {{"vlm": cfg.n_patches, "encdec": cfg.src_len}}.get(cfg.family)
    if frames:
        batch["frontend"] = torch.zeros((rows, frames, cfg.d_model),
                                        device="meta")
    step = make_sharded_prefill_step(model, mesh)
    with counter, flops:
        step(params, batch)
    leaves = []
else:
    cache = model.init_cache(rows, max_len, device="meta")
    c_sh = sharding.cache_shardings(cache, mesh)
    cache = {{k: ({{n: placed(t, c_sh[k][n]) for n, t in v.items()}}
                 if isinstance(v, dict) else placed(v, c_sh[k]))
             for k, v in cache.items()}}
    tokens = torch.zeros((rows, 1), dtype=torch.int32, device="meta")
    step = make_sharded_serve_step(model, mesh)
    with counter, flops:
        step(params, cache, tokens)
    leaves = [(n, t) for k, v in cache.items() if k != "length"
              for n, t in (v.items() if isinstance(v, dict) else [(k, v)])]

def rank_rows(name, t):
    dim = sharding.cache_batch_dim(name, t.dim())
    return t.numel() * t.element_size() * t.to_local().shape[dim] // t.shape[dim]

scan = None
if {prefill!r} and cfg.family == "ssm":
    # the one-process ssd_scan's FLOPs on a data rank's rows over the
    # rank's block of the heads and over every head
    from repro_torch.models.ssd import ssd_scan
    scan = []
    for heads in (cfg.ssm_heads // 16, cfg.ssm_heads):
        b, hp, n = rows // 16, cfg.ssm_headdim, cfg.ssm_state
        s = -(-max_len // cfg.ssd_chunk) * cfg.ssd_chunk
        count = FlopCounterMode(display=False)
        with count:
            ssd_scan(torch.zeros((b, s, heads, hp), device="meta"),
                     torch.zeros((b, s, heads), device="meta"),
                     torch.zeros((heads,), device="meta"),
                     torch.zeros((b, s, n), device="meta"),
                     torch.zeros((b, s, n), device="meta"), cfg.ssd_chunk)
        scan.append(count.get_total_flops())

split = {{n: p for n, p in params.items()
         if any(pl.is_shard() for pl in p.placements) and p.dim() >= 2}}
experts = params.get("moe_layers.0.moe.experts.w_down")
print(json.dumps({{
    "collectives": counter.collectives,
    "flops": flops.get_total_flops(),
    "reads_model_params": step.reads_model_params,
    "split_params": [p.numel() * p.element_size() for p in split.values()],
    "split_matrices": [p.numel() * p.element_size() for p in split.values()
                       if min(p.shape[-2:]) >= 128],
    "matrices": [p.numel() * p.element_size() for p in params.values()
                 if p.dim() >= 2],
    "model_split": [n for n, p in params.items()
                    if p.placements[-1].is_shard()],
    "param_bytes": {{n: [p.numel() * p.element_size(),
                        p.to_local().numel() * p.element_size()]
                    for n, p in params.items()}},
    "cache_rows": {{n: rank_rows(n, t) for n, t in leaves}},
    "scan_flops": scan,
    "experts_local": None if experts is None
                     else list(experts.to_local().shape)}}))
torch.distributed.destroy_process_group()
"""


def full_census(arch: str, cut: dict, rows: int, max_len: int,
                 prefill: bool = False, train: bool = False) -> dict:
    """FULL_CENSUS_SCRIPT's record of ``arch``'s full config cut by
    ``cut``, in a subprocess: its tensor-parallel serve step over a cache
    of ``rows`` x ``max_len``, with ``prefill`` its prefill step over
    ``rows`` x ``max_len`` tokens, or with ``train`` its train step over
    ``rows`` x (``max_len`` + 1) tokens (FSDP storage where the config
    asks)."""
    script = FULL_CENSUS_SCRIPT.format(arch=arch, cut=cut, rows=rows,
                                       max_len=max_len, prefill=prefill,
                                       train=train)
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root / "src"), *filter(None, [env.get("PYTHONPATH")])])
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, cwd=root, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def sharded_serve_worker(rank: int, world: int, init: str, out_dir: str,
                         shape: tuple):
    """The sharded prefill and serve steps on a (data, model) mesh of
    ``shape`` (`_serve_runs`): on (2, 2) SERVE's smoke model with the
    prefill ("smoke", the KV heads over 'model') and the wide model with
    its parameters in the FSDP layout ("fsdp", SERVE's batch only); on
    every shape the wide model ("wide"; on (2, 4) its 2 KV heads do not
    divide 'model', so the cache puts its sequence there) and each WIDE
    arch (by its name, from a random first cache and lengths), with each
    MOE_WIDE arch's expert-parallel `moe_block` ("ep_moe", arch) and
    every PREFILL_CASES case's tensor-parallel prefill ("prefill"). Rank
    0 writes the results by run and rows to serve{world}.pt. The weights
    are ``out_dir``'s weights.pt, weights_wide.pt,
    weights_wide_{arch}.pt and `prefill_weights`'."""
    from repro_torch.distributed import sharding
    _init(rank, world, init)
    mesh = sharding.device_mesh(sharding.MeshSpec(("data", "model"), shape),
                                "cpu")
    sharding.set_mesh(mesh)
    small = os.path.join(out_dir, "weights.pt")
    wide = os.path.join(out_dir, "weights_wide.pt")
    out = {"wide": _serve_runs(mesh, wide, True, False)}
    for arch in WIDE:
        weights = os.path.join(out_dir, f"weights_wide_{arch}.pt")
        out[arch] = _serve_runs(mesh, weights, True, False, arch=arch)
        if arch in MOE_WIDE:
            out["ep_moe", arch] = ep_moe_run(mesh, weights, arch)
    out["prefill"] = prefill_runs(mesh, out_dir)
    out["train"] = tp_train_runs(mesh, out_dir)
    if tuple(shape) == (2, 2):
        out["smoke"] = _serve_runs(mesh, small, False, True)
        out["fsdp"] = _serve_runs(mesh, wide, True, False, fsdp=True,
                                  rows_cases=(SERVE["batch"],))
    if rank == 0:
        torch.save(out, os.path.join(out_dir, f"serve{world}.pt"))
    sharding.clear_mesh()
    dist.destroy_process_group()
