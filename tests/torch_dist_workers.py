"""Rank bodies of tests/test_torch_distributed.py, spawned as gloo process
groups on the CPU. They import only torch, numpy and `repro_torch`, so a
rank does not load JAX; each writes what it computed under the output
directory, and the test compares it in the parent process."""

import os

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
