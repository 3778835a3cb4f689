"""Production-mesh dry run (port of `repro.launch.dryrun`): rank 0's step
of every (arch x input-shape) cell on meta tensors, on a `DeviceMesh` of
the production shape, and a record of what that rank executes.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape decode_32k \\
        --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both \\
        --out results/dryrun_torch

The reference AOT-compiles each cell with XLA on 512 placeholder host
devices. PyTorch has no ahead-of-time SPMD compile, so the twin runs
rank 0's sharded step (`repro_torch.launch.specs.cell_lowerable`: the
steps of `repro_torch.train.loop`) on meta tensors over torch's "fake"
process group of 256 ((16, 16) 'data' x 'model') or 512 ((2, 16, 16)
with 'pod') ranks, where every collective returns at once and nothing
moves, and counts what the rank executes. Nothing allocates and no
device is touched; the process group is made inside `run_cell`, never
at import.

One JSON record a cell, ``{arch}__{shape}__{mesh}[__L{n}[u]].json``,
with the reference's keys where their meaning carries over:

  ok, arch, shape, mesh, devices, n_layers_override
      as the reference's; ``ok`` means the rank's step ran to its end.
      A failing cell gets ``ok`` false, ``error`` and ``traceback``, and
      the CLI exits 1.
  argument_size_in_bytes
      rank 0's local shards of the step's inputs in their production
      layouts (`specs.argument_bytes`): for train the parameters, the
      AdamW moments in the ZeRO layout, the step count and the batch;
      for prefill the parameters and the batch; for decode the
      parameters, the cache in `cache_shardings`' layout and the tokens.
      Exact: a pure function of the placements.
  output_size_in_bytes
      rank 0's local bytes of the step's outputs.
  temp_size_in_bytes
      MemTracker's peak over the step, less the arguments (the model's
      full parameters included where the step gathers into them, as the
      train step of the ssm, hybrid and encdec families does; the
      tensor-parallel steps (decode and prefill of every family, train of
      the dense, VLM and moe families) compute on the argument shards and
      hold no full parameter: a moe layer's dispatch buffers are those of
      the rank's experts over its rows of the global batch's grid).
  device_bytes_total
      arguments + temp, as the reference's.
  compute_peak_bytes, compute_bytes (port-only)
      MemTracker's peak, and the bytes counted as for ``hlo_bytes``,
      over the model call alone (the step's ``model_call``:
      `decode_step`, the prefill's `last_logits`, or the train step's
      `loss`, whose gradients the step takes after it), with the model
      (the rank's parameter shards in the tensor-parallel steps) and the
      call's inputs (the rank's rows, or its cache shard) resident: the
      work one card runs for the rank, without what the sharded step
      does around the call. Both are
      taken within the step's one run: the model's method is wrapped for
      the cell. A decode or prefill cell's model-call FLOPs are its
      ``hlo_flops``: those steps compute no FLOPs outside the call.
  decode_attention_calls, rank_rows (port-only)
      the step's `decode_attention` calls, and the batch rows rank 0
      computes (every row where the data axes do not divide them).
  reads_model_params (port-only)
      the step's own flag: True where it gathers every parameter into
      the model's own (the train step of the ssm, hybrid and encdec
      families), whose bytes then count among the temporaries; False
      where it computes on the argument shards (every other step).
  hlo_flops
      rank 0's FLOPs: `FlopCounterMode`'s total (matmul-class ops only)
      plus each `decode_attention` call's FLOPs from
      `decode_attention_cost`. XLA's count also holds elementwise ops;
      the two numbers are not compared.
  hlo_bytes
      rank 0's unfused traffic: over every aten op that is neither a
      view nor a metadata op, its input bytes plus its output bytes (a
      gather reads what it returns, a scatter writes what it is given,
      `copy_` does not read its destination), collectives included,
      plus each `decode_attention` call's bytes from its cost function.
      In eager PyTorch every op reads its inputs from, and writes its
      output to, device memory, so this is the eager step's own traffic.
  collectives
      per type (all-gather, all-reduce, reduce-scatter, all-to-all,
      collective-permute) ``count`` and ``bytes`` (output bytes on rank
      0), then ``total_bytes``: from the `c10d_functional` and `c10d`
      ops that DTensor and the steps issue. The reference's
      ``bytes_f32`` and ``total_bytes_tpu`` correct for XLA-CPU
      legalising bf16 to f32, which the port does not do: no twin.
  trace_s, total_s
      the step's seconds under the counters, and the cell's in all (in
      place of the reference's lower_s and compile_s).

``hlo_flops`` and ``hlo_bytes`` keep the reference's names because
`repro_torch.serve.router` reads them; they count the eager step, not
HLO. No time follows from a record: each is a count.

``--save-hlo PATH`` writes the op log the counts were taken from (the
port has no HLO to save). ``--unroll`` sets `models.flags.SCAN_UNROLL`
(see there). ``--out`` defaults to ``results/dryrun_torch``: the
reference's ``results/dryrun`` holds the reference's records.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs.registry import SHAPES, cells
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.decode_attn import decode_attention
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import argument_bytes, build_cell, leaves

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute"}
_COMM_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")
# ops that move no bytes: allocations without a write, and wrappers
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "_unsafe_view", "lift_fresh",
               "_wrap_tensor_autograd", "wait_tensor", "resize_", "set_"}
# ops that read only what they return from their first argument
_GATHERS = {"index", "embedding", "gather", "index_select"}
# in-place ops that write only what they are given (the argument at this
# position) into their first one
_SCATTERS = {"index_put_": 2, "_index_put_impl_": 2, "index_copy_": 3,
             "index_add_": 3, "scatter_": 3, "scatter_add_": 3,
             "scatter_reduce_": 3}


def _meta_bytes(tree) -> int:
    """Bytes of the meta tensors in a tree of op arguments (a DTensor
    counts its local shard)."""
    from torch.distributed.tensor import DTensor
    n = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor) and t.device.type == "meta":
            n += t.numel() * t.element_size()
    return n


class OpCounter(TorchDispatchMode):
    """Counts, for every aten and c10d op dispatched while it is active,
    the bytes it moves (``bytes``, by the rule of the module docstring)
    and logs each collective as (type, output bytes) (``collectives``;
    see `collective_census`). With ``keep_log`` it also keeps one line
    an op (``log``)."""

    def __init__(self, keep_log: bool = False):
        super().__init__()
        self.bytes = 0
        self.collectives: list[tuple[str, int]] = []
        self.log: list[str] | None = [] if keep_log else None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, name = func.namespace, func._opname
        if ns in _COMM_NAMESPACES and name in _COLLECTIVE_OPS:
            self.collectives.append((_COLLECTIVE_OPS[name], _meta_bytes(out)))
        elif ns in _COMM_NAMESPACES and name not in _NO_TRAFFIC:
            raise ValueError(f"dry run: collective {func} has no census type")
        if func.is_view or name in _NO_TRAFFIC:
            n = 0
        elif name in _GATHERS:
            n = _meta_bytes((args[1:], kwargs)) + 2 * _meta_bytes(out)
        elif name in _SCATTERS:
            n = _meta_bytes((args[1:], kwargs)) + _meta_bytes(
                args[_SCATTERS[name]] if len(args) > _SCATTERS[name] else ())
        elif name == "copy_":
            n = 2 * _meta_bytes(args[1])
        else:
            n = _meta_bytes((args, kwargs)) + _meta_bytes(out)
        self.bytes += n
        if self.log is not None:
            shapes = [tuple(t.shape) for t in tree_leaves((args, kwargs))
                      if isinstance(t, torch.Tensor)]
            self.log.append(f"{func} {shapes} bytes={n}")
        return out


def collective_census(events) -> dict:
    """Per collective type its ``count`` and ``bytes`` (the output bytes
    on this rank), and ``total_bytes``, from (type, output bytes) pairs
    (`OpCounter.collectives`)."""
    out: dict = {k: {"count": 0, "bytes": 0} for k in _COLLECTIVES}
    for kind, nbytes in events:
        out[kind]["count"] += 1
        out[kind]["bytes"] += nbytes
    out["total_bytes"] = sum(out[k]["bytes"] for k in _COLLECTIVES)
    return out


def _fake_group(world: int) -> None:
    """A "fake" default process group of ``world`` ranks, this one rank
    0 (the one it replaces, if any, destroyed first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _tracked(external):
    """A MemTracker that counts the ``external`` tensors and modules as
    resident."""
    from torch.distributed._tools.mem_tracker import MemTracker
    tracker = MemTracker()
    tracker.track_external(*external)
    return tracker


def _peak(tracker) -> int:
    """``tracker``'s peak on the meta device."""
    return int(tracker.get_tracker_snapshot("peak")
               [torch.device("meta")]["Total"])


@contextlib.contextmanager
def _model_call_window(model, name: str):
    """While active, the model's method ``name`` (the step's
    ``model_call``) runs under a MemTracker and an OpCounter of its own,
    the model and the call's tensor arguments counted resident; yields a
    dict that then holds the call's ``peak`` and ``bytes``
    (`decode_attention`'s included)."""
    inner = getattr(model, name)
    window: dict = {}

    def call(*args, **kwargs):
        inputs = [t for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)]
        tracker, counter = _tracked([model, *inputs]), OpCounter()
        attn = decode_attention.meta["bytes"]
        with tracker, counter:
            out = inner(*args, **kwargs)
        window.update(peak=_peak(tracker), bytes=counter.bytes
                      + decode_attention.meta["bytes"] - attn)
        return out

    setattr(model, name, call)
    try:
        yield window
    finally:
        delattr(model, name)


def run_cell(arch: str, shape: str, mesh_kind: str,
             n_layers_override=None, save_hlo: str | None = None) -> dict:
    from torch.distributed.tensor import DTensor
    from torch.utils.flop_counter import FlopCounterMode
    spec = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    world = math.prod(spec.sizes)
    t0 = time.perf_counter()
    _fake_group(world)
    mesh = shd.device_mesh(spec, "cpu")
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
           "devices": world, "n_layers_override": n_layers_override}
    try:
        model, step, args = build_cell(arch, shape, mesh,
                                       n_layers_override=n_layers_override)
        arg_bytes = argument_bytes(args)
        local_args = [t.to_local() if isinstance(t, DTensor) else t
                      for t in leaves(args)]
        flops = FlopCounterMode(display=False)
        counter = OpCounter(keep_log=save_hlo is not None)
        tracker = _tracked([model] * step.reads_model_params + local_args)
        decode_attention.meta.update(calls=0, flops=0, bytes=0)
        t1 = time.perf_counter()
        with _model_call_window(model, step.model_call) as call:
            with tracker, flops, counter:
                outputs = step(*args)
        rec["trace_s"] = time.perf_counter() - t1
        peak = _peak(tracker)
        attn = decode_attention.meta
        n_data = math.prod(s for name, s in zip(spec.axis_names, spec.sizes)
                           if name in ("pod", "data"))
        b = SHAPES[shape]["global_batch"]
        rec.update(
            argument_size_in_bytes=arg_bytes,
            output_size_in_bytes=argument_bytes(outputs),
            temp_size_in_bytes=peak - arg_bytes,
            device_bytes_total=peak,
            compute_peak_bytes=call["peak"],
            compute_bytes=call["bytes"],
            hlo_flops=int(flops.get_total_flops()) + attn["flops"],
            hlo_bytes=counter.bytes + attn["bytes"],
            decode_attention_calls=attn["calls"],
            rank_rows=b // n_data if b % n_data == 0 else b,
            reads_model_params=step.reads_model_params,
            collectives=collective_census(counter.collectives))
        if save_hlo:
            Path(save_hlo).write_text("\n".join(counter.log) + "\n")
    finally:
        shd.clear_mesh()
        shd.set_fsdp(False)
    rec["ok"] = True
    rec["total_s"] = time.perf_counter() - t0
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth override (the reference's roofline "
                         "lowerings)")
    ap.add_argument("--unroll", action="store_true",
                    help="set models.flags.SCAN_UNROLL (one full-width "
                         "q-block; the port's loops are counted exactly "
                         "either way)")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--save-hlo", default=None,
                    help="write the op log the counts were taken from")
    args = ap.parse_args(argv)

    if args.unroll:
        from repro_torch.models import flags
        flags.SCAN_UNROLL = True

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    todo = cells() if args.all else [(args.arch, args.shape, False)]

    failures = 0
    t0 = time.perf_counter()
    try:
        for mk in meshes:               # one process group a mesh
            for arch, shape, _ in todo:
                tag = f"{arch}__{shape}__{mk}"
                if args.layers:
                    tag += f"__L{args.layers}" + ("u" if args.unroll else "")
                try:
                    rec = run_cell(arch, shape, mk,
                                   n_layers_override=args.layers,
                                   save_hlo=args.save_hlo)
                    print(f"[ok] {tag}: step {rec['trace_s']:.1f}s "
                          f"mem/dev {rec['device_bytes_total'] / 2**30:.2f} "
                          f"GiB coll "
                          f"{rec['collectives']['total_bytes'] / 2**20:.1f} "
                          f"MiB", flush=True)
                except Exception as e:  # noqa: BLE001 — record, continue
                    failures += 1
                    rec = {"arch": arch, "shape": shape, "mesh": mk,
                           "ok": False, "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()}
                    print(f"[FAIL] {tag}: {type(e).__name__}: {e}",
                          flush=True)
                (outdir / f"{tag}.json").write_text(json.dumps(rec, indent=2))
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"[done] {len(todo) * len(meshes)} cells, {failures} failed, "
          f"wall {time.perf_counter() - t0:.1f}s", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
