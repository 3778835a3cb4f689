"""End-to-end training driver with checkpoint/restart and elastic recovery
(port of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --variant smoke --steps 50 --batch 8 --seq 128 --ckpt-dir ckpt

It runs on the card unless ``--device cpu`` asks for the CPU. What it
does, as the reference does:
  * deterministic resumable data (batch t is a pure function of the step),
  * periodic atomic checkpoints and auto-resume from LATEST,
  * on a step failure: the largest healthy mesh over the visible devices
    (`repro_torch.ft.elastic.shrink_mesh`) becomes the active one, the
    latest checkpoint is restored, and the run continues,
  * straggler bookkeeping (`repro_torch.ft.elastic.StragglerPolicy`).

The step arithmetic is the reference's, including two behaviours kept as
they are: the save after training step k is labelled k and a resumed run
starts at ``range(k, steps)``, so it trains batch k twice; and after a
failure the loop variable is set back to the checkpoint's step, which
does not rewind the ``for`` loop, so the batches in between are skipped.

Port-only flags: ``--device``, ``--n-layers`` (a depth cut, for a
full-width run whose checkpoints must stay small), ``--dtype`` (the
weights' type, for a float32 run that a CPU run can be held to) and
``--deterministic`` (`torch.use_deterministic_algorithms`; on the card
also set CUBLAS_WORKSPACE_CONFIG=:4096:8).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.ft.elastic import StragglerPolicy, shrink_mesh
from repro_torch.models import Model
from repro_torch.train.loop import (TrainState, init_train_state,
                                    make_train_step)


def build(arch: str, variant: str, seq: int, batch: int, steps: int,
          compress: bool, lr: float,
          device: str | torch.device | None = None,
          n_layers: int | None = None, dtype: torch.dtype | None = None):
    """(cfg, model, pipeline, step function) as the reference builds them
    (warmup 10, ``total_steps`` = ``steps``); the model's weights are not
    drawn yet (`init_train_state` draws them). ``n_layers`` cuts the
    depth and ``dtype`` sets the weights' type (None: the config's)."""
    dev = resolve_device(device)
    cfg = get_config(arch, variant)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    model = Model(cfg, dev)
    frontend = ((cfg.src_len, cfg.d_model) if cfg.family == "encdec" else
                (cfg.n_patches, cfg.d_model) if cfg.family == "vlm" else None)
    pipe = TokenPipeline(cfg.vocab_size, seq, batch, frontend_shape=frontend,
                         device=dev)
    step_fn = make_train_step(model, base_lr=lr, warmup=10,
                              total_steps=steps, compress=compress)
    return cfg, model, pipe, step_fn


def _restore(mgr: CheckpointManager, state: TrainState, device):
    """The latest checkpoint into ``state``: the weights are written into
    the model's own parameters (``state.params``), the moments, step and
    residuals come back as new tensors. Returns (state, manifest)."""
    (saved,), manifest = mgr.restore((state,), device=device)
    with torch.no_grad():
        for name, p in state.params.items():
            p.copy_(saved.params[name])
    return TrainState(params=state.params, opt=saved.opt,
                      ef=saved.ef), manifest


def _visible_devices(device: torch.device) -> list[str]:
    """The devices a shrunken mesh may use: every visible card, or the
    CPU."""
    if device.type == "cuda":
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [str(device)]


def main(argv: list[str] | None = None) -> dict:
    """Train, checkpoint and resume as the reference's driver does.
    Returns the final state and metrics, the step the run resumed from,
    and the steps that failed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--variant", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--compress", action="store_true",
                    help="error-feedback int8 gradient compression")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--dtype", default=None,
                    choices=["bfloat16", "float32"],
                    help="the weights' type (default: the config's)")
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.use_deterministic_algorithms(True)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.deterministic:
        torch.use_deterministic_algorithms(True)

    cfg, model, pipe, step_fn = build(args.arch, args.variant, args.seq,
                                      args.batch, args.steps, args.compress,
                                      args.lr, device=dev,
                                      n_layers=args.n_layers,
                                      dtype=(getattr(torch, args.dtype)
                                             if args.dtype else None))
    mgr = CheckpointManager(args.ckpt_dir, every_steps=args.ckpt_every)
    stragglers = StragglerPolicy()

    state = init_train_state(model, seed=0, compress=args.compress)
    start = 0
    if mgr.latest() is not None:
        state, manifest = _restore(mgr, state, dev)
        start = manifest["step"]
        print(f"[resume] restored step {start} from {args.ckpt_dir}",
              flush=True)

    metrics, failed = None, []
    for step in range(start, args.steps):
        batch = pipe.batch_at(step)
        t0 = time.time()
        try:
            state, metrics = step_fn(state, batch)
        except Exception as e:  # noqa: BLE001 — elastic recovery path
            print(f"[elastic] step {step} failed ({type(e).__name__}); "
                  f"rebuilding mesh from survivors", flush=True)
            failed.append(step)
            mesh, dropped = shrink_mesh(_visible_devices(dev), model_width=1)
            shd.set_mesh(mesh)
            if mgr.latest() is None:
                raise
            state, manifest = _restore(mgr, state, dev)
            step = manifest["step"]
            continue
        dt = time.time() - t0
        stragglers.record(0, dt)
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {float(metrics['loss']):8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt * 1000:7.1f} ms",
                  flush=True)
        if mgr.should_save(step):
            mgr.save(step, (state,), {"arch": args.arch})
    mgr.save(args.steps, (state,), {"arch": args.arch})
    loss = "n/a" if metrics is None else f"{float(metrics['loss']):.4f}"
    print(f"[done] {args.steps} steps; final loss {loss}", flush=True)
    return {"state": state, "metrics": metrics, "resumed_from": start,
            "failed_steps": failed}


if __name__ == "__main__":
    main()
