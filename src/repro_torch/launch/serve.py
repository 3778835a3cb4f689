"""Serving driver: Spork-scheduled hybrid fleet + a live model engine.

Two coupled layers:
  * the ROUTER plays the paper: a Spork scheduler (Algs. 1-3) sizes an
    accelerator pool and dispatches a request trace, with service times
    derived from the architecture's roofline profile on the card;
  * the ENGINE proves the compute side: a real model replica decodes
    batched requests through the `Model` API.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --minutes 10 --rate 40 --objective energy

Both run on the card unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.traces import synthetic_trace
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.router import SporkRouter


def main(argv: list[str] | None = None) -> dict:
    """Run the router over a synthetic trace, then decode a few requests
    on the architecture's smoke model. Returns the router's report, the
    number of routed requests and the tokens the engine emitted."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--minutes", type=float, default=10.0)
    ap.add_argument("--rate", type=float, default=40.0,
                    help="mean request rate (req/s) for the router trace")
    ap.add_argument("--burstiness", type=float, default=0.65)
    ap.add_argument("--objective", default="energy",
                    choices=["energy", "cost", "balanced"])
    ap.add_argument("--engine-requests", type=int, default=4,
                    help="live requests decoded by the model engine")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    w = {"energy": 1.0, "cost": 0.0, "balanced": 0.5}[args.objective]
    horizon = int(args.minutes * 60)

    # --- scheduling plane: Spork sizes the fleet for this arch ---
    router = SporkRouter(args.arch, energy_weight=w, horizon_s=horizon,
                         device=dev)
    size = router.size_s
    tr = synthetic_trace(seed=1, bias=args.burstiness, horizon_s=horizon,
                         request_size_s=size,
                         mean_demand_workers=args.rate * size)
    arrivals = tr.arrival_times(seed=2)
    for t in arrivals:
        router.submit(float(t))
    rep = router.finish()
    print(f"[router] arch={args.arch} size={size * 1e3:.1f}ms "
          f"x{len(arrivals)} reqs")
    print(f"[router] energy_eff={rep.energy_efficiency:.3f} "
          f"rel_cost={rep.relative_cost:.3f} "
          f"miss={rep.deadline_miss_rate:.4f} "
          f"cpu_frac={rep.cpu_request_fraction:.3f}")

    # --- compute plane: decode a few live requests on the smoke model ---
    cfg = get_config(args.arch, "smoke")
    model = build_model(cfg, seed=0, device=dev)
    engine = ServeEngine(model, batch_slots=4, max_len=128)
    rng = np.random.default_rng(0)
    for rid in range(args.engine_requests):
        prompt = rng.integers(0, cfg.vocab_size, size=8).astype(np.int32)
        engine.add_request(Request(rid=rid, prompt=prompt,
                                   max_new_tokens=args.new_tokens))
    emitted = 0
    while engine.n_active:
        emitted += len(engine.step())
    print(f"[engine] decoded {emitted} tokens across "
          f"{args.engine_requests} requests (batched slots)")
    return {"report": rep, "requests": len(arrivals), "emitted": emitted}


if __name__ == "__main__":
    main()
