#!/usr/bin/env python3
"""Drive the PyTorch port (`repro_torch`) on one CUDA card and check it.

Usage, from the root of a checkout:  python3 chip_smoke.py

Phases, each printed as one JSON line; any failed check exits non-zero:

  device       card name, compute capability, nvidia-smi name/power limit
  build        the main path's kernel built from the checkout's sources
               with nvcc (seconds, ptxas report)
  kernel       spork_predict against its plain PyTorch version at C in
               {1, 32} cells x N in {16, 200, 512, 4096} bins: against the
               plain version on the card, mask equal and finite entries
               within rtol 2e-5; against the plain version on the CPU (the
               oracle of the allocator's choices), mask and argmin equal
               on every shape and J bitwise equal at the main path's shape
               C=32, N=512; times at that shape
  main         Table 8 for the Azure "short" stand-ins (13 apps, 7200 s,
               n_max 512) through `sweep` + `tune_fpga_dynamic_cells` on
               the card, all eight schedulers; the kernel's launch count
               over this run must equal the plan's allocator ticks
  main_vs_cpu  the Spork cells rerun with device="cpu" (plain version):
               counters identical, energies/costs within 1e-5 relative
  profile      device-idle share of one Spork chunk (32 cells, first
               120 s) under torch.profiler, and the kernel's device time

Then the `{"kernels": [...]}` summary line, the raw nvidia-smi line, and
last `{"ok": true, "device": {...}}`. With no CUDA card, or run outside
a checkout (no src/repro_torch beside it), it exits 2 and prints no
result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
RTOL_KERNEL = 2e-5
RTOL_CPU = 1e-5
SCHEDULERS = [                   # benchmarks/table8_production.py
    ("CPU-dynamic", "cpu_dynamic", {}),
    ("FPGA-static", "fpga_static", {}),
    ("FPGA-dynamic", "fpga_dynamic", {"tuned": True}),
    ("MArk-ideal", "mark_ideal", {}),
    ("SporkC", "spork", {"energy_weight": 0.0}),
    ("SporkB", "spork", {"energy_weight": 0.5}),
    ("SporkE", "spork", {"energy_weight": 1.0}),
    ("SporkE-ideal", "spork_ideal", {"energy_weight": 1.0}),
]


class CheckFailed(RuntimeError):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def cuda_ms(fn, reps: int, torch) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(5):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int, torch) -> float:
    """Device time of one ``fn`` call, from a CUDA graph of ``reps``
    calls (no host launch overhead between them)."""
    side = torch.cuda.Stream()              # warm up off the capture stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------- phases

def phase_device(torch) -> tuple[str, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    cc = torch.cuda.get_device_capability(0)
    emit({"phase": "device", "name": name, "capability": f"{cc[0]}.{cc[1]}",
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return name, smi


def phase_build() -> None:
    from repro_torch.kernels.build import build_library
    from repro_torch.kernels.spork_predict import ops
    b = build_library("spork_predict", ops.SOURCES)
    emit({"phase": "build", "kernels": {"spork_predict": {
        "seconds": b.seconds, "library": b.path.name,
        "ptxas": [ln.strip() for ln in b.log.splitlines()
                  if "ptxas info" in ln]}}})


def _predict_inputs(cells: int, n: int, seed: int, torch, dev="cuda"):
    """Histograms, amortization vectors and per-cell objective mixes like
    the allocator tick's, made from a numpy seed, on ``dev``."""
    import numpy as np
    from repro_torch.core.breakeven import ObjectiveCoeffs, weighted_coeffs
    from repro_torch.core.predictor import amortization_vector
    from repro_torch.core.workers import DEFAULT_FLEET
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 6, (cells, n)).astype(np.float32)
    hist[rng.random((cells, n)) < 0.5] = 0.0
    if cells > 2:
        hist[1] = 0.0                       # empty histogram: all masked
        hist[2] = 0.0
        hist[2, n // 2] = 7.0               # one bin: one candidate
    w = rng.uniform(0.0, 1.0, cells)
    co = [weighted_coeffs(DEFAULT_FLEET, float(x)) for x in w]
    coeffs = ObjectiveCoeffs(*(torch.tensor([c[i] for c in co],
                                            dtype=torch.float32, device=dev)
                               for i in range(4)))
    life_sum = torch.tensor(rng.uniform(0, 200, (cells, n)),
                            dtype=torch.float32, device=dev)
    life_cnt = torch.tensor(rng.integers(0, 4, (cells, n)),
                            dtype=torch.float32, device=dev)
    n_curr = torch.tensor(rng.integers(0, n, cells), dtype=torch.int32,
                          device=dev)
    amort = amortization_vector(life_sum, life_cnt, n_curr,
                                DEFAULT_FLEET.T_s, coeffs.amort_unit)
    return torch.tensor(hist, device=dev), coeffs, amort


def coeffs_cpu(coeffs):
    return type(coeffs)(*(x.cpu() for x in coeffs))


def phase_kernel(torch) -> dict:
    from repro_torch.core.predictor import expected_objective as plain
    from repro_torch.kernels.spork_predict import ops
    cases = []
    main = None
    for cells in (1, 32):
        for n in (16, 200, 512, 4096):
            hist, coeffs, amort = _predict_inputs(cells, n, 1000 * cells + n,
                                                  torch)
            got = ops.expected_objective(hist, coeffs, amort)
            want = plain(hist, coeffs, amort)
            torch.cuda.synchronize()
            fin_g, fin_w = torch.isfinite(got), torch.isfinite(want)
            check(bool(torch.equal(fin_g, fin_w)),
                  f"spork_predict mask differs at C={cells} N={n}")
            diff = (got - want).abs()[fin_w]
            rel = diff / want.abs()[fin_w].clamp(min=1e-30)
            max_abs = float(diff.max()) if diff.numel() else 0.0
            max_rel = float(rel.max()) if rel.numel() else 0.0
            check(max_rel <= RTOL_KERNEL,
                  f"spork_predict rel err {max_rel} at C={cells} N={n}")
            # The plain version on the CPU is the oracle of the allocator's
            # choices (tests and goldens run it); cuBLAS sums the card's
            # plain version in another order, so its argmin may flip on a
            # near-tie and is only counted.
            cpu_plain = plain(hist.cpu(), coeffs_cpu(coeffs), amort.cpu())
            got_cpu = got.cpu()
            check(bool(torch.equal(torch.isfinite(got_cpu),
                                   torch.isfinite(cpu_plain))),
                  f"spork_predict mask differs from the CPU at C={cells} N={n}")
            rows = torch.isfinite(cpu_plain).any(dim=1)
            a_got = torch.argmin(got_cpu, 1)
            check(bool(torch.equal(a_got[rows],
                                   torch.argmin(cpu_plain, 1)[rows])),
                  f"spork_predict argmin differs from the CPU plain version "
                  f"at C={cells} N={n}")
            flips = int((rows & (a_got != torch.argmin(want.cpu(), 1))).sum())
            bitwise_cpu = bool(torch.equal(got_cpu, cpu_plain))
            if (cells, n) == (32, 512):
                check(bitwise_cpu, "spork_predict is not bitwise equal to the "
                                   "CPU plain version at the main path's shape")
            case = {"C": cells, "N": n, "max_abs_err": max_abs,
                    "max_rel_err": max_rel, "argmin_equal_cpu_plain": True,
                    "bitwise_equal_cpu_plain": bitwise_cpu,
                    "bitwise_equal_card_plain": bool(torch.equal(got, want)),
                    "argmin_flips_vs_card_plain": flips}
            cases.append(case)
            if (cells, n) == (32, 512):
                main = (hist, coeffs, amort, case)
    hist, coeffs, amort, case = main
    cells, n = hist.shape
    kernel_ms = graph_ms(lambda: ops.expected_objective(hist, coeffs, amort),
                         100, torch)
    plain_ms = graph_ms(lambda: plain(hist, coeffs, amort), 100, torch)
    eager_ms = cuda_ms(lambda: ops.expected_objective(hist, coeffs, amort),
                       200, torch)
    plain_eager_ms = cuda_ms(lambda: plain(hist, coeffs, amort), 200, torch)
    # least work: read hist + amort + 3 coefficients per cell, write J;
    # ~20 flops per candidate (p, p*b, two prefix adds, the J expression)
    nbytes = 4 * (3 * cells * n + 3 * cells)
    flops = 20 * cells * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    out = {"phase": "kernel", "name": "spork_predict", "cases": cases,
           "C": cells, "N": n, "ms": kernel_ms, "plain_ms": plain_ms,
           "eager_ms": eager_ms, "plain_eager_ms": plain_eager_ms,
           "bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None, "max_abs_err": case["max_abs_err"],
           "timing": "ms/plain_ms: CUDA-graph replay of 100 calls (device "
                     "time); eager_ms: CUDA events over 200 eager calls"}
    emit(out)
    return out


def _table8_cells():
    from repro_torch.core.traces import production_like_apps
    from repro_torch.core.workers import DEFAULT_FLEET
    from repro_torch.sim.sweep import SweepCell
    apps = production_like_apps("azure", "short", seed=1, horizon_s=7200)
    plain, tuned = [], []
    for label, policy, kw in SCHEDULERS:
        for tr in apps:
            cell = SweepCell(policy, tr.counts, tr.request_size_s,
                             DEFAULT_FLEET,
                             energy_weight=kw.get("energy_weight", 1.0),
                             tag=label)
            (tuned if kw.get("tuned") else plain).append(cell)
    return apps, plain, tuned


def phase_main(torch) -> dict:
    from repro_torch.core.metrics import RunTotals, report
    from repro_torch.core.workers import DEFAULT_FLEET
    from repro_torch.kernels.spork_predict import ops
    from repro_torch.sim.plan import plan_sweep
    from repro_torch.sim.sweep import sweep, tune_fpga_dynamic_cells

    apps, plain, tuned = _table8_cells()
    plan = plan_sweep(plain)
    expected = sum(d.static[4] // d.static[1] for d in plan.dispatches
                   if d.static[0].uses_predictor)
    ops.expected_objective.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sweep(plain, device="cuda")
    t1 = time.perf_counter()
    tuned_res = tune_fpga_dynamic_cells(tuned, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = ops.expected_objective.launches

    merged: dict[str, RunTotals] = {}
    for i, cell in enumerate(res.cells):
        merged[cell.tag] = merged.get(cell.tag, RunTotals()).merge(res.totals(i))
    for (_, tot), cell in zip(tuned_res, tuned):
        merged[cell.tag] = merged.get(cell.tag, RunTotals()).merge(tot)
    rows = {}
    for label, _, _ in SCHEDULERS:
        check(merged[label].is_finite(), f"{label}: non-finite totals")
        r = report(merged[label], DEFAULT_FLEET)
        rows[label] = {"energy_eff": r.energy_efficiency,
                       "rel_cost": r.relative_cost,
                       "miss_rate": r.deadline_miss_rate,
                       "cpu_frac": r.cpu_request_fraction}
    for i, cell in enumerate(res.cells):
        tot = res.totals(i)
        served = tot.work_on_fpga_cpu_s + tot.work_on_cpu_cpu_s
        if cell.policy in ("spork", "spork_ideal", "cpu_dynamic",
                           "mark_ideal"):      # CPU fallback serves it all
            check(abs(served - tot.work_cpu_s) <= 1e-3 * tot.work_cpu_s,
                  f"cell {i} ({cell.tag}): work not conserved")
    fd = rows["FPGA-dynamic"]
    ratios = {f"{s}_vs_FPGA-dynamic": {
        "energy_eff_x": rows[s]["energy_eff"] / fd["energy_eff"],
        "cheaper_x": fd["rel_cost"] / rows[s]["rel_cost"]}
        for s in ("SporkE", "SporkC")}
    out = {"phase": "main", "table": "8", "source": "azure",
           "bucket": "short", "apps": len(apps), "horizon_s": 7200,
           "n_max": plan.n_max, "cells": len(plain) + len(tuned),
           "rows": rows, "ratios": ratios,
           "sweep_dispatches": res.n_dispatches, "sweep_wall_s": t1 - t0,
           "tune_wall_s": t2 - t1, "wall_s": t2 - t0,
           "spork_predict_launches": launches,
           "expected_launches": expected}
    emit(out)
    check(expected == 1440, f"plan gives {expected} allocator ticks, not 1440")
    check(launches == expected,
          f"spork_predict launched {launches} times, expected {expected}")
    return {"res": res, "out": out}


def phase_main_vs_cpu(main: dict) -> dict:
    from repro_torch.sim.sweep import sweep
    res = main["res"]
    idx = [i for i, c in enumerate(res.cells) if c.policy == "spork"]
    t0 = time.perf_counter()
    cpu = sweep([res.cells[i] for i in idx], device="cpu")
    wall = time.perf_counter() - t0
    counters = ("requests", "deadline_misses", "fpga_spinups", "cpu_spinups")
    floats = ("energy_j", "cost_usd", "work_on_fpga_cpu_s",
              "work_on_cpu_cpu_s", "fpga_idle_j", "fpga_busy_j",
              "cpu_busy_j", "spinup_j")
    max_rel, bad, identical = 0.0, [], 0
    for j, i in enumerate(idx):
        g, c = res.totals(i), cpu.totals(j)
        same = True
        for f in counters:
            if getattr(g, f) != getattr(c, f):
                bad.append((i, f, getattr(g, f), getattr(c, f)))
        for f in floats:
            a, b = getattr(g, f), getattr(c, f)
            rel = abs(a - b) / max(abs(b), 1e-12)
            max_rel = max(max_rel, rel)
            same &= a == b
            if rel > RTOL_CPU and abs(a - b) > 1e-3:
                bad.append((i, f, a, b))
        identical += same
    out = {"phase": "main_vs_cpu", "cells": len(idx), "cpu_wall_s": wall,
           "max_rel_err": max_rel, "cells_bitwise_equal": identical,
           "mismatches": bad[:10]}
    emit(out)
    check(not bad, f"{len(bad)} card/CPU mismatches, first {bad[:3]}")
    return out


def phase_profile(main: dict, torch) -> dict:
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.sim.sweep import sweep
    window_s = 120
    cells = [replace(c, counts=c.counts[:window_s])
             for c in main["res"].cells if c.policy == "spork"][:32]
    sweep(cells, device="cuda")                     # warm up allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sweep(cells, device="cuda")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    trace = ROOT / "build" / "profile" / "spork_chunk.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   and "dur" in e)
    busy, end = 0.0, -math.inf
    for s, e in spans:                               # union of device spans
        if e > end:
            busy += e - max(s, end)
            end = e
    kern = [e["dur"] for e in events if e.get("cat") == "kernel"
            and "spork_predict" in e.get("name", "")]
    check(len(spans) > 0, "profiler recorded no device activity")
    check(len(kern) > 0, "profiler saw no spork_predict kernel")
    out = {"phase": "profile", "cells": len(cells), "window_s": window_s,
           "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "device_idle_share": 1.0 - busy / wall_us,
           "device_ops": len(spans), "spork_predict_launches": len(kern),
           "spork_predict_device_us_mean": sum(kern) / len(kern),
           "note": "wall time is under the profiler"}
    emit(out)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside the script; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import resolve_device
    resolve_device("cuda")                  # also pins fp32 matmuls (no TF32)

    name, smi = phase_device(torch)
    phase_build()
    kernel = phase_kernel(torch)
    main_run = phase_main(torch)
    phase_main_vs_cpu(main_run)
    phase_profile(main_run, torch)
    emit({"kernels": [{
        "name": "spork_predict", "route": "cuda",
        "source": "src/repro_torch/kernels/spork_predict/csrc/spork_predict.cu",
        "replaces": "src/repro/kernels/spork_predict/spork_predict.py:84",
        "launches": main_run["out"]["spork_predict_launches"],
        "max_abs_err": kernel["max_abs_err"], "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"], "bound_ms": kernel["bound_ms"],
        "bound_by": kernel["bound_by"], "library_ms": None}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"chip_smoke: check failed: {exc}", file=sys.stderr)
        sys.exit(1)
