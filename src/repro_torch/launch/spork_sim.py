"""Figs. 5-7 sensitivity grid: the paper-native sweep workload.

The sensitivity studies (Figs. 5-7) evaluate a grid of (worker config x
burstiness x trace seed) points; each point is an independent run of the
batched rate simulator. This launcher routes the grid through the sweep
stack: `repro_torch.sim.plan.plan_sweep` builds the dispatch plan and
`repro_torch.sim.exec.get_backend` runs it, on one device or split over
several (`MeshBackend`):

    PYTHONPATH=src python -m repro_torch.launch.spork_sim --points 64 \\
        --backend mesh

Everything runs on the card unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.bmodel import bmodel_rates_np
from repro_torch.core.workers import DEFAULT_FLEET
from repro_torch.sim.exec import execute, get_backend
from repro_torch.sim.plan import SweepResult, plan_sweep
from repro_torch.sim.sweep import SweepCell


def sweep_grid(n_points: int, seed: int = 0, horizon_s: int = 1800,
               size_s: float = 0.05):
    """The grid's inputs: per-point (counts, biases, speeds, busy). The
    biases, speedups and busy powers are the reference's draws from
    ``numpy.random.default_rng(seed)``; the counts are Poisson draws
    (numpy) on the port's b-model rates, which match the reference's only
    in distribution."""
    rng = np.random.default_rng(seed)
    biases = rng.uniform(0.5, 0.75, n_points).astype(np.float32)
    speeds = rng.choice([1.0, 2.0, 4.0], n_points).astype(np.float32)
    busy = rng.choice([25.0, 50.0, 100.0], n_points).astype(np.float32)
    counts = np.stack([
        np.random.default_rng(seed + i).poisson(
            np.maximum(bmodel_rates_np(seed + i, float(biases[i]), horizon_s,
                                       100.0 / size_s), 0))
        for i in range(n_points)]).astype(np.int32)
    return counts, biases, speeds, busy


def grid_cells(counts, speeds, busy, size_s: float = 0.05) -> list[SweepCell]:
    """One `SweepCell` per grid point: the point's worker config rides in
    the cell's `FleetParams` (accelerator speedup + busy power), so the
    planner groups and pads it like any other sweep."""
    return [
        SweepCell(policy="spork", counts=counts[i], size_s=size_s,
                  fleet=DEFAULT_FLEET.replace(
                      fpga=DEFAULT_FLEET.fpga.replace(
                          speedup=float(speeds[i]),
                          busy_w=float(busy[i]))))
        for i in range(len(speeds))]


def run_sweep(counts, speeds, busy, size_s: float = 0.05, backend=None,
              n_max: int = 256, device=None, checkpoint_dir=None,
              retry=None) -> SweepResult:
    """The grid through plan + execute on ``backend`` / ``device`` (None:
    one card), resumable from ``checkpoint_dir``."""
    cells = grid_cells(counts, speeds, busy, size_s=size_s)
    be = get_backend(backend, device)
    return execute(plan_sweep(cells, n_max=n_max, device=be.device), be,
                   checkpoint_dir=checkpoint_dir, retry=retry)


def grid_metrics(res: SweepResult, speeds, busy
                 ) -> tuple[np.ndarray, np.ndarray]:
    """(eff, cost) per point: ideal-busy-energy / simulated energy, and
    simulated $ cost."""
    eff = np.zeros(len(res))
    cost = np.zeros(len(res))
    for i in range(len(res)):
        t = res.totals(i)
        ideal = ((t.work_on_fpga_cpu_s + t.work_on_cpu_cpu_s)
                 / float(speeds[i]) * float(busy[i]))
        eff[i] = ideal / max(t.energy_j, 1e-9)
        cost[i] = t.cost_usd
    return eff, cost


def run_grid(counts, speeds, busy, size_s: float = 0.05, backend=None,
             n_max: int = 256, device=None, checkpoint_dir=None, retry=None
             ) -> tuple[np.ndarray, np.ndarray]:
    """`run_sweep` then `grid_metrics`: (eff, cost) per point."""
    res = run_sweep(counts, speeds, busy, size_s=size_s, backend=backend,
                    n_max=n_max, device=device,
                    checkpoint_dir=checkpoint_dir, retry=retry)
    return grid_metrics(res, speeds, busy)


def main(argv: list[str] | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Run the grid from the command line and print one line a point."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=8)
    ap.add_argument("--horizon", type=int, default=900)
    ap.add_argument("--backend", default=None,
                    help="sweep backend: local | mesh (default: local)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    counts, biases, speeds, busy = sweep_grid(args.points,
                                              horizon_s=args.horizon)
    eff, cost = run_grid(counts, speeds, busy, backend=args.backend,
                         device=args.device)
    for i in range(args.points):
        print(f"point {i}: bias={biases[i]:.2f} S={speeds[i]:.0f} "
              f"B_f={busy[i]:.0f}W -> eff={eff[i]:.3f} "
              f"cost=${cost[i]:.2f}")
    return eff, cost


if __name__ == "__main__":
    main()
