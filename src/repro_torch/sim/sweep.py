"""Batched parameter sweeps: thin wrappers over plan + execute.

Port of `repro.sim.sweep` (rate and event cells). The paper's headline
results (Figs. 5-7, Table 8) are parameter-space sweeps: spin-up latency
x burstiness x policy x trace x worker parameters. Instead of one
`ratesim.simulate` call per grid cell, `sweep` plans the whole grid
(`repro_torch.sim.plan`) and runs each chunk of up to 32 or 256 cells as
one batched simulator call (`repro_torch.sim.exec`).

`sweep_events` does the same for discrete-event cells (`EventCell`,
Table 9): the batched `events_batched` engine, chunks of up to 32 cells
grouped by entry-stream length. `sweep_fleet` runs multi-tenant fleet
cells (`repro_torch.fleet.FleetCell`) on the batched fleet engine. Cells
may name a workload scenario instead of explicit demand; it is realized
on the sweep's device (`repro_torch.sim.plan.resolve_scenarios`).

Every entry point takes ``backend=`` (`repro_torch.sim.exec`: "local",
"mesh" or a `Backend`), ``checkpoint_dir=`` (each completed chunk is
persisted; a killed sweep restarted with the same directory re-executes
only the unfinished chunks, bit-identically) and ``retry=`` (a
`repro_torch.sim.harness.RetryPolicy`); every result passes the
invariant guards of `repro_torch.sim.harness` unless
``REPRO_SKIP_INVARIANTS`` opts out.

Equivalence: per-cell totals match per-call `ratesim.simulate` at the
same ``n_max`` to float32 tolerance.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Iterable

import numpy as np
import torch

from repro_torch.core.metrics import RunTotals
from repro_torch.core.workers import DEFAULT_FLEET, FleetParams
from repro_torch.sim.events_batched import EventCell
from repro_torch.sim.exec import Backend, execute, get_backend
from repro_torch.sim.plan import (CHUNK, CHUNK_BIG, _N_MAX_CAP,
                                  EventSweepResult, FleetSweepResult,
                                  SweepPlan, SweepResult, check_cells,
                                  plan_events, plan_fleet, plan_sweep,
                                  resolve_scenarios)
from repro_torch.sim.ratesim import headroom_unit, tune_fpga_dynamic

__all__ = [
    "EventCell", "EventSweepResult", "FleetSweepResult", "SweepCell",
    "SweepResult", "SweepPlan", "resolve_scenarios", "sweep",
    "sweep_events", "sweep_fleet", "tune_fpga_dynamic_cells", "CHUNK",
    "CHUNK_BIG",
]


@dataclass(frozen=True)
class SweepCell:
    """One grid cell of a parameter sweep: explicit per-second ``counts``
    plus a scalar ``size_s``, or a named workload (``scenario`` realized
    at ``seed``, `repro_torch.workloads.scenarios.ScenarioSpec`). A cell
    with ``failures`` runs on its degraded fleet
    (`FailureSpec.degrade_fleet`)."""

    policy: str
    counts: np.ndarray | None = None   # (T,) per-second arrival counts
    size_s: float | None = None        # request service time on a CPU worker
    fleet: FleetParams = DEFAULT_FLEET
    energy_weight: float = 1.0
    headroom: int = 0             # fpga_dynamic family only
    forecast_gain: float = 1.0    # predictive only: trend-extrapolation gain
    tag: Any = None               # caller's join key; carried through
    scenario: Any = None          # workloads.scenarios.ScenarioSpec
    seed: int = 0                 # scenario realization seed
    failures: Any = None          # FailureSpec, fluidized by plan_sweep

    def __post_init__(self):
        """Fail-fast construction-time validation: malformed cells raise
        a clear ValueError here instead of a shape error in the planner."""
        if self.counts is not None:
            c = np.asarray(self.counts)
            if c.ndim != 1:
                raise ValueError(
                    f"SweepCell.counts must be 1-D per-second counts, got "
                    f"shape {c.shape}")
            if c.size and (np.any(c < 0) or not np.all(np.isfinite(
                    c.astype(np.float64)))):
                raise ValueError(
                    "SweepCell.counts must be non-negative finite arrival "
                    "counts (negative rate injected?)")
        if self.size_s is not None and not (
                np.isfinite(self.size_s) and self.size_s > 0):
            raise ValueError(
                f"SweepCell.size_s must be a positive finite service "
                f"time, got {self.size_s!r}")
        if not np.isfinite(self.energy_weight):
            raise ValueError(
                f"SweepCell.energy_weight must be finite, got "
                f"{self.energy_weight!r}")
        if self.headroom < 0:
            raise ValueError(
                f"SweepCell.headroom must be >= 0, got {self.headroom!r}")
        if not np.isfinite(self.forecast_gain):
            raise ValueError(
                f"SweepCell.forecast_gain must be finite, got "
                f"{self.forecast_gain!r}")
        if np.ndim(self.seed) != 0:
            raise ValueError(
                f"SweepCell.seed must be a scalar, got shape "
                f"{np.shape(self.seed)}")


def sweep(cells: Iterable[SweepCell], n_max: int | None = None,
          backend: str | Backend | None = None,
          device: str | torch.device | None = None,
          checkpoint_dir=None, retry=None) -> SweepResult:
    """Simulate every cell, one batched call per (policy, interval,
    spin-up, horizon) group chunk. Cell order is preserved in the result.
    ``device=None`` runs on the card (scenario cells are realized there
    too). ``checkpoint_dir`` makes the sweep resumable and ``retry`` is a
    `repro_torch.sim.harness.RetryPolicy`."""
    backend = get_backend(backend, device)
    return execute(plan_sweep(cells, n_max=n_max, device=backend.device),
                   backend, checkpoint_dir=checkpoint_dir, retry=retry)


def sweep_events(cells: Iterable[EventCell], n_max: int = 512,
                 w_fpga: int = 32, w_cpu: int = 64,
                 backend: str | Backend | None = None,
                 device: str | torch.device | None = None,
                 checkpoint_dir=None, retry=None) -> EventSweepResult:
    """Event-level (DES) cells in sweep grids: every `EventCell`
    (dispatcher x arrival trace x fleet x objective) runs on the batched
    `events_batched` engine, grouped by entry-stream shape, so a whole
    Table 9 grid is a handful of dispatches. ``device=None`` runs on the
    card, where every arrival block goes through the `arrival` kernel.

    Returns an `EventSweepResult` (cell-ordered totals, each with
    ``breakdown['slot_overflow']``, 0 when the table regions are large
    enough). ``checkpoint_dir`` / ``retry`` harden execution as in
    `sweep`."""
    backend = get_backend(backend, device)
    plan = plan_events(cells, n_max=n_max, w_fpga=w_fpga, w_cpu=w_cpu,
                       device=backend.device)
    return execute(plan, backend, checkpoint_dir=checkpoint_dir, retry=retry)


def sweep_fleet(cells, n_max: int = 512, w_fpga: int = 32, w_cpu: int = 64,
                backend: str | Backend | None = None,
                device: str | torch.device | None = None,
                checkpoint_dir=None, retry=None) -> FleetSweepResult:
    """Multi-tenant fleet cells (`repro_torch.fleet.FleetCell`) in sweep
    grids. Each cell is N tenants sharing ONE fleet under one dispatch
    policy and one admission policy; the batched engine
    (`repro_torch.fleet.engine`) carries the tenant axis beside the DES
    state, so a 1024-tenant x policy grid is a handful of dispatches.
    ``device=None`` runs on the card, where every arrival goes through
    the `arrival` kernel as a block of one.

    Returns a `FleetSweepResult`: cell-ordered fleet `RunTotals` (with
    ``breakdown['offered_requests']`` / ``['shed_requests']``) plus
    per-tenant `repro_torch.core.metrics.TenantTotals` rows via
    ``.tenants(i)``, conservation-checked against the fleet totals by
    the default-on guards (`repro_torch.sim.harness.check_fleet_result`).
    ``checkpoint_dir`` / ``retry`` harden execution as in `sweep`."""
    backend = get_backend(backend, device)
    plan = plan_fleet(cells, n_max=n_max, w_fpga=w_fpga, w_cpu=w_cpu,
                      device=backend.device)
    return execute(plan, backend, checkpoint_dir=checkpoint_dir, retry=retry)


def tune_fpga_dynamic_cells(cells: Iterable[SweepCell], max_k: int = 16,
                            n_max: int | None = None,
                            backend: str | Backend | None = None,
                            device: str | torch.device | None = None,
                            checkpoint_dir=None, retry=None,
                            ) -> list[tuple[int, RunTotals]]:
    """Batched §5.1 headroom tuning: expand every cell into all
    ``max_k + 1`` headroom levels, simulate them in one sweep, and pick
    the least level with zero deadline misses.

    The headroom unit is sized to the max consecutive-interval demand
    delta, so real traces tune at k <= ~2; a cell still missing
    deadlines at max_k falls back to the full serial-equivalent search
    (`ratesim.tune_fpga_dynamic`, k <= 32)."""
    backend = get_backend(backend, device)
    cells = resolve_scenarios(cells, backend.device)
    check_cells(cells)
    K = max_k + 1
    units, expanded = [], []
    for c in cells:
        unit = headroom_unit(c.counts, c.size_s, c.fleet)
        units.append(unit)
        expanded.extend(replace(c, policy="fpga_dynamic", headroom=k * unit)
                        for k in range(K))
    res = sweep(expanded, n_max=n_max, backend=backend,
                checkpoint_dir=checkpoint_dir, retry=retry)
    misses = res.deadline_misses.reshape(len(cells), K)
    out = []
    for ci, c in enumerate(cells):
        zero = np.nonzero(misses[ci] == 0)[0]
        if len(zero):
            k = int(zero[0])
            out.append((k * units[ci], res.totals(ci * K + k)))
        else:
            out.append(tune_fpga_dynamic(c.counts, c.size_s, c.fleet,
                                         n_max=n_max or _N_MAX_CAP,
                                         device=backend.device))
    return out
