"""Sweep execution: run a `SweepPlan` and scatter rows back.

Port of `repro.sim.exec` for rate and event plans. `LocalBackend` runs
every `ChunkDispatch` of a plan through `ratesim._simulate_cells` (rate)
or `events_batched._simulate_cells` (event) on one device (the card
unless the caller asks for the CPU), and `execute` scatters each chunk's
rows back into cell order.

Not ported yet (slice 6 of ROADMAP.md): the checkpoint/resume and retry
harness (`repro.sim.harness.ResilientRunner`), the default-on invariant
guards, and `MeshBackend`, which shards the cell axis over several
devices. The fleet plan kind waits for its own slice.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.metrics import RunTotals
from repro_torch.device import resolve_device
from repro_torch.policies import RateParams
from repro_torch.sim import events_batched, ratesim
from repro_torch.sim.plan import (ChunkDispatch, EventSweepResult, SweepPlan,
                                  SweepResult)


def _rate_args(d: ChunkDispatch, dev: torch.device) -> tuple:
    """Tensor arguments for `ratesim._simulate_cells`, in order."""
    a = d.arrays
    t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=dev)  # noqa: E731
    scal = t(a["scalars"], torch.float32)
    fs = ratesim.FleetScalars(*(scal[:, j].contiguous()
                                for j in range(scal.shape[1])))
    params = RateParams(t(a["headroom"], torch.int32),
                        t(a["levels"], torch.int32),
                        t(a["gain"], torch.float32))
    return (t(a["counts"], torch.int32), t(a["sizes"], torch.float32), fs,
            t(a["energy_weight"], torch.float32), params)


def _event_args(d: ChunkDispatch, dev: torch.device) -> tuple:
    """Tensor arguments for `events_batched._simulate_cells`, in order.
    The ``scalars`` matrix holds every float field of `EventScalars`
    (incl. the 8 failure knobs); the uint32 hash seed (as int64) and the
    int/bool fields ride as separate arrays."""
    a = d.arrays
    t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=dev)  # noqa: E731
    scal = t(a["scalars"], torch.float32)
    es = events_batched.EventScalars(
        *(scal[:, j].contiguous() for j in range(scal.shape[1])),
        f_seed=t(a["fail_seed"].astype(np.int64), torch.int64),
        max_fpgas=t(a["max_fpgas"], torch.int32),
        allocate=t(a["allocate"], torch.bool))
    return (es, t(a["codes"], torch.int32), t(a["times"], torch.float32),
            t(a["tick_t"], torch.float32), t(a["is_tick"], torch.bool))


class Backend:
    """One way of running a plan's dispatches. Subclasses implement
    `run(dispatch)`, returning the batched core's output: an `Accum` of
    ``(chunk,)`` tensors (rate) or ``(Accum, FailAcc, overflow)``
    (event)."""

    name = "abstract"

    def run(self, d: ChunkDispatch):
        raise NotImplementedError


class LocalBackend(Backend):
    """Every dispatch on one device, one batched simulator call each."""

    name = "local"

    def __init__(self, device: str | torch.device | None = None):
        self.device = resolve_device(device)

    def run(self, d: ChunkDispatch):
        if d.kind == "rate":
            return ratesim._simulate_cells(*d.static,
                                           *_rate_args(d, self.device))
        if d.kind == "event":
            return events_batched._simulate_cells(
                *d.static, *_event_args(d, self.device))
        raise NotImplementedError(f"{d.kind!r} dispatches are not ported yet")


def get_backend(backend: str | Backend | None = None,
                device: str | torch.device | None = None) -> Backend:
    """Resolve a backend: an instance passes through (``device`` is then
    ignored); ``None`` or ``"local"`` builds a `LocalBackend` on
    ``device``."""
    if isinstance(backend, Backend):
        return backend
    if backend not in (None, "local"):
        raise ValueError(f"unknown sweep backend {backend!r} (expected "
                         f"'local'; the mesh backend is not ported yet)")
    return LocalBackend(device)


def execute(plan: SweepPlan, backend: str | Backend | None = None,
            device: str | torch.device | None = None,
            ) -> SweepResult | EventSweepResult:
    """Run every dispatch of a plan and scatter the rows back into cell
    order: a `SweepResult` for rate plans, an `EventSweepResult` for event
    plans. Each dispatch's outputs come to the host in one transfer after
    its simulator call."""
    backend = get_backend(backend, device)
    if plan.kind == "event":
        return _execute_event(plan, backend)
    if plan.kind != "rate":
        raise NotImplementedError(f"{plan.kind!r} plans are not ported yet")
    n = len(plan.cells)
    leaves = np.zeros((len(ratesim.Accum._fields), n), np.float64)
    for d in plan.dispatches:
        acc = ratesim.accum_numpy(backend.run(d))
        leaves[:, list(d.cell_idx)] = np.stack(acc)[:, :d.n_real]
    return SweepResult(plan.cells, ratesim.Accum(*leaves), plan.work,
                       plan.requests, n_dispatches=plan.n_dispatches,
                       backend=backend.name,
                       device=str(getattr(backend, "device", "")))


def _execute_event(plan: SweepPlan, backend: Backend) -> EventSweepResult:
    out: list[RunTotals | None] = [None] * len(plan.cells)
    for d in plan.dispatches:
        acc, fail, over = backend.run(d)
        acc_np = ratesim.accum_numpy(acc)
        # int32 counters and float32 sums, all exact in float64
        fail_np = events_batched.FailAcc(
            *torch.stack([x.to(torch.float64) for x in fail]).cpu().numpy())
        over_np = over.cpu().numpy()
        for r, i in enumerate(d.cell_idx):
            cell = plan.cells[i]
            n_req = len(cell.arrival_times)
            tot = ratesim.accum_to_totals(
                ratesim.Accum(*[leaf[r] for leaf in acc_np]),
                n_req * cell.size_s, n_req)
            fl = events_batched.FailAcc(*[leaf[r] for leaf in fail_np])
            # resilience counters + the oracle's finalize composition:
            # wasted spin-up energy joins energy_j, stillborn occupancy
            # joins cost_usd (all exactly zero when the axis is off)
            tot.retries = int(fl.retries)
            tot.failed_spinups = int(fl.failed_spins)
            tot.crashes = int(fl.crashes)
            tot.recovered_requests = int(fl.recovered)
            tot.failure_misses = int(fl.fail_misses)
            tot.wasted_spinup_j = float(fl.wasted_j)
            tot.energy_j += float(fl.wasted_j)
            tot.cost_usd += float(fl.extra_cost)
            tot.breakdown["slot_overflow"] = int(over_np[r])
            out[i] = tot
    return EventSweepResult(plan.cells, out, n_dispatches=plan.n_dispatches,
                            backend=backend.name,
                            device=str(getattr(backend, "device", "")))
