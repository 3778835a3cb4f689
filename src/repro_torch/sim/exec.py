"""Sweep execution: run a `SweepPlan` and scatter rows back.

Port of `repro.sim.exec`. `LocalBackend` runs every `ChunkDispatch` of
a plan through `ratesim._simulate_cells` (rate),
`events_batched._simulate_cells` (event) or
`fleet.engine._simulate_fleet_cells` (fleet) on one device (the card
unless the caller asks for the CPU), and `execute` scatters each chunk's
rows back into cell order.

Not ported yet (slice 6 of ROADMAP.md): the checkpoint/resume and retry
harness (`repro.sim.harness.ResilientRunner`), the default-on invariant
guards (`check_fleet_result` among them), and `MeshBackend`, which
shards the cell axis over several devices.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.metrics import RunTotals, attribute_tenants
from repro_torch.device import resolve_device
from repro_torch.policies import RateParams
from repro_torch.sim import events_batched, ratesim
from repro_torch.sim.plan import (ChunkDispatch, EventSweepResult,
                                  FleetSweepResult, SweepPlan, SweepResult)


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


def _fleet_args(d: ChunkDispatch, dev: torch.device) -> tuple:
    """Tensor arguments for `fleet.engine._simulate_fleet_cells`, in
    order: the event layout (`_event_args`) plus the tenant axis —
    per-arrival tenant indices, the padded per-tenant size/deadline/
    admission tables — and, from the host times, how many slots of each
    entry hold a real arrival in some cell."""
    a = d.arrays
    t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=dev)  # noqa: E731
    es, codes, times, tick_t, is_tick = _event_args(d, dev)
    slots = np.isfinite(a["times"]).sum(axis=2).max(axis=0).tolist()
    return (es, codes, t(a["acodes"], torch.int32), times,
            t(a["tids"], torch.int32), tick_t, is_tick,
            t(a["ta_size"], torch.float32), t(a["ta_deadline"], torch.float32),
            t(a["adm_rate"], torch.float32), t(a["adm_burst"], torch.float32),
            t(a["adm_quota"], torch.float32), slots)


class Backend:
    """One way of running a plan's dispatches. Subclasses implement
    `run(dispatch)`, returning the batched core's output: an `Accum` of
    ``(chunk,)`` tensors (rate), ``(Accum, FailAcc, overflow)`` (event),
    or those and a `fleet.engine.FleetTenantAcc` (fleet)."""

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
        if d.kind == "fleet":
            from repro_torch.fleet import engine as fleet_engine
            return fleet_engine._simulate_fleet_cells(
                *d.static, *_fleet_args(d, self.device))
        raise ValueError(f"unknown dispatch kind {d.kind!r}")


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
            ) -> SweepResult | EventSweepResult | FleetSweepResult:
    """Run every dispatch of a plan and scatter the rows back into cell
    order: a `SweepResult` for rate plans, an `EventSweepResult` for event
    plans, a `FleetSweepResult` for fleet plans. Each dispatch's outputs
    come to the host in one transfer after its simulator call."""
    backend = get_backend(backend, device)
    if plan.kind == "event":
        return _execute_event(plan, backend)
    if plan.kind == "fleet":
        return _execute_fleet(plan, backend)
    if plan.kind != "rate":
        raise ValueError(f"unknown plan kind {plan.kind!r}")
    n = len(plan.cells)
    leaves = np.zeros((len(ratesim.Accum._fields), n), np.float64)
    for d in plan.dispatches:
        acc = ratesim.accum_numpy(backend.run(d))
        leaves[:, list(d.cell_idx)] = np.stack(acc)[:, :d.n_real]
    return SweepResult(plan.cells, ratesim.Accum(*leaves), plan.work,
                       plan.requests, n_dispatches=plan.n_dispatches,
                       backend=backend.name,
                       device=str(getattr(backend, "device", "")))


def _event_totals(acc_np, fail_np, over_np, r: int, work: float,
                  requests: int) -> RunTotals:
    """Row ``r`` of one event or fleet dispatch's host outputs as
    `RunTotals`, with the resilience counters and the oracle's finalize
    composition: wasted spin-up energy joins energy_j, stillborn
    occupancy joins cost_usd (all exactly zero when the axis is off)."""
    tot = ratesim.accum_to_totals(
        ratesim.Accum(*[leaf[r] for leaf in acc_np]), work, requests)
    fl = events_batched.FailAcc(*[leaf[r] for leaf in fail_np])
    tot.retries = int(fl.retries)
    tot.failed_spinups = int(fl.failed_spins)
    tot.crashes = int(fl.crashes)
    tot.recovered_requests = int(fl.recovered)
    tot.failure_misses = int(fl.fail_misses)
    tot.wasted_spinup_j = float(fl.wasted_j)
    tot.energy_j += float(fl.wasted_j)
    tot.cost_usd += float(fl.extra_cost)
    tot.breakdown["slot_overflow"] = int(over_np[r])
    return tot


def _host(acc, fail, over) -> tuple:
    """A dispatch's ``(Accum, FailAcc, overflow)`` on the host: int32
    counters and float32 sums, all exact in float64."""
    fail_np = events_batched.FailAcc(
        *torch.stack([x.to(torch.float64) for x in fail]).cpu().numpy())
    return ratesim.accum_numpy(acc), fail_np, over.cpu().numpy()


def _execute_event(plan: SweepPlan, backend: Backend) -> EventSweepResult:
    out: list[RunTotals | None] = [None] * len(plan.cells)
    for d in plan.dispatches:
        acc_np, fail_np, over_np = _host(*backend.run(d))
        for r, i in enumerate(d.cell_idx):
            cell = plan.cells[i]
            n_req = len(cell.arrival_times)
            out[i] = _event_totals(acc_np, fail_np, over_np, r,
                                   n_req * cell.size_s, n_req)
    return EventSweepResult(plan.cells, out, n_dispatches=plan.n_dispatches,
                            backend=backend.name,
                            device=str(getattr(backend, "device", "")))


def _execute_fleet(plan: SweepPlan, backend: Backend) -> FleetSweepResult:
    """Scatter fleet-dispatch outputs into per-cell fleet `RunTotals` +
    per-tenant `TenantTotals` rows. Conservation is by construction: the
    fleet-level requests / work / misses / work split are computed from
    the per-tenant accumulators themselves (then energy/cost are
    attributed back out of the fleet totals), so the tenant rows always
    reconcile."""
    out: list[RunTotals | None] = [None] * len(plan.cells)
    tenants: list[list | None] = [None] * len(plan.cells)
    for d in plan.dispatches:
        acc, fail, over, fa = backend.run(d)
        acc_np, fail_np, over_np = _host(acc, fail, over)
        fa_np = [x.cpu().numpy() for x in fa]
        for r, i in enumerate(d.cell_idx):
            rs = plan.meta["resolved"][i]
            n = rs.n_tenants
            offered, admitted, shed, missed, work_f, work_c = (
                leaf[r, :n] for leaf in fa_np)
            tot = _event_totals(acc_np, fail_np, over_np, r,
                                float((admitted * rs.sizes).sum()),
                                int(admitted.sum()))
            # per-tenant sums ARE the fleet-level numbers (each arrival
            # increments exactly one tenant's counter and the matching
            # shared counter)
            tot.deadline_misses = int(missed.sum())
            tot.work_on_fpga_cpu_s = float(work_f.sum())
            tot.work_on_cpu_cpu_s = float(work_c.sum())
            tot.breakdown["offered_requests"] = int(offered.sum())
            tot.breakdown["shed_requests"] = int(shed.sum())
            out[i] = tot
            tenants[i] = attribute_tenants(
                tot, rs.weights, rs.sizes, offered, admitted, shed, missed,
                work_f, work_c)
    return FleetSweepResult(plan.cells, out, tenants,
                            n_dispatches=plan.n_dispatches,
                            backend=backend.name,
                            device=str(getattr(backend, "device", "")))
