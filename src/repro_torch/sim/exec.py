"""Sweep execution: run a `SweepPlan` and scatter rows back.

Port of `repro.sim.exec`. Two backends run a plan's `ChunkDispatch`es:

  * `LocalBackend`: every dispatch on one device (the card unless the
    caller asks for the CPU), one call of `ratesim._simulate_cells`
    (rate), `events_batched._simulate_cells` (event) or
    `fleet.engine._simulate_fleet_cells` (fleet).
  * `MeshBackend`: the cell axis of each dispatch split over several
    devices (`repro_torch.launch.mesh.make_cell_mesh`), one shard and
    one host thread per device, the shards' outputs concatenated in
    shard order. Every cell's result is independent of its shard's size,
    so the result is bit-identical to `LocalBackend`'s.

`execute` routes every dispatch through a
`repro_torch.sim.harness.ResilientRunner` (checkpoint/resume with
``checkpoint_dir=``, bounded retry with backoff and a wall timeout,
mesh -> local degradation on the mesh's first device), scatters each
chunk's rows back into cell order, and runs the invariant guards on the
result unless ``REPRO_SKIP_INVARIANTS`` opts out. Where the sweep runs
is named by ``backend=`` and ``device=`` alone.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.metrics import RunTotals, attribute_tenants
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_cell_mesh
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
    """One way of running a plan's dispatches on ``devices`` (the first
    is ``device``, where plans realize their scenarios and where a
    failing backend degrades to). Subclasses implement `run(dispatch)`,
    returning the batched core's output: an `Accum` of ``(chunk,)``
    tensors (rate), ``(Accum, FailAcc, overflow)`` (event), or those and
    a `fleet.engine.FleetTenantAcc` (fleet)."""

    name = "abstract"

    def __init__(self, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.devices = [self.device]

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def devices_for(self, d: ChunkDispatch) -> int:
        """How many devices dispatch ``d`` spans."""
        return 1

    def run(self, d: ChunkDispatch):
        raise NotImplementedError

    def synchronize(self) -> None:
        """Wait for the work queued on every CUDA device of the backend."""
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def prepare(self, kind: str) -> None:
        """Build the kernels a dispatch of ``kind`` launches on the
        backend's CUDA devices (nothing on the CPU), so that the first
        build runs outside any timed attempt."""
        if not any(dev.type == "cuda" for dev in self.devices):
            return
        from repro_torch.kernels.arrival import ops as arrival_ops
        from repro_torch.kernels.build import build_libraries
        from repro_torch.kernels.spork_predict import ops as predict_ops
        libs = {"spork_predict": predict_ops.SOURCES}
        if kind != "rate":
            libs["arrival"] = arrival_ops.SOURCES
        build_libraries(libs)


class LocalBackend(Backend):
    """Every dispatch on one device, one batched simulator call each."""

    name = "local"

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


def _concat(parts: list, dev: torch.device):
    """Shard outputs (tensors, or tuples / NamedTuples of them)
    concatenated along the cell axis on ``dev``, in shard order."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(dev) for p in parts])
    leaves = [_concat([p[i] for p in parts], dev) for i in range(len(first))]
    return type(first)(*leaves) if hasattr(first, "_fields") \
        else tuple(leaves)


class MeshBackend(Backend):
    """The cell axis of every dispatch split over ``devices`` (default:
    every visible CUDA device, `repro_torch.launch.mesh.make_cell_mesh`).

    Each shard is the dispatch with its arrays sliced along the cell
    axis, run by a `LocalBackend` on its device in a host thread of its
    own; the outputs are concatenated in shard order on the first
    device. A device may appear twice (two shards on one card)."""

    name = "mesh"

    def __init__(self, devices: Sequence | None = None):
        self.devices = make_cell_mesh(devices)
        self.device = self.devices[0]
        self._locals = [LocalBackend(dev) for dev in self.devices]

    def devices_for(self, d: ChunkDispatch) -> int:
        """Largest power-of-two device count that divides the chunk (the
        plan's chunk sizes are powers of two, so this is normally
        min(pow2(n_devices), chunk))."""
        n = 1
        while n * 2 <= len(self.devices) and d.chunk % (n * 2) == 0:
            n *= 2
        return n

    def run(self, d: ChunkDispatch):
        n = self.devices_for(d)
        k = d.chunk // n
        shards = [replace(d, arrays={name: a[s * k:(s + 1) * k]
                                     for name, a in d.arrays.items()},
                          cell_idx=d.cell_idx[s * k:(s + 1) * k], chunk=k)
                  for s in range(n)]

        def run_shard(s: int):
            local = self._locals[s]
            if local.device.type == "cuda":
                with torch.cuda.device(local.device):
                    return local.run(shards[s])
            return local.run(shards[s])

        if n == 1:
            return run_shard(0)
        with ThreadPoolExecutor(max_workers=n) as pool:
            parts = list(pool.map(run_shard, range(n)))
        return _concat(parts, self.device)


def get_backend(backend: str | Backend | None = None,
                device: str | torch.device | None = None) -> Backend:
    """Resolve a backend: an instance passes through (``device`` is then
    ignored); ``None`` or ``"local"`` builds a `LocalBackend` on
    ``device``; ``"mesh"`` builds a `MeshBackend` over every visible CUDA
    device, or over ``device`` alone when one is named."""
    if isinstance(backend, Backend):
        return backend
    if backend in (None, "local"):
        return LocalBackend(device)
    if backend == "mesh":
        return MeshBackend(None if device is None else [device])
    raise ValueError(f"unknown sweep backend {backend!r} "
                     f"(expected 'local' or 'mesh')")


def execute(plan: SweepPlan, backend: str | Backend | None = None,
            device: str | torch.device | None = None, *,
            checkpoint_dir=None, retry=None, validate: bool | None = None,
            ) -> SweepResult | EventSweepResult | FleetSweepResult:
    """Run every dispatch of a plan and scatter the rows back into cell
    order: a `SweepResult` for rate plans, an `EventSweepResult` for event
    plans, a `FleetSweepResult` for fleet plans. Each carries
    ``n_dispatches``, the backend's name, device, ``n_devices`` and
    per-dispatch device counts, and in ``meta`` the
    `repro_torch.sim.harness.ResilientRunner` record.

    ``checkpoint_dir`` persists each completed chunk, so a killed run
    restarted with the same directory re-executes only the unfinished
    chunks, bit-identically; ``retry`` is a `RetryPolicy` (bounded
    retry + backoff, per-chunk wall timeout, mesh -> local degradation);
    the invariant guards validate the result unless ``validate`` is
    False, or ``validate`` is None and ``REPRO_SKIP_INVARIANTS`` opts
    out."""
    from repro_torch.sim.harness import (ResilientRunner, check_sweep_result,
                                         invariants_enabled)
    backend = get_backend(backend, device)
    runner = ResilientRunner(backend, checkpoint_dir=checkpoint_dir,
                             retry=retry)
    if plan.kind == "rate":
        res = _execute_rate(plan, backend, runner)
    elif plan.kind == "event":
        res = _execute_event(plan, backend, runner)
    elif plan.kind == "fleet":
        res = _execute_fleet(plan, backend, runner)
    else:
        raise ValueError(f"unknown plan kind {plan.kind!r}")
    res.meta.update(runner.meta())
    if invariants_enabled() if validate is None else validate:
        check_sweep_result(res)
    return res


def _where(plan: SweepPlan, backend: Backend) -> dict:
    """The result's record of where the plan ran."""
    return {"n_dispatches": plan.n_dispatches, "backend": backend.name,
            "device": str(backend.device), "n_devices": backend.n_devices,
            "dispatch_devices": [backend.devices_for(d)
                                 for d in plan.dispatches]}


def _execute_rate(plan: SweepPlan, backend: Backend, runner) -> SweepResult:
    n = len(plan.cells)
    leaves = np.zeros((len(ratesim.Accum._fields), n), np.float64)
    for d in plan.dispatches:
        acc = ratesim.accum_numpy(runner.run(d))
        leaves[:, list(d.cell_idx)] = np.stack(acc)[:, :d.n_real]
    return SweepResult(plan.cells, ratesim.Accum(*leaves), plan.work,
                       plan.requests, **_where(plan, backend))


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


def _execute_event(plan: SweepPlan, backend: Backend,
                   runner) -> EventSweepResult:
    out: list[RunTotals | None] = [None] * len(plan.cells)
    for d in plan.dispatches:
        acc_np, fail_np, over_np = _host(*runner.run(d))
        for r, i in enumerate(d.cell_idx):
            cell = plan.cells[i]
            n_req = len(cell.arrival_times)
            out[i] = _event_totals(acc_np, fail_np, over_np, r,
                                   n_req * cell.size_s, n_req)
    return EventSweepResult(plan.cells, out, **_where(plan, backend))


def _execute_fleet(plan: SweepPlan, backend: Backend,
                   runner) -> FleetSweepResult:
    """Scatter fleet-dispatch outputs into per-cell fleet `RunTotals` +
    per-tenant `TenantTotals` rows. Conservation is by construction: the
    fleet-level requests / work / misses / work split are computed from
    the per-tenant accumulators themselves (then energy/cost are
    attributed back out of the fleet totals), so the tenant rows always
    reconcile."""
    out: list[RunTotals | None] = [None] * len(plan.cells)
    tenants: list[list | None] = [None] * len(plan.cells)
    for d in plan.dispatches:
        acc, fail, over, fa = runner.run(d)
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
                            **_where(plan, backend))
