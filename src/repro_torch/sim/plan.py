"""Sweep planning: cell lists -> explicit, testable dispatch plans.

Port of `repro.sim.plan`. `plan_sweep(cells)` turns a list of
`repro_torch.sim.sweep.SweepCell` into a `SweepPlan`, `plan_events(cells)`
a list of `repro_torch.sim.events_batched.EventCell`, and
`plan_fleet(cells)` a list of multi-tenant `repro_torch.fleet.FleetCell`:
scenario resolution, group keys, chunk shapes, padding and result
scatter indices, all computed host-side. Each `ChunkDispatch` names the
static arguments of one batched simulator call plus the padded host
arrays (cell axis first) and the cell indices its rows scatter back to.

Invariants (held by tests/test_torch_sweep.py,
tests/test_torch_events_batched.py and tests/test_torch_fleet.py):

  * the ``cell_idx`` lists concatenate to a permutation of
    ``range(len(cells))`` — each cell is dispatched exactly once;
  * padding repeats row 0 of each chunk (padded rows are discarded by
    the scatter);
  * rate chunks are exactly CHUNK or CHUNK_BIG cells; event and fleet
    chunks are powers of two in [4, EV_CHUNK_MAX].

Cells that name a workload scenario (``scenario=``) without explicit
demand are resolved first (`resolve_scenarios`): their demand is
realized on ``device`` (None: the card), one synthesis per distinct
spec. Failure-bearing rate cells run as their degraded-fleet equivalent
(`FailureSpec.degrade_fleet`), as in the reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Any, Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.metrics import Report, RunTotals, report
from repro_torch.core.workers import FleetParams
from repro_torch.ft.failures import fail_static
from repro_torch.policies import (get_admission_policy, get_dispatch_policy,
                                  get_rate_policy)
from repro_torch.sim.events_batched import (BLOCK, EV_CHUNK_MAX, _entries,
                                            _pad_pow2, _scalars)
from repro_torch.sim.ratesim import (Accum, accum_to_totals,
                                     fleet_scalars_np, static_level_for)

# Cells per dispatch. Every chunk is padded to one of exactly two shapes
# (small grids -> CHUNK, expanded grids like headroom tuning -> rounds of
# CHUNK_BIG), as in the reference; a padded-out cell costs little.
CHUNK = 32
CHUNK_BIG = 256

_N_MAX_CAP = 512

# Policies whose dynamics are independent of the scheduling interval and
# FPGA spin-up latency (`latency_free`) are regrouped under one canonical
# static key so every spin-up value shares a group.
_CANON_INTERVAL = 10


def resolve_scenarios(cells: Sequence,
                      device: str | torch.device | None = None) -> list:
    """Materialize demand for scenario-bearing cells (SweepCell or
    EventCell): cells whose ``counts`` / ``arrival_times`` is None get it
    synthesized from their ``scenario`` spec on ``device`` (None: the
    card) — ONE synthesis per distinct spec
    (`repro_torch.workloads.scenarios.realize`, shared across seeds and
    cached). Event arrival streams additionally hit the per-(spec, seed)
    cache (`repro_torch.workloads.scenarios.scenario_arrivals`). Cells
    with explicit demand pass through untouched; cell order is
    preserved. A chaos scenario's ``failures`` is inherited unless the
    cell pins its own."""
    out = list(cells)
    is_event = [hasattr(c, "arrival_times") for c in out]
    pending: dict[Any, list[int]] = {}
    for i, c in enumerate(out):
        demand = c.arrival_times if is_event[i] else c.counts
        if demand is not None:
            continue
        if c.scenario is None:
            raise ValueError(
                f"{type(c).__name__} needs explicit demand or a scenario: "
                f"explicit counts and size_s, or scenario=")
        pending.setdefault(c.scenario, []).append(i)
    if not pending:
        return out
    from repro_torch.workloads.scenarios import (scenario_arrivals,
                                                 scenario_traces)
    for spec, idxs in pending.items():
        seeds = sorted({out[i].seed for i in idxs})
        by_seed = dict(zip(seeds, scenario_traces(spec, seeds, device)))
        for i in idxs:
            c, tr = out[i], by_seed[out[i].seed]
            size = tr.request_size_s if c.size_s is None else c.size_s
            fail = (c.failures if c.failures is not None
                    else getattr(spec, "failures", None))
            if is_event[i]:
                out[i] = replace(c,
                                 arrival_times=scenario_arrivals(
                                     spec, c.seed, _trace=tr, device=device),
                                 size_s=size,
                                 horizon_s=(float(spec.horizon_s)
                                            if c.horizon_s is None
                                            else c.horizon_s),
                                 failures=fail)
            else:
                out[i] = replace(c, counts=tr.counts, size_s=size,
                                 failures=fail)
    return out


def check_cells(cells: Sequence) -> None:
    """Reject rate cells without explicit demand (`resolve_scenarios`
    resolves scenario cells first)."""
    for c in cells:
        if c.counts is None or c.size_s is None:
            raise ValueError(
                "SweepCell needs explicit demand or a scenario: explicit "
                "counts and size_s, or scenario=")


def _pad(arr: np.ndarray, n: int) -> np.ndarray:
    """Pad the leading axis to n by repeating row 0 (results discarded)."""
    if arr.shape[0] == n:
        return arr
    reps = np.repeat(arr[:1], n - arr.shape[0], axis=0)
    return np.concatenate([arr, reps], axis=0)


@dataclass(frozen=True)
class ChunkDispatch:
    """One batched simulator call of a plan: its static arguments
    ``(policy, interval_s, spin_up_s, n_max, horizon)``, the padded host
    arrays it consumes (every array carries the ``chunk``-long cell axis
    first), and the scatter map from its real rows back to plan cell
    indices."""

    kind: str                       # "rate" | "event" | "fleet"
    static: tuple                   # static args of the batched core
    arrays: dict[str, np.ndarray]   # padded inputs, leading axis == chunk
    cell_idx: tuple[int, ...]       # row r (< n_real) -> cells[cell_idx[r]]
    chunk: int                      # padded leading-axis length

    @property
    def n_real(self) -> int:
        return len(self.cell_idx)


@dataclass
class SweepPlan:
    """An explicit sweep execution plan: the cells (in caller order) plus
    the dispatch list; ``work``/``requests`` are per-cell totals
    precomputed during planning."""

    kind: str                       # "rate" | "event" | "fleet"
    cells: list
    dispatches: list[ChunkDispatch]
    n_max: int
    work: np.ndarray | None = None          # (n_cells,) f64, rate only
    requests: np.ndarray | None = None      # (n_cells,) i64, rate only
    meta: dict = field(default_factory=dict)

    @property
    def n_dispatches(self) -> int:
        return len(self.dispatches)


def plan_sweep(cells: Iterable, n_max: int | None = None,
               device: str | torch.device | None = None) -> SweepPlan:
    """Plan a rate-simulator sweep: one `ChunkDispatch` per (policy,
    interval, spin-up, horizon) group chunk, arrays laid out exactly as
    `ratesim._simulate_cells` consumes them. Scenario-bearing cells are
    resolved first, on ``device`` (`resolve_scenarios`).

    The rate simulator has no per-worker identity, so failure-bearing
    cells are *fluidized* here: `FailureSpec.degrade_fleet` folds the
    expected failure overheads into the fleet parameters and the cell's
    ``failures`` is cleared (the plan's cells record what was simulated).
    The DES engines are the exact path."""
    cells = resolve_scenarios(cells, device)
    check_cells(cells)
    cells = [c if c.failures is None or c.failures.normalized() is None
             else replace(c, fleet=c.failures.degrade_fleet(c.fleet),
                          failures=None)
             for c in cells]
    groups: dict[tuple, list[int]] = {}
    for i, c in enumerate(cells):
        # the policy OBJECT (frozen dataclass: hashable) is the group key
        # and rides through `ChunkDispatch.static`
        pol = get_rate_policy(c.policy)
        interval_s = max(int(round(c.fleet.T_s)), 1)
        spin_up_s = max(int(round(c.fleet.fpga.spin_up_s)), 1)
        horizon = (len(c.counts) // interval_s) * interval_s
        if pol.latency_free and horizon % _CANON_INTERVAL == 0:
            interval_s = spin_up_s = _CANON_INTERVAL
        groups.setdefault((pol, interval_s, spin_up_s, horizon,
                           n_max or _N_MAX_CAP), []).append(i)

    n = len(cells)
    work = np.zeros((n,), np.float64)
    requests = np.zeros((n,), np.int64)
    dispatches: list[ChunkDispatch] = []

    for (pol, interval_s, spin_up_s, horizon, nm), idxs in groups.items():
        group = [cells[i] for i in idxs]
        counts = np.stack([np.asarray(c.counts[:horizon], np.int32)
                           for c in group])
        sizes = np.array([c.size_s for c in group], np.float32)
        ew = np.array([c.energy_weight for c in group], np.float32)
        hr = np.array([c.headroom for c in group], np.int32)
        gain = np.array([c.forecast_gain for c in group], np.float32)
        scal = np.stack([fleet_scalars_np(c.fleet) for c in group])
        if pol.name == "fpga_static":
            levels = np.array(
                [static_level_for(c.counts[:horizon], c.size_s, c.fleet, nm)
                 for c in group], np.int32)
        else:
            levels = np.zeros((len(group),), np.int32)

        work[idxs] = counts.sum(1, dtype=np.float64) * sizes
        requests[idxs] = counts.sum(1, dtype=np.int64)

        start = 0
        while start < len(group):
            left = len(group) - start
            # Predictor policies carry O(n_max^2) histogram state per
            # cell, so they always use the small shape; cheap policies
            # jump to the big shape for expanded grids (headroom tuning).
            chunk = CHUNK if pol.uses_predictor or left <= CHUNK else CHUNK_BIG
            sl = slice(start, min(start + chunk, len(group)))
            start += chunk
            arrays = {
                "counts": _pad(counts[sl], chunk),
                "sizes": _pad(sizes[sl], chunk),
                "scalars": _pad(scal[sl], chunk),
                "energy_weight": _pad(ew[sl], chunk),
                "headroom": _pad(hr[sl], chunk),
                "levels": _pad(levels[sl], chunk),
                "gain": _pad(gain[sl], chunk),
            }
            dispatches.append(ChunkDispatch(
                kind="rate",
                static=(pol, interval_s, spin_up_s, nm, horizon),
                arrays=arrays, cell_idx=tuple(idxs[sl.start:sl.stop]),
                chunk=chunk))

    return SweepPlan("rate", cells, dispatches, n_max or _N_MAX_CAP,
                     work=work, requests=requests)


def plan_events(cells: Iterable, n_max: int = 512, w_fpga: int = 32,
                w_cpu: int = 64, resolve: bool = True,
                device: str | torch.device | None = None) -> SweepPlan:
    """Plan a DES sweep: cells grouped by (padded entry-stream length,
    static failure key), one `ChunkDispatch` per group chunk, arrays laid
    out exactly as `events_batched._simulate_cells` consumes them.
    Scenario-bearing cells are resolved first, on ``device``;
    ``resolve=False`` requires every cell to carry explicit demand
    (``arrival_times`` + ``size_s``) already.

    Every chunk's padded entry-stream arrays (``chunk x E x BLOCK``
    float32) are materialized up front, so host memory is proportional
    to the whole sweep (~0.15 GB for the full Table 9 grid)."""
    cells = resolve_scenarios(cells, device) if resolve else list(cells)
    codes = {}
    for i, cl in enumerate(cells):
        codes[i] = get_dispatch_policy(cl.dispatcher).code
        if cl.arrival_times is None or cl.size_s is None:
            raise ValueError(
                "EventCell needs explicit arrival_times and size_s; "
                "scenario-bearing cells go through sweep_events, which "
                "resolves them")
    entries: dict[int, list] = {}
    groups: dict[tuple, list[int]] = {}
    for i, cl in enumerate(cells):
        arr = np.asarray(cl.arrival_times, np.float64)
        horizon = float(cl.horizon_s if cl.horizon_s is not None
                        else (arr[-1] + 1.0 if len(arr) else 1.0))
        entries[i] = _entries(arr, cl.fleet.T_s, horizon)
        n_e = len(entries[i])
        # pow2 up to 256 entries, then multiples of 256: every padded
        # entry costs a full BLOCK of inert arrival slots
        E = (_pad_pow2(n_e, lo=4) if n_e <= 256
             else 256 * int(math.ceil(n_e / 256)))
        groups.setdefault((E, fail_static(cl.failures)), []).append(i)

    dispatches: list[ChunkDispatch] = []
    for (E, fstat), idxs in groups.items():
        chunk = _pad_pow2(len(idxs), lo=4, hi=EV_CHUNK_MAX)
        start = 0
        while start < len(idxs):
            sl = idxs[start:start + chunk]
            start += chunk
            pad = sl + [sl[0]] * (chunk - len(sl))
            times = np.full((len(pad), E, BLOCK), np.inf, np.float32)
            tick_t = np.zeros((len(pad), E), np.float32)
            is_tick = np.zeros((len(pad), E), bool)
            for r, i in enumerate(pad):
                for e, (row, tick) in enumerate(entries[i]):
                    times[r, e, :len(row)] = row
                    if tick is not None:
                        tick_t[r, e] = tick
                        is_tick[r, e] = True
            arrays = {
                "scalars": np.array([_scalars(cells[i])[:-2] for i in pad],
                                    np.float32),
                "fail_seed": np.array(
                    [(cells[i].failures.seed
                      if cells[i].failures is not None else 0)
                     for i in pad], np.uint32),
                "max_fpgas": np.array([cells[i].fleet.max_fpgas
                                       for i in pad], np.int32),
                "allocate": np.array([cells[i].allocate_fpgas
                                      for i in pad], bool),
                "codes": np.array([codes[i] for i in pad], np.int32),
                "times": times, "tick_t": tick_t, "is_tick": is_tick,
            }
            dispatches.append(ChunkDispatch(
                kind="event", static=(n_max, w_fpga, w_cpu, fstat),
                arrays=arrays, cell_idx=tuple(sl), chunk=chunk))

    return SweepPlan("event", cells, dispatches, n_max)


def plan_fleet(cells: Iterable, n_max: int = 512, w_fpga: int = 32,
               w_cpu: int = 64,
               device: str | torch.device | None = None) -> SweepPlan:
    """Plan a multi-tenant fleet sweep (`repro_torch.fleet.FleetCell`
    cells): the DES plan machinery of `plan_events` with a tenant axis —
    each cell's merged tenant-tagged stream
    (`repro_torch.fleet.resolve_fleet_cell`, scenario tenants realized on
    ``device``) becomes ``times`` + ``tids`` entry blocks, and per-tenant
    size/deadline/admission tables ride along padded to a power-of-two
    tenant count. Groups key on (padded entry count, padded tenant
    count, failure static), so every admission policy of one population
    shares a dispatch. ``meta["resolved"]`` holds each cell's
    `ResolvedFleet`.

    Execution: `repro_torch.sim.exec` routes ``kind="fleet"`` dispatches
    to `repro_torch.fleet.engine`; `repro_torch.sim.sweep.sweep_fleet` is
    the plan + execute wrapper returning a `FleetSweepResult`."""
    from repro_torch.fleet.specs import FleetCell, resolve_fleet_cell
    from repro_torch.sim.events_batched import EventCell

    cells = list(cells)
    entries: dict[int, list] = {}
    resolved: list = []
    groups: dict[tuple, list[int]] = {}
    codes, acodes = {}, {}
    for i, cl in enumerate(cells):
        if not isinstance(cl, FleetCell):
            raise TypeError(
                f"plan_fleet needs repro_torch.fleet.FleetCell cells, got "
                f"{type(cl).__name__}")
        rs = resolve_fleet_cell(cl, device)
        resolved.append(rs)
        codes[i] = get_dispatch_policy(cl.dispatcher).code
        acodes[i] = get_admission_policy(cl.admission).code
        entries[i] = _entries(rs.times, cl.fleet.T_s, rs.horizon_s,
                              payload=rs.tids)
        n_e = len(entries[i])
        E = (_pad_pow2(n_e, lo=4) if n_e <= 256
             else 256 * int(math.ceil(n_e / 256)))
        N_pad = _pad_pow2(rs.n_tenants, lo=4)
        groups.setdefault((E, N_pad, fail_static(rs.failures)),
                          []).append(i)

    def _proxy(i: int) -> EventCell:
        # an EventCell twin carrying the cell's fleet/objective axes so
        # `_scalars` stays the single source of truth; size/deadline are
        # tenant 0's (swapped per arrival from the tenant tables)
        cl, rs = cells[i], resolved[i]
        return EventCell(dispatcher=cl.dispatcher,
                         size_s=float(rs.sizes[0]), fleet=cl.fleet,
                         energy_weight=cl.energy_weight,
                         deadline_s=float(rs.deadlines[0]),
                         allocate_fpgas=cl.allocate_fpgas,
                         failures=rs.failures)

    def _tenant_table(i: int, n_pad: int) -> np.ndarray:
        # (5, N_pad) f32 rows: size, deadline, adm_rate/burst/quota.
        # Padded tenant slots are never referenced by any tid; 1.0
        # size/deadline keeps them valid scalar values.
        rs = resolved[i]
        tbl = np.zeros((5, n_pad), np.float32)
        tbl[0, :] = tbl[1, :] = 1.0
        n = rs.n_tenants
        tbl[0, :n] = rs.sizes
        tbl[1, :n] = rs.deadlines
        tbl[2, :n] = rs.adm_rate
        tbl[3, :n] = rs.adm_burst
        tbl[4, :n] = rs.adm_quota
        return tbl

    dispatches: list[ChunkDispatch] = []
    for (E, N_pad, fstat), idxs in groups.items():
        chunk = _pad_pow2(len(idxs), lo=4, hi=EV_CHUNK_MAX)
        start = 0
        while start < len(idxs):
            sl = idxs[start:start + chunk]
            start += chunk
            pad = sl + [sl[0]] * (chunk - len(sl))
            times = np.full((len(pad), E, BLOCK), np.inf, np.float32)
            tids = np.zeros((len(pad), E, BLOCK), np.int32)
            tick_t = np.zeros((len(pad), E), np.float32)
            is_tick = np.zeros((len(pad), E), bool)
            for r, i in enumerate(pad):
                for e, (row, prow, tick) in enumerate(entries[i]):
                    times[r, e, :len(row)] = row
                    tids[r, e, :len(prow)] = prow
                    if tick is not None:
                        tick_t[r, e] = tick
                        is_tick[r, e] = True
            tables = np.stack([_tenant_table(i, N_pad) for i in pad])
            arrays = {
                "scalars": np.array([_scalars(_proxy(i))[:-2] for i in pad],
                                    np.float32),
                "fail_seed": np.array(
                    [(resolved[i].failures.seed
                      if resolved[i].failures is not None else 0)
                     for i in pad], np.uint32),
                "max_fpgas": np.array([cells[i].fleet.max_fpgas
                                       for i in pad], np.int32),
                "allocate": np.array([cells[i].allocate_fpgas
                                      for i in pad], bool),
                "codes": np.array([codes[i] for i in pad], np.int32),
                "acodes": np.array([acodes[i] for i in pad], np.int32),
                "times": times, "tids": tids,
                "tick_t": tick_t, "is_tick": is_tick,
                "ta_size": tables[:, 0], "ta_deadline": tables[:, 1],
                "adm_rate": tables[:, 2], "adm_burst": tables[:, 3],
                "adm_quota": tables[:, 4],
            }
            dispatches.append(ChunkDispatch(
                kind="fleet", static=(n_max, w_fpga, w_cpu, fstat),
                arrays=arrays, cell_idx=tuple(sl), chunk=chunk))

    return SweepPlan("fleet", cells, dispatches, n_max,
                     meta={"resolved": resolved})


class SweepResult:
    """Per-cell `Accum` (numpy leaves, cell order) + conversion to
    paper-style totals/reports. ``n_dispatches`` counts the batched
    simulator calls the sweep cost (one per plan chunk); ``backend`` and
    ``device`` record where they ran."""

    def __init__(self, cells: Sequence, accum: Accum,
                 total_work: np.ndarray, total_requests: np.ndarray,
                 n_dispatches: int = 0, backend: str = "local",
                 device: str = "", meta: dict | None = None):
        self.cells = list(cells)
        self.accum = accum                      # leaves: (n_cells,) np arrays
        self._work = total_work
        self._requests = total_requests
        self.n_dispatches = n_dispatches
        self.backend = backend
        self.device = device
        self.meta = dict(meta or {})

    def __len__(self) -> int:
        return len(self.cells)

    @property
    def deadline_misses(self) -> np.ndarray:
        return np.asarray(self.accum.missed_requests)

    def totals(self, i: int) -> RunTotals:
        one = Accum(*[leaf[i] for leaf in self.accum])
        return accum_to_totals(one, float(self._work[i]),
                               int(self._requests[i]))

    def report(self, i: int,
               reference_fleet: FleetParams | None = None) -> Report:
        return report(self.totals(i), self.cells[i].fleet,
                      reference_fleet=reference_fleet)

    def reports(self, reference_fleet: FleetParams | None = None) -> list[Report]:
        return [self.report(i, reference_fleet) for i in range(len(self))]


class EventSweepResult:
    """DES counterpart of `SweepResult`: per-cell `RunTotals` in cell
    order plus the batching metadata (``n_dispatches``, ``backend``,
    ``device``). Sequence-compatible with a bare ``list[RunTotals]``:
    iteration, ``len`` and indexing all see the totals, and ``totals()``
    / ``totals(i)`` mirror `SweepResult.totals`."""

    def __init__(self, cells: Sequence, totals: Sequence[RunTotals],
                 n_dispatches: int = 0, backend: str = "local",
                 device: str = "", meta: dict | None = None):
        self.cells = list(cells)
        self._totals = list(totals)
        self.n_dispatches = n_dispatches
        self.backend = backend
        self.device = device
        self.meta = dict(meta or {})

    def __len__(self) -> int:
        return len(self._totals)

    def __iter__(self):
        return iter(self._totals)

    def __getitem__(self, i):
        return self._totals[i]

    def totals(self, i: int | None = None):
        """All totals (cell order) or one cell's totals."""
        return list(self._totals) if i is None else self._totals[i]

    def report(self, i: int,
               reference_fleet: FleetParams | None = None) -> Report:
        return report(self._totals[i], self.cells[i].fleet,
                      reference_fleet=reference_fleet)


class FleetSweepResult(EventSweepResult):
    """Multi-tenant counterpart of `EventSweepResult`: per-cell fleet
    `RunTotals` (cell order, with ``breakdown['offered_requests']`` /
    ``['shed_requests']``) plus per-cell, per-tenant
    `repro_torch.core.metrics.TenantTotals` rows, which conserve against
    the fleet totals by construction (`repro_torch.sim.exec`)."""

    def __init__(self, cells: Sequence, totals: Sequence[RunTotals],
                 tenants: Sequence[list], n_dispatches: int = 0,
                 backend: str = "local", device: str = "",
                 meta: dict | None = None):
        super().__init__(cells, totals, n_dispatches=n_dispatches,
                         backend=backend, device=device, meta=meta)
        self._tenants = list(tenants)

    def tenants(self, i: int | None = None):
        """Per-tenant `TenantTotals` rows for every cell (cell order) or
        for one cell."""
        return list(self._tenants) if i is None else self._tenants[i]
