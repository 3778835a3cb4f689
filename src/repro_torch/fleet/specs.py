"""Multi-tenant fleet cells: tenant specs, SLO classes, stream merging.

Transliterated from `repro.fleet.specs`. `repro_torch.fleet` closes the
gap between the paper's one-app-at-a-time evaluation and its datacenter
pitch (PAPER.md §2, §7): N latency-sensitive tenants sharing ONE
FPGA+CPU fleet. This module is the host-side spec layer — frozen,
hashable cells the planner can group:

  * `TenantSpec` — one tenant: demand (a `repro_torch.workloads` scenario
    or an explicit arrival stream), an SLO class (`SLO_CLASSES` deadline
    multipliers), a fairness weight consumed by the admission policy,
    and an optional per-tenant `FailureSpec`.
  * `FleetCell` — one grid cell: a tenant population + ONE shared fleet
    + one dispatch policy + one admission policy. The cell is what
    `repro_torch.sim.plan.plan_fleet` plans and both engines simulate.
  * `resolve_fleet_cell` — materialize the cell: synthesize every
    tenant's arrivals, merge them into one time-ordered tenant-tagged
    stream (stable sort: equal-time arrivals keep tenant-index order, so
    both engines consume the identical stream), and precompute the
    per-tenant size/deadline/weight and admission-knob tables.

Trust order matches the single-tenant engines:
`repro_torch.fleet.oracle.FleetSim` is the exact serial oracle,
`repro_torch.fleet.engine` the batched twin.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.workers import DEFAULT_FLEET, FleetParams
from repro_torch.ft.failures import FailureSpec
from repro_torch.policies import get_admission_policy, get_dispatch_policy

#: SLO class -> deadline multiplier: deadline = multiplier x request
#: size (the paper's single class is 10x size, §5.1; tight/relaxed
#: bracket it for per-tenant SLO differentiation).
SLO_CLASSES = {"tight": 5.0, "standard": 10.0, "relaxed": 20.0}


@dataclass(frozen=True)
class TenantSpec:
    """One tenant of a shared fleet (frozen + hashable: plan group key).

    Demand is exactly one of: a named workload ``scenario``
    (`repro_torch.workloads.scenarios.ScenarioSpec`, realized at ``seed``) or
    an explicit ``arrival_times`` tuple (+ ``request_size_s``). ``slo``
    names a `SLO_CLASSES` deadline multiplier; ``weight`` is the
    fairness share the admission policy consumes
    (`repro_torch.policies.admission.AdmissionPolicy.tenant_params`)."""

    scenario: Any = None                   # ScenarioSpec | None
    arrival_times: tuple | None = None     # explicit stream (seconds)
    request_size_s: float | None = None    # None -> scenario's size
    slo: str = "standard"
    weight: float = 1.0
    seed: int = 0
    failures: FailureSpec | None = None

    def __post_init__(self):
        if (self.scenario is None) == (self.arrival_times is None):
            raise ValueError(
                "TenantSpec needs exactly one of scenario= or "
                "arrival_times=")
        if self.arrival_times is not None:
            if not isinstance(self.arrival_times, tuple):
                object.__setattr__(self, "arrival_times",
                                   tuple(float(t)
                                         for t in self.arrival_times))
            a = np.asarray(self.arrival_times, np.float64)
            if a.size and (not np.all(np.isfinite(a)) or np.any(a < 0)
                           or np.any(np.diff(a) < 0)):
                raise ValueError(
                    "TenantSpec.arrival_times must be sorted non-negative "
                    "finite timestamps")
            if self.request_size_s is None:
                raise ValueError(
                    "TenantSpec with explicit arrival_times needs "
                    "request_size_s")
        if self.request_size_s is not None and not (
                np.isfinite(self.request_size_s)
                and self.request_size_s > 0):
            raise ValueError(
                f"TenantSpec.request_size_s must be > 0, got "
                f"{self.request_size_s!r}")
        if self.slo not in SLO_CLASSES:
            raise ValueError(
                f"TenantSpec.slo must be one of {sorted(SLO_CLASSES)}, "
                f"got {self.slo!r}")
        if not (np.isfinite(self.weight) and self.weight > 0):
            raise ValueError(
                f"TenantSpec.weight must be > 0, got {self.weight!r}")

    @property
    def deadline_mult(self) -> float:
        return SLO_CLASSES[self.slo]


@dataclass(frozen=True)
class FleetCell:
    """One multi-tenant grid cell: N tenants x ONE shared fleet x one
    dispatch policy x one admission policy.

    ``failures`` (cell-level) overrides any per-tenant `FailureSpec`;
    with no cell-level spec, at most one *distinct* tenant-level spec may
    be present (one shared fleet has one fault model — conflicting
    per-tenant specs are a construction error, surfaced by
    `resolve_fleet_cell`). ``seed`` offsets every tenant's scenario
    realization seed, so seed sweeps re-draw all tenant demand."""

    tenants: tuple = ()
    dispatcher: str = "spork"
    admission: Any = "admit_all"     # name | AdmissionPolicy instance
    fleet: FleetParams = DEFAULT_FLEET
    energy_weight: float = 1.0
    horizon_s: float | None = None
    seed: int = 0
    allocate_fpgas: bool = True
    failures: FailureSpec | None = None
    tag: Any = None

    def __post_init__(self):
        if not isinstance(self.tenants, tuple):
            object.__setattr__(self, "tenants", tuple(self.tenants))
        if not self.tenants:
            raise ValueError("FleetCell needs at least one tenant")
        for t in self.tenants:
            if not isinstance(t, TenantSpec):
                raise TypeError(
                    f"FleetCell.tenants must be TenantSpec, got {t!r}")
        get_dispatch_policy(self.dispatcher)       # fail fast on typos
        get_admission_policy(self.admission)
        if self.horizon_s is not None and not (
                np.isfinite(self.horizon_s) and self.horizon_s > 0):
            raise ValueError(
                f"FleetCell.horizon_s must be > 0, got {self.horizon_s!r}")
        if not np.isfinite(self.energy_weight):
            raise ValueError(
                f"FleetCell.energy_weight must be finite, got "
                f"{self.energy_weight!r}")

    @property
    def n_tenants(self) -> int:
        return len(self.tenants)


class ResolvedFleet(NamedTuple):
    """Materialized `FleetCell`: the merged tenant-tagged stream plus the
    per-tenant tables both engines consume verbatim."""

    times: np.ndarray        # (n,) f64 merged arrival times, sorted
    tids: np.ndarray         # (n,) i32 tenant index per arrival
    sizes: np.ndarray        # (N,) f64 request service time per tenant
    deadlines: np.ndarray    # (N,) f64 SLO deadline per tenant
    weights: np.ndarray      # (N,) f64 fairness weights
    adm_rate: np.ndarray     # (N,) f32 admission knobs (policy-computed)
    adm_burst: np.ndarray    # (N,) f32
    adm_quota: np.ndarray    # (N,) f32
    horizon_s: float
    failures: FailureSpec | None

    @property
    def n_tenants(self) -> int:
        return len(self.sizes)


def resolve_fleet_cell(cell: FleetCell,
                       device: str | torch.device | None = None
                       ) -> ResolvedFleet:
    """Materialize one `FleetCell` (cached per (cell, device) — cells are
    frozen/hashable, and the planner and the oracle re-resolve the same
    cells). Scenario-bearing tenants are realized on ``device`` (None:
    the card); explicit streams need no device.

    Scenario-bearing tenants are synthesized in ONE batch per distinct
    `ScenarioSpec` (`repro_torch.workloads.scenarios.scenario_traces`
    over the tenant seed set — the same one-synthesis-per-spec contract
    as `repro_torch.sim.plan.resolve_scenarios`, which is what keeps
    resolving a 1024-tenant population cheap).

    The merged stream is built by concatenating per-tenant streams in
    tenant order and stable-sorting by time, so equal-time arrivals keep
    tenant-index order — the documented cross-engine tie rule (both
    engines consume these exact arrays)."""
    return _resolve(cell, None if device is None else str(device))


@functools.lru_cache(maxsize=64)
def _resolve(cell: FleetCell, device: str | None) -> ResolvedFleet:
    n = len(cell.tenants)
    streams: list = [None] * n
    sizes: list = [None] * n
    pending: dict = {}
    for i, spec in enumerate(cell.tenants):
        if spec.arrival_times is not None:
            streams[i] = np.asarray(spec.arrival_times, np.float64)
            sizes[i] = float(spec.request_size_s)
        else:
            pending.setdefault(spec.scenario, []).append(i)
    if pending:
        from repro_torch.workloads.scenarios import (scenario_arrivals,
                                                     scenario_traces)
        for sc, idxs in pending.items():
            seeds = sorted({cell.seed + cell.tenants[i].seed for i in idxs})
            by_seed = dict(zip(seeds, scenario_traces(sc, seeds, device)))
            for i in idxs:
                spec = cell.tenants[i]
                s = cell.seed + spec.seed
                streams[i] = np.asarray(
                    scenario_arrivals(sc, s, _trace=by_seed[s],
                                      device=device), np.float64)
                sizes[i] = float(spec.request_size_s
                                 if spec.request_size_s is not None
                                 else by_seed[s].request_size_s)
    n_per = [len(a) for a in streams]
    times = (np.concatenate(streams) if streams
             else np.zeros(0, np.float64))
    tids = np.repeat(np.arange(len(streams), dtype=np.int32), n_per)
    order = np.argsort(times, kind="stable")
    times, tids = times[order], tids[order]

    sizes = np.asarray(sizes, np.float64)
    deadlines = sizes * np.array([t.deadline_mult for t in cell.tenants],
                                 np.float64)
    weights = np.array([t.weight for t in cell.tenants], np.float64)
    rate, burst, quota = get_admission_policy(
        cell.admission).tenant_params(weights)

    if cell.horizon_s is not None:
        horizon = float(cell.horizon_s)
    else:
        sc = [float(t.scenario.horizon_s) for t in cell.tenants
              if t.scenario is not None]
        horizon = (max(sc) if sc
                   else float(times[-1] + 1.0) if len(times) else 1.0)

    failures = cell.failures
    if failures is None:
        tenant_f = {t.failures for t in cell.tenants
                    if t.failures is not None}
        if len(tenant_f) > 1:
            raise ValueError(
                "conflicting per-tenant FailureSpecs on one shared fleet "
                "(set FleetCell.failures to pick one)")
        failures = next(iter(tenant_f)) if tenant_f else None

    return ResolvedFleet(times=times, tids=tids, sizes=sizes,
                         deadlines=deadlines, weights=weights,
                         adm_rate=np.asarray(rate, np.float32),
                         adm_burst=np.asarray(burst, np.float32),
                         adm_quota=np.asarray(quota, np.float32),
                         horizon_s=horizon, failures=failures)
