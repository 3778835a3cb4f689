"""Accounting and normalized metrics (paper §5.1 Metrics).

Every platform run produces a ``RunTotals``; metrics are reported relative
to the idealized FPGA-only platform (compute-only energy/cost, zero idle
and spin-up overhead) with *default* worker parameters:

  energy_efficiency = E_ideal / E_actual        (<= 1.0, higher is better)
  relative_cost     = cost_actual / cost_ideal  (>= 1.0, lower is better)

Transliterated from `repro.core.metrics`, with the fleet layer's
per-tenant rows (`TenantTotals`, `attribute_tenants`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .workers import FleetParams


@dataclass
class RunTotals:
    """Aggregate outcomes of simulating one scheduler on one trace."""

    energy_j: float = 0.0
    cost_usd: float = 0.0
    work_cpu_s: float = 0.0           # total request demand, CPU-seconds
    work_on_fpga_cpu_s: float = 0.0   # portion served by FPGAs (CPU-seconds)
    work_on_cpu_cpu_s: float = 0.0    # portion served by CPUs (CPU-seconds)
    requests: int = 0
    deadline_misses: int = 0
    fpga_spinups: int = 0
    cpu_spinups: int = 0
    fpga_idle_j: float = 0.0
    fpga_busy_j: float = 0.0
    cpu_busy_j: float = 0.0
    spinup_j: float = 0.0
    # resilience counters (failure-injection runs; all zero when the
    # failure axis is off, which is always the case in the rate path)
    retries: int = 0
    failed_spinups: int = 0
    crashes: int = 0
    recovered_requests: int = 0
    failure_misses: int = 0
    wasted_spinup_j: float = 0.0
    breakdown: dict = field(default_factory=dict)

    # additive field groups shared by merge() and the comparisons that
    # hold one run against another
    FLOAT_FIELDS = ("energy_j", "cost_usd", "work_cpu_s",
                    "work_on_fpga_cpu_s", "work_on_cpu_cpu_s", "fpga_idle_j",
                    "fpga_busy_j", "cpu_busy_j", "spinup_j",
                    "wasted_spinup_j")
    COUNT_FIELDS = ("requests", "deadline_misses", "fpga_spinups",
                    "cpu_spinups", "retries", "failed_spinups", "crashes",
                    "recovered_requests", "failure_misses")

    def merge(self, other: "RunTotals") -> "RunTotals":
        out = RunTotals()
        for f in self.FLOAT_FIELDS + self.COUNT_FIELDS:
            setattr(out, f, getattr(self, f) + getattr(other, f))
        return out

    def is_finite(self) -> bool:
        """True iff every float field is finite."""
        return all(math.isfinite(float(getattr(self, f)))
                   for f in self.FLOAT_FIELDS)


@dataclass
class TenantTotals:
    """Per-tenant slice of one multi-tenant fleet run (`repro_torch.fleet`).

    Conservation contract: over all tenants of one
    `repro_torch.fleet.specs.FleetCell`,

      * sum(admitted)        == fleet ``RunTotals.requests``   (exact)
      * sum(shed)            == ``breakdown['shed_requests']`` (exact)
      * sum(deadline_misses) == fleet ``deadline_misses``      (exact)
      * sum(work_on_*_cpu_s) == fleet ``work_on_*_cpu_s``      (~float)
      * sum(energy_j/cost_usd) == fleet totals                 (~float)

    and per tenant ``admitted + shed == requests`` (offered) with
    ``deadline_misses <= admitted``. Energy and cost are *attributed*
    (the fleet is shared hardware): each tenant gets a share proportional
    to its served work (`attribute_tenants`)."""

    tenant: int = 0                   # tenant index within the cell
    weight: float = 1.0               # TenantSpec.weight (fairness share)
    requests: int = 0                 # offered = admitted + shed
    admitted: int = 0
    shed: int = 0                     # rejected by router-level admission
    deadline_misses: int = 0
    work_cpu_s: float = 0.0           # admitted demand, CPU-seconds
    work_on_fpga_cpu_s: float = 0.0
    work_on_cpu_cpu_s: float = 0.0
    energy_j: float = 0.0             # attributed share of fleet energy
    cost_usd: float = 0.0             # attributed share of fleet cost

    def row(self) -> dict:
        """Flat record (rounded) for printing and comparing rows."""
        return {
            "tenant": self.tenant, "weight": round(self.weight, 4),
            "requests": self.requests, "admitted": self.admitted,
            "shed": self.shed, "misses": self.deadline_misses,
            "miss_rate": round(self.deadline_misses
                               / max(self.admitted, 1), 6),
            "shed_rate": round(self.shed / max(self.requests, 1), 6),
            "energy_j": round(self.energy_j, 3),
            "cost_usd": round(self.cost_usd, 6),
        }


def attribute_tenants(totals: "RunTotals", weights, sizes, offered,
                      admitted, shed, missed, work_f,
                      work_c) -> list[TenantTotals]:
    """Build per-tenant `TenantTotals` rows from one fleet run.

    Counters (``offered``/``admitted``/``shed``/``missed``) and the
    served-work splits (``work_f``/``work_c``, CPU-seconds) come straight
    from the engines' per-tenant accumulators; shared-fleet ``energy_j``
    and ``cost_usd`` are attributed proportionally to each tenant's
    served work (falling back to its admitted-request share when nothing
    was served), so the rows always sum back to the fleet totals within
    float tolerance. Both `repro_torch.fleet.oracle.FleetSim` and the
    batched `repro_torch.fleet.engine` produce rows through this one
    function, so the attribution rule cannot drift between engines."""
    weights = np.asarray(weights, np.float64)
    sizes = np.asarray(sizes, np.float64)
    offered = np.asarray(offered, np.int64)
    admitted = np.asarray(admitted, np.int64)
    shed = np.asarray(shed, np.int64)
    missed = np.asarray(missed, np.int64)
    work_f = np.asarray(work_f, np.float64)
    work_c = np.asarray(work_c, np.float64)
    served = work_f + work_c
    basis = served if served.sum() > 0 else admitted.astype(np.float64)
    total = basis.sum()
    share = (basis / total if total > 0
             else np.full(len(basis), 1.0 / max(len(basis), 1)))
    return [
        TenantTotals(
            tenant=i, weight=float(weights[i]),
            requests=int(offered[i]), admitted=int(admitted[i]),
            shed=int(shed[i]), deadline_misses=int(missed[i]),
            work_cpu_s=float(admitted[i] * sizes[i]),
            work_on_fpga_cpu_s=float(work_f[i]),
            work_on_cpu_cpu_s=float(work_c[i]),
            energy_j=float(totals.energy_j * share[i]),
            cost_usd=float(totals.cost_usd * share[i]))
        for i in range(len(basis))]


@dataclass(frozen=True)
class Report:
    energy_efficiency: float
    relative_cost: float
    deadline_miss_rate: float
    cpu_request_fraction: float
    totals: "RunTotals"

    def row(self) -> dict:
        return {
            "energy_efficiency": round(self.energy_efficiency, 4),
            "relative_cost": round(self.relative_cost, 4),
            "miss_rate": round(self.deadline_miss_rate, 6),
            "cpu_frac": round(self.cpu_request_fraction, 4),
        }


def report(totals: RunTotals, fleet: FleetParams,
           reference_fleet: FleetParams | None = None) -> Report:
    """Normalize against the idealized FPGA-only platform.

    The paper normalizes sensitivity studies against the *default* FPGA
    parameters ("relative to an idealized FPGA-only baseline with default
    parameters", Fig. 5), so the reference fleet may differ from the fleet
    being simulated.
    """
    ref = reference_fleet or fleet
    e_ideal = ref.ideal_energy_j(totals.work_cpu_s)
    c_ideal = ref.ideal_cost_usd(totals.work_cpu_s)
    served = totals.work_on_fpga_cpu_s + totals.work_on_cpu_cpu_s
    return Report(
        energy_efficiency=e_ideal / max(totals.energy_j, 1e-12),
        relative_cost=totals.cost_usd / max(c_ideal, 1e-12),
        deadline_miss_rate=totals.deadline_misses / max(totals.requests, 1),
        cpu_request_fraction=totals.work_on_cpu_cpu_s / max(served, 1e-12),
        totals=totals,
    )
