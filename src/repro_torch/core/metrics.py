"""Accounting and normalized metrics (paper §5.1 Metrics).

Every platform run produces a ``RunTotals``; metrics are reported relative
to the idealized FPGA-only platform (compute-only energy/cost, zero idle
and spin-up overhead) with *default* worker parameters:

  energy_efficiency = E_ideal / E_actual        (<= 1.0, higher is better)
  relative_cost     = cost_actual / cost_ideal  (>= 1.0, lower is better)

Transliterated from `repro.core.metrics`. The per-tenant rows
(`TenantTotals`, `attribute_tenants`) belong to the fleet layer and are
not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

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
