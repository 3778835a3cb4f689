"""repro_torch.fleet — closed-loop multi-tenant fleet serving (port of
`repro.fleet`).

N tenants (each a `repro_torch.workloads` scenario or explicit stream, an
SLO class, a fairness weight) share ONE FPGA+CPU fleet: router-level
admission (`repro_torch.policies.admission`) decides admit/shed per
arrival, admitted requests flow through the unchanged dispatch + Spork
allocator machinery, and per-tenant `repro_torch.core.metrics.TenantTotals`
rows reconcile against the fleet-level `RunTotals`.

Implemented twice, as the reference does:

  * `FleetSim` / `simulate_fleet` (`repro_torch.fleet.oracle`) — exact
    serial oracle extending `repro_torch.sim.events.EventSim` with tenant
    tags.
  * `repro_torch.fleet.engine` — batched twin (tenant axis beside the DES
    state), planned by `repro_torch.sim.plan.plan_fleet` and run by
    `repro_torch.sim.exec`; `repro_torch.sim.sweep.sweep_fleet` is the
    one-call entry point.
"""

from repro_torch.fleet.specs import (SLO_CLASSES, FleetCell, ResolvedFleet,
                                     TenantSpec, resolve_fleet_cell)
from repro_torch.fleet.oracle import FleetSim, simulate_fleet

__all__ = [
    "SLO_CLASSES", "FleetCell", "FleetSim", "ResolvedFleet", "TenantSpec",
    "resolve_fleet_cell", "simulate_fleet",
]
