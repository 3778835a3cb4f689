"""Spork-scheduled heterogeneous serving: the paper's scheduler sizing a
fleet that serves the assigned model architectures.

The mapping: the paper's "FPGA" is the reserved accelerator pool (slow to
provision, energy-efficient at steady load); the "CPU" is the elastic
host pool (fast cold-start, cheap at low load, ~S x slower per request).
`fleet_for_arch` derives the request service time and the accelerator
speedup from the architecture's roofline numbers: decode is
bandwidth-bound, so the per-token floor is active_bytes / HBM_BW of the
card (`repro_torch.launch.mesh`); when a dry-run record exists its
roofline terms override the analytic estimate. The router itself is the
paper's machinery (Algs. 1-3 via `repro_torch.sim.events.EventSim`)
driven online; its allocator ticks run the `spork_predict` kernel on the
card. `TenantRouter` drives the fleet layer's multi-tenant oracle online
the same way.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.metrics import Report, report
from repro_torch.core.workers import DEFAULT_FLEET, FleetParams
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
from repro_torch.sim.events import EventSim


@dataclass(frozen=True)
class ArchServiceModel:
    arch: str
    token_s_accel: float       # seconds per generated token, accelerator
    speedup: float             # accelerator over elastic-CPU worker


def analytic_token_latency(arch: str) -> float:
    """Bandwidth-bound decode floor: active params (bf16) / HBM bandwidth."""
    cfg = get_config(arch, "full")
    active = cfg.param_count(active_only=True)
    return active * 2.0 / HBM_BW


def roofline_token_latency(arch: str,
                           dryrun_dir: str | Path = "results/dryrun",
                           ) -> float | None:
    """Dominant roofline term per decode step from a dry-run record."""
    p = Path(dryrun_dir) / f"{arch}__decode_32k__single.json"
    if not p.exists():
        return None
    rec = json.loads(p.read_text())
    if not rec.get("ok"):
        return None
    flops = rec.get("hlo_flops", 0.0)
    byts = rec.get("hlo_bytes", 0.0)
    if flops <= 0 or byts <= 0:
        return None
    # per-device terms; batch shares the step
    batch = 128
    return float(max(flops / PEAK_FLOPS_BF16, byts / HBM_BW) / batch)


def service_model(arch: str, speedup: float = 2.0,
                  dryrun_dir: str | Path = "results/dryrun",
                  ) -> ArchServiceModel:
    t = roofline_token_latency(arch, dryrun_dir) or analytic_token_latency(arch)
    return ArchServiceModel(arch=arch, token_s_accel=t, speedup=speedup)


def fleet_for_arch(arch: str, avg_new_tokens: int = 64,
                   base: FleetParams = DEFAULT_FLEET,
                   dryrun_dir: str | Path = "results/dryrun",
                   ) -> tuple[FleetParams, float]:
    """(FleetParams, request_size_s_on_cpu) for serving `arch`.

    Power/cost/spin-up keep the paper's defaults (they parameterize the
    platform, not the model); the request size comes from the arch's
    decode latency x tokens per request."""
    sm = service_model(arch, dryrun_dir=dryrun_dir)
    size_cpu_s = sm.token_s_accel * sm.speedup * avg_new_tokens
    fleet = base.replace(
        fpga=base.fpga.replace(speedup=sm.speedup),
        cpu=base.cpu.replace(speedup=1.0))
    return fleet, size_cpu_s


class TenantRouter:
    """Online multi-tenant router: the fleet layer's admission + dispatch
    driven request-by-request over ONE shared fleet.

    Wraps `repro_torch.fleet.FleetSim` the way `SporkRouter` wraps
    `EventSim`: `submit(t, tenant)` runs the cell's router-level
    admission policy (`repro_torch.policies.admission`, float32 —
    decisions bit-identical to both batch engines) and, if admitted,
    dispatches with the tenant's own size and SLO deadline; `finish`
    returns the fleet `Report` plus the per-tenant
    `repro_torch.core.metrics.TenantTotals` rows. Online submission
    equals `repro_torch.fleet.simulate_fleet` on the same stream.
    ``device`` (None: the card) runs the allocator's per-tick predict."""

    def __init__(self, cell, n_max: int = 512,
                 device: str | torch.device | None = None):
        from repro_torch.fleet import FleetSim, resolve_fleet_cell
        self.cell = cell
        self.sim = FleetSim(cell, n_max=n_max, device=device)
        self.horizon = resolve_fleet_cell(cell, device).horizon_s
        self.sim.schedule_ticks(self.horizon)

    def submit(self, t: float, tenant: int) -> bool:
        """One tenant request at time t; returns admitted (False = shed)."""
        return self.sim.submit_tagged(t, tenant)

    def advance(self, t: float) -> None:
        self.sim.drain_until(t, self.horizon)

    def finish(self) -> tuple[Report, list]:
        # drain the WHOLE event heap (spin-ups/reclaims can land past
        # the horizon) — `FleetSim.run_tagged` does the same, and the
        # online == batch equivalence is exact only if both settle alike
        self.sim.drain_until(float("inf"), self.horizon)
        totals, rows = self.sim.finalize_fleet(self.horizon)
        return report(totals, self.cell.fleet), rows


class SporkRouter:
    """Online request router: Spork allocation + efficient-first dispatch
    over a heterogeneous fleet serving one architecture. ``device``
    (None: the card) runs the allocator's per-tick predict."""

    def __init__(self, arch: str, energy_weight: float = 1.0,
                 dispatcher: str = "spork", avg_new_tokens: int = 64,
                 horizon_s: float = 3600.0,
                 dryrun_dir: str | Path = "results/dryrun",
                 device: str | torch.device | None = None):
        self.fleet, self.size_s = fleet_for_arch(
            arch, avg_new_tokens, dryrun_dir=dryrun_dir)
        self.sim = EventSim(self.fleet, self.size_s, dispatcher=dispatcher,
                            energy_weight=energy_weight, device=device)
        self.horizon = horizon_s
        self.sim.schedule_ticks(horizon_s)

    def submit(self, t: float) -> None:
        self.sim.submit(t)

    def advance(self, t: float) -> None:
        self.sim.drain_until(t, self.horizon)

    def finish(self) -> Report:
        self.sim.drain_until(self.horizon, self.horizon)
        totals = self.sim._finalize(self.horizon)
        return report(totals, self.fleet)
