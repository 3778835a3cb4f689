"""Serial multi-tenant fleet oracle: tenant-tagged `EventSim`.

Transliterated from `repro.fleet.oracle`. `FleetSim` extends the exact
single-app DES (`repro_torch.sim.events.EventSim`) with tenant-tagged
requests: every arrival carries a tenant index, the router-level
admission policy (`repro_torch.policies.admission`) decides admit/shed
per arrival in float32 (the shared `admission_decide` function, so
decisions are bit-identical to the batched engine), and admitted
requests run through the UNCHANGED
dispatch/allocator machinery with the tenant's own size and SLO deadline
(``self.size`` / ``self.deadline`` are read per-arrival by
``_on_arrival``; the allocator tick never reads them). Per-tenant
counters are tallied by observing the deltas the inherited code applies
to the shared totals, so the single-tenant semantics cannot drift. The
only device work is the allocator tick's predict, on ``device``: on the
card, one `spork_predict` launch (C = 1) a tick.

This is the trust anchor of the fleet layer: the batched engine
(`repro_torch.fleet.engine`) must match it exactly on counters and to
~1e-5 on energies (tests/test_torch_fleet.py).
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from repro_torch.core.metrics import (RunTotals, TenantTotals,
                                     attribute_tenants)
from repro_torch.fleet.specs import (FleetCell, ResolvedFleet,
                                     resolve_fleet_cell)
from repro_torch.policies import admission_decide, get_admission_policy
from repro_torch.sim.events import EventSim


class FleetSim(EventSim):
    """N tenants, ONE fleet, one dispatch policy, one admission policy.
    ``device`` (None: the card) realizes scenario tenants and runs the
    allocator's per-tick predict."""

    def __init__(self, cell: FleetCell, n_max: int = 512,
                 device: str | torch.device | None = None):
        rs = resolve_fleet_cell(cell, device)
        super().__init__(
            cell.fleet, float(rs.sizes[0]), dispatcher=cell.dispatcher,
            energy_weight=cell.energy_weight,
            deadline_s=float(rs.deadlines[0]), n_max=n_max,
            allocate_fpgas=cell.allocate_fpgas, failures=rs.failures,
            device=device)
        self.cell = cell
        self.resolved: ResolvedFleet = rs
        self._acode = get_admission_policy(cell.admission).code
        n = rs.n_tenants
        # admission state (float32 — the cross-engine exactness contract)
        self._adm_tok = rs.adm_burst.copy()
        self._adm_last = np.zeros(n, np.float32)
        self._adm_cnt = np.zeros(n, np.int32)
        # per-tenant tallies
        self.t_offered = np.zeros(n, np.int64)
        self.t_admitted = np.zeros(n, np.int64)
        self.t_shed = np.zeros(n, np.int64)
        self.t_missed = np.zeros(n, np.int64)
        self.t_work_f = np.zeros(n, np.float64)
        self.t_work_c = np.zeros(n, np.float64)

    # ---------- tenant-tagged arrival ----------
    def _tagged_arrival(self, tid: int) -> None:
        """One tenant's arrival at ``self.now``: float32 admission
        decision, then the inherited `_on_arrival` with the tenant's
        size/deadline; per-tenant tallies from the shared-total deltas."""
        rs = self.resolved
        self.t_offered[tid] += 1
        admit, tok, last, cnt = admission_decide(
            self._acode, np.float32(self.now), self._adm_tok[tid],
            self._adm_last[tid], self._adm_cnt[tid], rs.adm_rate[tid],
            rs.adm_burst[tid], rs.adm_quota[tid], xp=np)
        self._adm_tok[tid] = tok
        self._adm_last[tid] = last
        self._adm_cnt[tid] = cnt
        if not bool(admit):
            self.t_shed[tid] += 1
            return
        self.t_admitted[tid] += 1
        self.size = float(rs.sizes[tid])
        self.deadline = float(rs.deadlines[tid])
        m0 = self.misses
        wf0 = self.totals.work_on_fpga_cpu_s
        wc0 = self.totals.work_on_cpu_cpu_s
        self._on_arrival()
        if self.misses != m0:
            self.t_missed[tid] += 1
        if self.totals.work_on_fpga_cpu_s != wf0:
            self.t_work_f[tid] += self.size
        elif self.totals.work_on_cpu_cpu_s != wc0:
            self.t_work_c[tid] += self.size

    def _on_tick(self) -> None:
        """Allocator tick on *aggregate* demand (unchanged Algs. 1-2 via
        super) + the per-interval admission quota reset
        (`repro_torch.policies.admission.IntervalQuota`)."""
        self._adm_cnt[:] = 0
        super()._on_tick()

    # ---------- online API (repro_torch.serve.router.TenantRouter) ------
    def submit_tagged(self, t: float, tid: int) -> bool:
        """Submit one tenant request at time t; returns admitted?

        Internal events are drained STRICTLY before t — equal-time
        events (e.g. an allocator tick at exactly t) stay queued until
        the next submit/advance, reproducing the batch engines'
        arrivals-first tie rule so online == batch bit for bit.

        Submissions must be globally time-ordered across tenants (the
        batch engines consume ONE merged stream); a t behind the clock
        would silently run admission against the wrong bucket/quota
        state, so it is rejected instead."""
        if float(t) < self.now:
            raise ValueError(
                f"out-of-order submit: t={t} < now={self.now} — "
                f"submit requests in merged time order across tenants")
        while self.events and self.events[0][0] < t:
            et, _, kind, payload = heapq.heappop(self.events)
            self.now = float(et)
            self._dispatch_event(kind, payload, self.resolved.horizon_s)
        self.now = max(self.now, float(t))
        admitted_before = self.t_admitted[tid]
        self._tagged_arrival(tid)
        return self.t_admitted[tid] > admitted_before

    # ---------- batch API ----------
    def run_tagged(self, times: np.ndarray, tids: np.ndarray,
                   horizon_s: float) -> tuple[RunTotals,
                                              list[TenantTotals]]:
        """`EventSim.run`'s merge loop with tenant-tagged arrivals: the
        arrival stream merges with the internal event heap, arrivals
        first at equal timestamps (the engines' documented tie rule)."""
        self.schedule_ticks(horizon_s)
        ai, n_arr = 0, len(times)
        while self.events or ai < n_arr:
            t_ev = self.events[0][0] if self.events else np.inf
            t_ar = times[ai] if ai < n_arr else np.inf
            if t_ar <= t_ev:
                self.now = float(t_ar)
                tid = int(tids[ai])
                ai += 1
                self._tagged_arrival(tid)
                continue
            t, _, kind, payload = heapq.heappop(self.events)
            self.now = float(t)
            self._dispatch_event(kind, payload, horizon_s)
        return self.finalize_fleet(horizon_s)

    def finalize_fleet(self, horizon_s: float) -> tuple[RunTotals,
                                                        list[TenantTotals]]:
        """Settle workers (`EventSim._finalize`) and build the per-tenant
        rows; the fleet totals carry offered/shed in ``breakdown`` (the
        conservation contract on `repro_torch.core.metrics.TenantTotals`)."""
        totals = self._finalize(horizon_s)
        totals.breakdown["offered_requests"] = int(self.t_offered.sum())
        totals.breakdown["shed_requests"] = int(self.t_shed.sum())
        rows = attribute_tenants(
            totals, self.resolved.weights, self.resolved.sizes,
            self.t_offered, self.t_admitted, self.t_shed, self.t_missed,
            self.t_work_f, self.t_work_c)
        return totals, rows


def simulate_fleet(cell: FleetCell, n_max: int = 512,
                   device: str | torch.device | None = None
                   ) -> tuple[RunTotals, list[TenantTotals]]:
    """Convenience wrapper: one fleet cell, exact serial DES (``device``,
    None: the card, runs the per-tick predict). The batched counterpart
    is `repro_torch.sim.sweep.sweep_fleet`."""
    rs = resolve_fleet_cell(cell, device)
    sim = FleetSim(cell, n_max=n_max, device=device)
    return sim.run_tagged(rs.times, rs.tids, rs.horizon_s)
