"""Exact discrete-event simulator: per-request semantics for hybrid fleets.

Transliterated from `repro.sim.events`. This is the ground-truth engine
(the paper's Cython/C++ simulator equivalent), a serial float64 heap
loop on the host. Its only device work is the per-interval `predict`
(`repro_torch.core.predictor.Predictor`), which runs on ``device``: on
the card, through the `spork_predict` kernel. It models individual workers, FIFO per-worker queues,
deadline-aware dispatch (paper Alg. 3) and the per-interval Spork
allocator (Algs. 1-2) with the conditional-histogram predictor.

Dispatch policies are plugin objects (`repro_torch.policies.des`; pass a
registered name or a `DispatchPolicy` instance). Paper Table 9:
  * 'spork'         — efficient-first: FPGAs before CPUs; within a type,
                      busiest-first, then least-idle, then
                      being-allocated-with-most-queued-load.
  * 'index_packing' — AutoScale [27]: busiest-first across ALL workers
                      regardless of type (may prefer a busy CPU over an
                      idle FPGA — the inefficiency Table 9 quantifies).
  * 'round_robin'   — MArk [93]: cycle over all up workers.

Workers are kept in lists ordered by ``available_at`` (completion time of
their last queued request). For identical-size requests this single order
simultaneously encodes "busiest-first" among busy workers and
"least-idle-first" among idle workers, so dispatch is a bisect, keeping
the engine fast enough for production-scale traces at reduced load.

Fault model (``failures=`` `repro_torch.ft.failures.FailureSpec`): this engine
is the exact oracle for the failure semantics too — spin-up attempts fail
with probability p (bounded retries with backoff; an allocation whose
attempts are exhausted is *stillborn*: its energy and cost are wasted and
it never joins the fleet), assignments crash mid-service with probability
``crash_p`` (the worker dies half a service in, the request re-enters
dispatch at the same timestamp with its *original* deadline for up to
``max_failover`` extra rounds — deadline-aware failover through the same
CanMeetDeadline feasibility checks — and is dropped as an SLO violation
when the rounds run out), hash-drawn stragglers serve ``factor``x slower,
and an optional evacuation window masks a hash-drawn subset out of
dispatch and out of the allocator's live-fleet count (they drain and idle
out; `repro_torch.ft.elastic.surviving` filters the id lists, the
allocator re-provisions the shortfall). Every draw comes from the
counter-based `repro_torch.ft.failures.failure_u01` stream keyed (seed,
wid, counter, purpose), so `repro_torch.sim.events_batched` consumes
identical randomness.
With ``failures=None`` (or an all-zero spec) every code path below is the
pre-failure-model one, bit for bit.
"""

from __future__ import annotations

import heapq
from bisect import insort
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.breakeven import objective_setup
from repro_torch.core.metrics import RunTotals
from repro_torch.core.predictor import Predictor
from repro_torch.core.workers import FleetParams
from repro_torch.ft.elastic import surviving
from repro_torch.ft.failures import (DRAW_CRASH, DRAW_EVAC, DRAW_SPINUP,
                                     DRAW_STRAGGLE, FailureSpec, failure_u01)
from repro_torch.policies import dispatch_policy_names, get_dispatch_policy

#: Registered dispatch-policy names (registration order == traced codes).
DISPATCHERS = dispatch_policy_names()


@dataclass
class _Worker:
    wid: int
    kind: str                    # 'cpu' | 'fpga'
    alloc_t: float
    ready_at: float              # spin-up completion
    level_at_alloc: int = 0
    available_at: float = 0.0    # when its queue drains
    busy_s: float = 0.0
    dealloc_t: float = -1.0
    idle_mark: float = -1.0      # idle_since for the timeout check
    last_assign_t: float = -1.0
    # failure-model state (inert defaults when failures are off)
    n_fail: int = 0              # failed spin-up attempts before success
    slow: float = 1.0            # straggler service-time multiplier
    evac: bool = False           # member of the hash-drawn evacuated set
    n_assigned: int = 0          # assignment count (crash-draw counter)


class EventSim:
    """One application, one fleet, one dispatch policy, one objective.
    ``device`` (None: the card) is where the per-tick `predict` runs.

    Contract kept for the multi-tenant subclass of the fleet slice
    (`repro.fleet.oracle.FleetSim`): ``self.size`` and ``self.deadline``
    are read *per arrival* by `_on_arrival` / `_assign` and never by the
    allocator tick or settlement paths, so a subclass may swap them
    before each arrival to model heterogeneous requests without touching
    the dispatch/allocator machinery."""

    def __init__(self, fleet: FleetParams, size_s: float,
                 dispatcher: str = "spork", energy_weight: float = 1.0,
                 deadline_s: float | None = None, n_max: int = 512,
                 allocate_fpgas: bool = True,
                 failures: FailureSpec | None = None,
                 device: str | torch.device | None = None):
        self.policy = get_dispatch_policy(dispatcher)   # name or object
        self.fleet = fleet
        self.size = size_s
        self.failures = failures.normalized() if failures is not None else None
        self.deadline = 10.0 * size_s if deadline_s is None else deadline_s
        self.dispatcher = self.policy.name
        self.allocate_fpgas = allocate_fpgas
        self.tb, coeffs = objective_setup(fleet, energy_weight)
        self.predictor = Predictor(n_max, coeffs, fleet.T_s, device=device)
        self.n_max = n_max

        self.workers: dict[int, _Worker] = {}
        self.order: dict[str, list[tuple[float, int]]] = {"fpga": [], "cpu": []}
        self.pending: dict[str, list[int]] = {"fpga": [], "cpu": []}
        self.rr_ring: list[int] = []
        self.rr_pos = 0
        self._wid = 0
        self.events: list[tuple[float, int, str, int]] = []
        self._seq = 0
        self.now = 0.0
        # per-interval served-service-time accumulators (Alg. 1 inputs)
        self.F_acc = 0.0
        self.C_acc = 0.0
        self.n_lag = [0, 0]      # [n_{t-2}, n_{t-3}]
        self.totals = RunTotals()
        self.misses = 0

    # ---------- event plumbing ----------
    def _push(self, t: float, kind: str, payload: int = 0) -> None:
        self._seq += 1
        heapq.heappush(self.events, (t, self._seq, kind, payload))

    # ---------- worker lifecycle ----------
    def _spin_up(self, kind: str, level: int | None = None) -> _Worker | None:
        """Allocate a worker; under the failure model each attempt fails
        with probability spinup_fail_p (counter-based draw per attempt),
        bounded by max_retries with retry_backoff_s between attempts.
        Returns None for a stillborn allocation (all attempts failed):
        its wid is consumed and its energy/cost wasted, but it never
        joins the fleet."""
        spec = self.fleet.fpga if kind == "fpga" else self.fleet.cpu
        f = self.failures
        self._wid += 1
        lvl = self._allocated(kind) if level is None else level
        if f is None:
            ready_at = self.now + spec.spin_up_s
            n_fail = 0
        else:
            p = np.float32(f.spinup_fail_p)
            R = f.max_retries
            n_fail = 0
            while (n_fail <= R and
                   failure_u01(f.seed, self._wid, n_fail, DRAW_SPINUP) < p):
                n_fail += 1
            self.totals.failed_spinups += n_fail
            self.totals.retries += min(n_fail, R)
            self.totals.wasted_spinup_j += n_fail * spec.spin_up_energy_j
            if n_fail > R:       # stillborn: occupied for every attempt
                dur = (R + 1) * spec.spin_up_s + R * f.retry_backoff_s
                self.totals.cost_usd += dur * spec.cost_per_s
                return None
            ready_at = (self.now + spec.spin_up_s * (1 + n_fail)
                        + f.retry_backoff_s * n_fail)
        w = _Worker(self._wid, kind, alloc_t=self.now, ready_at=ready_at,
                    level_at_alloc=lvl)
        w.n_fail = n_fail
        if f is not None:
            w.slow = (f.straggler_factor
                      if failure_u01(f.seed, w.wid, 0, DRAW_STRAGGLE)
                      < np.float32(f.straggler_frac) else 1.0)
            w.evac = bool(failure_u01(f.seed, w.wid, 0, DRAW_EVAC)
                          < np.float32(f.evac_frac))
        w.available_at = w.ready_at
        self.workers[w.wid] = w
        self.pending[kind].append(w.wid)
        self._push(w.ready_at, "ready", w.wid)
        if kind == "fpga":
            self.totals.fpga_spinups += 1
        else:
            self.totals.cpu_spinups += 1
        return w

    def _allocated(self, kind: str) -> int:
        return len(self.order[kind]) + len(self.pending[kind])

    def _evac_now(self, w: _Worker) -> bool:
        f = self.failures
        return (f is not None and w.evac
                and f.evac_start_s <= self.now < f.evac_end_s)

    def _live_fpgas(self) -> int:
        """Allocator-visible FPGA count: the shrunken live fleet.
        Crashed workers are already off the lists; an active evacuation
        window hides its hash-drawn subset (`ft.elastic.surviving`
        adapted from device meshes to worker-id lists), so the predictor
        re-provisions the shortfall."""
        if self.failures is None:
            return self._allocated("fpga")
        ids = ([wid for _, wid in self.order["fpga"]]
               + list(self.pending["fpga"]))
        return len(surviving(
            ids, lambda wid: self._evac_now(self.workers[wid])))

    def _on_ready(self, wid: int) -> None:
        w = self.workers.get(wid)
        if w is None or w.dealloc_t >= 0:
            return
        self.pending[w.kind].remove(wid)
        insort(self.order[w.kind], (w.available_at, wid))
        if w.kind == "fpga":
            # The RR ring cycles over the provisioned fleet; dispatch-path
            # CPUs stay burst-only (otherwise RR keeps resurrecting them
            # forever, which no real deployment would tolerate; see DESIGN).
            # Kept wid-sorted: without failures ready order IS wid order
            # (identical spin-up delay), with retry-delayed spin-ups the
            # insort preserves the batched engine's wid-ascending ring.
            insort(self.rr_ring, wid)
        if w.available_at <= self.now:
            self._mark_idle(w)

    def _mark_idle(self, w: _Worker) -> None:
        timeout = (self.fleet.fpga_idle_timeout_s if w.kind == "fpga"
                   else self.fleet.cpu_idle_timeout_s)
        w.idle_mark = self.now
        self._push(self.now + timeout, "idle_check", w.wid)

    def _on_idle_check(self, wid: int) -> None:
        w = self.workers.get(wid)
        if w is None or w.dealloc_t >= 0:
            return
        timeout = (self.fleet.fpga_idle_timeout_s if w.kind == "fpga"
                   else self.fleet.cpu_idle_timeout_s)
        if w.available_at <= w.idle_mark and self.now - w.idle_mark >= timeout - 1e-9:
            self._dealloc(w)

    def _dealloc(self, w: _Worker) -> None:
        w.dealloc_t = self.now
        try:
            self.order[w.kind].remove((w.available_at, w.wid))
        except ValueError:
            pass
        if w.wid in self.pending[w.kind]:
            self.pending[w.kind].remove(w.wid)
        if w.wid in self.rr_ring:
            self.rr_ring.remove(w.wid)
        if w.kind == "fpga":
            self.predictor.record_lifetime(
                w.level_at_alloc, self.now - w.alloc_t)

    # ---------- dispatch (Alg. 3) ----------
    def _service(self, kind: str) -> float:
        return self.size / (self.fleet.S if kind == "fpga" else 1.0)

    def _service_w(self, w: _Worker) -> float:
        """Per-worker service time (stragglers serve at rate/factor)."""
        return self._service(w.kind) * w.slow

    def _try_type(self, kind: str) -> _Worker | None:
        slack = self.now + self.deadline - self._service(kind)
        lst = self.order[kind]
        if lst:
            # rightmost worker with available_at <= slack: busiest feasible,
            # or least-idle among the idle ones
            lo, hi = 0, len(lst)
            while lo < hi:
                mid = (lo + hi) // 2
                if lst[mid][0] <= slack:
                    lo = mid + 1
                else:
                    hi = mid
            if lo > 0:
                return self.workers[lst[lo - 1][1]]
        # workers being allocated, most queued load first
        best = None
        for wid in self.pending[kind]:
            w = self.workers[wid]
            if w.available_at + self._service(kind) <= self.now + self.deadline:
                if best is None or w.available_at > best.available_at:
                    best = w
        return best

    def _try_type_f(self, kind: str) -> _Worker | None:
        """Failure-aware `_try_type`: a linear scan instead of the bisect
        — per-worker straggler factors make feasibility non-monotone in
        ``available_at`` and evacuated workers must be skipped. Tie-breaks
        replicate the bisect exactly (ready: max (available_at, wid);
        pending: most queued load, first listed = min wid)."""
        dl = self.now + self.deadline
        best = None
        for avail, wid in self.order[kind]:
            w = self.workers[wid]
            if self._evac_now(w):
                continue
            if avail <= dl - self._service_w(w):
                if best is None or (avail, wid) > (best.available_at,
                                                   best.wid):
                    best = w
        if best is not None:
            return best
        for wid in self.pending[kind]:
            w = self.workers[wid]
            if self._evac_now(w):
                continue
            if w.available_at + self._service_w(w) <= dl:
                if best is None or w.available_at > best.available_at:
                    best = w
        return best

    def _find_worker(self) -> _Worker | None:
        """Delegate the per-request pick to the plugin policy
        (`repro_torch.policies.des`): the policy reads the candidate helpers
        (`_try_type` / `_try_type_f`) and the round-robin cursor off
        this sim; the failure-aware twin replicates the same rules over
        the straggler/evacuation-aware candidate search."""
        if self.failures is not None:
            return self.policy.find_worker_f(self)
        return self.policy.find_worker(self)

    def _find_worker_f(self) -> _Worker | None:
        return self.policy.find_worker_f(self)

    def _assign(self, w: _Worker) -> bool:
        service = self._service_w(w)
        start = max(w.available_at, self.now)
        in_order = w.dealloc_t < 0 and w.ready_at <= self.now
        if in_order:
            try:
                self.order[w.kind].remove((w.available_at, w.wid))
                removed = True
            except ValueError:
                removed = False
        else:
            removed = False
        w.available_at = start + service
        w.busy_s += service
        w.last_assign_t = self.now
        if removed:
            insort(self.order[w.kind], (w.available_at, w.wid))
        self._push(w.available_at, "complete", w.wid)
        if w.kind == "fpga":
            self.F_acc += service
            self.totals.work_on_fpga_cpu_s += self.size
        else:
            # interval load is *occupancy*: equals self.size unless the
            # worker is a straggler (service == size/1.0 when slow == 1)
            self.C_acc += service
            self.totals.work_on_cpu_cpu_s += self.size
        if w.available_at > self.now + self.deadline + 1e-9:
            self.misses += 1
            return True
        return False

    def _crash(self, w: _Worker) -> None:
        """Mid-service crash: the worker dies half a service in. It burns
        half the service as busy time / interval load, leaves dispatch
        immediately, and its lifetime settles (for the predictor's
        per-level stats) only when the crash time is *reached* — ticks
        between the crash draw and the crash time must see the
        pre-crash predictor state, matching the batched engine's lazy
        settlement."""
        service = self._service_w(w)
        t_crash = max(w.available_at, self.now) + service / 2.0
        self.totals.crashes += 1
        w.busy_s += service / 2.0
        if w.kind == "fpga":
            self.F_acc += service / 2.0
        else:
            self.C_acc += service / 2.0
        try:
            self.order[w.kind].remove((w.available_at, w.wid))
        except ValueError:
            pass
        if w.wid in self.pending[w.kind]:
            self.pending[w.kind].remove(w.wid)
        if w.wid in self.rr_ring:
            self.rr_ring.remove(w.wid)
        w.dealloc_t = t_crash    # future-dated: every guard treats it as gone
        if w.kind == "fpga":
            self._push(t_crash, "crash_settle", w.wid)

    def _on_crash_settle(self, wid: int) -> None:
        w = self.workers[wid]
        self.predictor.record_lifetime(w.level_at_alloc,
                                       self.now - w.alloc_t)

    def _on_arrival(self) -> None:
        self.totals.requests += 1
        self.totals.work_cpu_s += self.size
        f = self.failures
        if f is None:
            w = self._find_worker()
            if w is None:
                w = self._spin_up("cpu")
            self._assign(w)
            return
        # deadline-aware failover: up to 1 + max_failover dispatch rounds
        # at this timestamp, each with the request's ORIGINAL deadline. A
        # round is consumed by a stillborn burst spin-up or a crash; when
        # the rounds run out the request is dropped (an SLO violation
        # attributable to failures).
        crash_p = np.float32(f.crash_p)
        crashed_any = False
        for r in range(1 + f.max_failover):
            w = self._find_worker()
            if w is None:
                w = self._spin_up("cpu")
                if w is None:        # stillborn burst CPU
                    continue
            u = failure_u01(f.seed, w.wid, w.n_assigned, DRAW_CRASH)
            w.n_assigned += 1
            if u < crash_p:
                self._crash(w)
                crashed_any = True
                continue
            missed = self._assign(w)
            if crashed_any:
                self.totals.recovered_requests += 1
            if missed and r > 0:
                self.totals.failure_misses += 1
            return
        self.misses += 1
        self.totals.failure_misses += 1

    def _on_complete(self, wid: int) -> None:
        w = self.workers.get(wid)
        if w is None or w.dealloc_t >= 0:
            return
        if w.available_at <= self.now + 1e-12:
            self._mark_idle(w)

    # ---------- allocator (Algs. 1-2) ----------
    def _on_tick(self) -> None:
        if not self.allocate_fpgas:
            self.F_acc = self.C_acc = 0.0
            return
        fleet = self.fleet
        lam = self.F_acc + self.C_acc / fleet.S
        n = int(lam // fleet.T_s)
        if lam - n * fleet.T_s > self.tb:
            n += 1
        n_needed = min(n, self.n_max - 1)
        self.predictor.observe(self.n_lag[1], n_needed)
        self.n_lag = [n_needed, self.n_lag[0]]
        n_curr = self._live_fpgas()
        target = self.predictor.predict(n_needed, n_curr)
        if self.failures is None:
            for _ in range(max(0, target - n_curr)):
                if self._allocated("fpga") >= self.fleet.max_fpgas:
                    break
                self._spin_up("fpga")
        else:
            # attempt count fixed up front (a stillborn attempt must not
            # grant an extra iteration) and allocation levels assigned by
            # attempt index — both match the batched engine's single
            # clip + cumsum; identical to the loop above when no spin-up
            # can fail.
            m = max(0, min(target - n_curr,
                           max(self.fleet.max_fpgas - n_curr, 0)))
            for j in range(m):
                self._spin_up("fpga", level=n_curr + j)
        self.F_acc = self.C_acc = 0.0

    # ---------- main loop ----------
    def _dispatch_event(self, kind: str, payload: int,
                        horizon_s: float) -> None:
        if kind == "ready":
            self._on_ready(payload)
        elif kind == "complete":
            self._on_complete(payload)
        elif kind == "idle_check":
            self._on_idle_check(payload)
        elif kind == "crash_settle":
            self._on_crash_settle(payload)
        elif kind == "tick":
            if self.now < horizon_s:
                self._on_tick()

    def drain_until(self, t: float, horizon_s: float = float("inf")) -> None:
        """Process all internal events up to time t (online API)."""
        while self.events and self.events[0][0] <= t:
            et, _, kind, payload = heapq.heappop(self.events)
            self.now = float(et)
            self._dispatch_event(kind, payload, horizon_s)
        self.now = max(self.now, t)

    def submit(self, t: float) -> None:
        """Submit one request arriving at time t (online API)."""
        self.drain_until(t)
        self.now = float(t)
        self._on_arrival()

    def schedule_ticks(self, horizon_s: float) -> None:
        for k in range(int(np.ceil(horizon_s / self.fleet.T_s))):
            self._push(k * self.fleet.T_s, "tick")

    def run(self, arrival_times: np.ndarray, horizon_s: float) -> RunTotals:
        self.schedule_ticks(horizon_s)
        ai, n_arr = 0, len(arrival_times)
        while self.events or ai < n_arr:
            t_ev = self.events[0][0] if self.events else np.inf
            t_ar = arrival_times[ai] if ai < n_arr else np.inf
            if t_ar <= t_ev:
                self.now = float(t_ar)
                ai += 1
                self._on_arrival()
                continue
            t, _, kind, payload = heapq.heappop(self.events)
            self.now = float(t)
            self._dispatch_event(kind, payload, horizon_s)
        return self._finalize(horizon_s)

    def _finalize(self, horizon_s: float) -> RunTotals:
        tot = self.totals
        for w in self.workers.values():
            spec = self.fleet.fpga if w.kind == "fpga" else self.fleet.cpu
            end = w.dealloc_t if w.dealloc_t >= 0 else max(
                horizon_s, w.available_at)
            life = max(end - w.alloc_t, 0.0)
            busy = w.busy_s
            spin = spec.spin_up_s * (1 + w.n_fail)   # backoff gaps stay idle
            idle = max(life - busy - spin, 0.0)
            busy_j = busy * spec.busy_w
            idle_j = idle * spec.idle_w
            spin_j = spec.spin_up_energy_j + spec.spin_down_energy_j
            tot.energy_j += busy_j + idle_j + spin_j
            tot.cost_usd += (life + spec.spin_down_s) * spec.cost_per_s
            if w.kind == "fpga":
                tot.fpga_busy_j += busy_j
                tot.fpga_idle_j += idle_j
            else:
                tot.cpu_busy_j += busy_j
            tot.spinup_j += spin_j
        tot.energy_j += tot.wasted_spinup_j
        tot.deadline_misses = self.misses
        return tot


def simulate_events(arrival_times: np.ndarray, size_s: float,
                    fleet: FleetParams, dispatcher: str = "spork",
                    energy_weight: float = 1.0, horizon_s: float | None = None,
                    deadline_s: float | None = None,
                    allocate_fpgas: bool = True, n_max: int = 512,
                    failures: FailureSpec | None = None,
                    device: str | torch.device | None = None) -> RunTotals:
    """Convenience wrapper: one app, one policy, exact DES. ``device``
    (None: the card) runs the per-tick `predict`."""
    horizon = float(horizon_s if horizon_s is not None
                    else (arrival_times[-1] + 1.0 if len(arrival_times) else 1.0))
    sim = EventSim(fleet, size_s, dispatcher=dispatcher,
                   energy_weight=energy_weight, deadline_s=deadline_s,
                   n_max=n_max, allocate_fpgas=allocate_fpgas,
                   failures=failures, device=device)
    return sim.run(np.asarray(arrival_times, dtype=np.float64), horizon)
