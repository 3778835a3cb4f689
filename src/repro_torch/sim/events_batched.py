"""Batched event-driven simulator: per-request dispatch for a chunk of cells.

Port of `repro.sim.events_batched`. The exact serial DES
(`repro_torch.sim.events.EventSim`) is the semantic oracle for the paper's
Table 9 (dispatch-policy ablation: efficient-first 'spork', AutoScale-
style index packing, MArk-style round robin). This module re-expresses
the same semantics as fixed-shape tensor programs so a whole Table 9 grid
runs in a handful of chunk dispatches:

  * A fixed-size **worker state table** replaces the heap: FPGA slots in
    ``[0, w_fpga)``, CPU slots in ``[w_fpga, w_fpga + w_cpu)`` (the kind
    is the slot position), per slot wid / alive / alloc_t / ready_at /
    available_at / busy_s / allocation level. Slots are reused after
    deallocation; the monotone ``wid`` keeps the oracle's tie-breaking
    and round-robin-ring order.
  * **Lazy lifecycle events**: a worker's ready and idle-timeout times are
    functions of its row, so arrivals mask timed-out workers out of the
    candidate sets and the dealloc *settlement* (energy, cost, the
    predictor's lifetime stats, slot reclamation) runs at interval ticks
    and the final drain.
  * **Branch-free dispatch** (paper Alg. 3): each arrival does three
    reductions — ring ranks over the FPGA region, one max over the four
    (kind x ready/pending) candidate groups plus the ring size, one max
    resolving wid tie-breaks, the cyclic ring priority and the first free
    CPU slot — and everything else is elementwise.
  * **Flat entry stream**: the run walks fixed-width arrival blocks of
    ``BLOCK`` arrivals with tick entries riding on the last block of each
    interval, built host-side, so every Spork tick (Algs. 1-2, through
    `core.predictor.allocator_tick` and the `spork_predict` kernel) lands
    between the right two arrivals.

Where the reference vmaps one cell over a nested `lax.scan`, every tensor
here carries a leading cell axis ``(C, ...)`` and a Python loop walks the
entries. Each arrival block goes through `kernels.arrival.ops.bind`:
the hand-written CUDA kernel for a carry on the card, the plain PyTorch
loop over `_arrival_step` / `_arrival_fail` for a carry on the CPU. Each
tick runs in PyTorch on the carry's device.

Sums over the worker table (interval loads, settled energies, lifetime
statistics) are taken in float64 and rounded once to float32. Float32
values of one run span far less than float64's extra 29 bits, so these
sums are exact and the card and the CPU agree on them bit for bit,
whatever order their reductions take; on dyadic instances they equal the
reference's float32 sums.

Equivalence contract (tests/test_torch_events_batched.py): on
integer-quantized instances the engine matches `EventSim` exactly on
requests, deadline misses, spin-up counts and work split, and to ~1e-5
relative on energy/cost. ``RunTotals.breakdown['slot_overflow']`` counts
dispatch/allocation events dropped because a table region was full.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Iterable, NamedTuple

import numpy as np
import torch

from repro_torch.core.breakeven import ObjectiveCoeffs, objective_setup
from repro_torch.core.metrics import RunTotals
from repro_torch.core.predictor import allocator_tick
from repro_torch.core.workers import DEFAULT_FLEET, FleetParams
from repro_torch.ft.failures import (DRAW_CRASH, DRAW_EVAC, DRAW_SPINUP,
                                     DRAW_STRAGGLE, FailStatic, FailureSpec,
                                     failure_u01)
from repro_torch.policies import (Candidates, dispatch_policies,
                                  dispatch_select)
from repro_torch.sim.ratesim import Accum

#: name -> policy code (from the registry)
DISPATCH_CODES = {p.name: p.code for p in dispatch_policies()}

_NEG = -torch.inf

# Arrival-block width of the entry stream.
BLOCK = 128

# Upper bound on cells per dispatch; the cell axis is padded to the next
# power of two up to this cap (padding repeats cell 0; padded results are
# discarded), larger grids run in chunks of the cap.
EV_CHUNK_MAX = 32

_F32, _I32 = torch.float32, torch.int32


class EventScalars(NamedTuple):
    """Per-cell parameters, each a ``(C,)`` tensor."""

    size: torch.Tensor        # request service time on a CPU worker (s)
    deadline: torch.Tensor    # completion deadline (s)
    S: torch.Tensor           # FPGA speedup over CPU
    T_s: torch.Tensor         # scheduling interval
    tb: torch.Tensor          # breakeven threshold (objective-dependent)
    co_min: torch.Tensor      # Alg. 2 objective coefficients
    co_over: torch.Tensor
    co_under: torch.Tensor
    amort_unit: torch.Tensor
    A_f_s: torch.Tensor       # FPGA spin-up seconds
    A_c_s: torch.Tensor       # CPU spin-up seconds
    to_f: torch.Tensor        # FPGA idle timeout (= T_s)
    to_c: torch.Tensor        # CPU idle timeout
    B_f: torch.Tensor         # busy / idle watts
    I_f: torch.Tensor
    B_c: torch.Tensor
    I_c: torch.Tensor
    C_f: torch.Tensor         # $/s
    C_c: torch.Tensor
    spin_e_f: torch.Tensor    # spin-up + spin-down energy per worker (J)
    spin_e_c: torch.Tensor
    d_f_s: torch.Tensor       # spin-down seconds
    d_c_s: torch.Tensor
    # failure axis (FailureSpec.floats() order); the static part
    # (enabled + retry/failover bounds) is `FailStatic`
    f_spin_p: torch.Tensor    # per-attempt spin-up failure probability
    f_backoff: torch.Tensor   # seconds between spin-up attempts
    f_crash_p: torch.Tensor   # per-assignment mid-service crash probability
    f_sfrac: torch.Tensor     # straggler fraction / slowdown factor
    f_sfactor: torch.Tensor
    f_evac0: torch.Tensor     # evacuation window [start, end)
    f_evac1: torch.Tensor
    f_efrac: torch.Tensor     # evacuated fraction
    f_seed: torch.Tensor      # int64 uint32 hash seed
    max_fpgas: torch.Tensor   # int32 N_f cap
    allocate: torch.Tensor    # bool: run the Spork allocator at ticks

    @property
    def coeffs(self) -> ObjectiveCoeffs:
        return ObjectiveCoeffs(self.co_min, self.co_over, self.co_under,
                               self.amort_unit)


#: The float fields of `EventScalars`, in order (the kernel's per-cell
#: parameter row).
FLOAT_FIELDS = EventScalars._fields[:-3]


class WorkerTable(NamedTuple):
    """Fixed-size per-worker state, each a ``(C, W)`` tensor. FPGA slots
    first, CPU slots after; ``wid`` is the monotone allocation id that
    defines every ordering the oracle derives from list positions."""

    wid: torch.Tensor         # int32, 0 = never used
    alive: torch.Tensor       # bool
    alloc_t: torch.Tensor     # f32
    ready_at: torch.Tensor    # f32 spin-up completion
    avail: torch.Tensor       # f32 queue-drain time
    busy: torch.Tensor        # f32 accumulated service seconds
    level: torch.Tensor       # int32 allocation level at spin-up
    # failure-axis columns (constant when the axis is off)
    n_assign: torch.Tensor    # int32 per-worker assignment counter
    crash_t: torch.Tensor     # f32 crash time, +inf = not crashed
    slow: torch.Tensor        # f32 straggler multiplier (1.0 normal)
    nfail: torch.Tensor       # int32 failed spin-up attempts before ready


class FailAcc(NamedTuple):
    """Resilience counters (RunTotals extension), each ``(C,)``; all zero
    when the failure axis is off."""

    retries: torch.Tensor        # i32 failed-then-retried spin-up attempts
    failed_spins: torch.Tensor   # i32 failed attempts incl. stillborn
    crashes: torch.Tensor        # i32 workers lost mid-service
    recovered: torch.Tensor      # i32 crashed requests served by failover
    fail_misses: torch.Tensor    # i32 misses attributable to failures
    dropped: torch.Tensor        # i32 requests dropped (failover exhausted)
    cpu_spins: torch.Tensor      # i32 CPU spin-ups (incl. stillborn)
    wasted_j: torch.Tensor       # f32 energy of failed spin-up attempts
    extra_cost: torch.Tensor     # f32 cost of failed spin-up attempts
    work_f: torch.Tensor         # f32 cpu-seconds served on FPGAs
    work_c: torch.Tensor         # f32 cpu-seconds served on CPUs


class EvCarry(NamedTuple):
    """Arrival-level carry: the worker table plus per-slot accumulators
    (summed only at ticks and at the end, so arrivals never reduce them)."""

    ws: WorkerTable
    serv_slot: torch.Tensor   # (C, W) f32 service-seconds ever dispatched
    miss_slot: torch.Tensor   # (C, W) f32 deadline misses
    next_wid: torch.Tensor    # (C,) i32 monotone wid counter
    rr_pos: torch.Tensor      # (C,) i32 raw round-robin cursor
    overflow: torch.Tensor    # (C,) i32 events dropped for lack of a slot
    fail: FailAcc


class TickState(NamedTuple):
    """Interval-level state, untouched by arrival steps."""

    H: torch.Tensor           # (C, n_max, n_max) conditional histograms
    n_lag: torch.Tensor       # (C, 2) i32
    life_sum: torch.Tensor    # (C, n_max) f32 per-level lifetime stats
    life_cnt: torch.Tensor    # (C, n_max) f32
    F_prev: torch.Tensor      # (C,) f32 F_slot total at the last tick
    C_prev: torch.Tensor      # (C,) f32 C_slot total at the last tick
    spins: torch.Tensor       # (C,) f32 FPGA spin-up count
    energy: torch.Tensor      # (C, 6) f32: fpga_busy/fpga_idle/cpu_busy/
                              #   cpu_idle/spin_j/cost settlements


def _col(x: torch.Tensor) -> torch.Tensor:
    """A per-cell ``(C,)`` tensor as a ``(C, 1)`` column."""
    return x[:, None]


def _exact_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """float32 sum taken in float64 and rounded once: exact for the value
    ranges of one run, so independent of the reduction order."""
    return x.to(torch.float64).sum(dim=dim).to(_F32)


def _kind(is_f: torch.Tensor, f: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Per slot: the FPGA value ``f`` or the CPU value ``c`` (``(C,)``)."""
    return torch.where(is_f, _col(f), _col(c))


def _fail_zero(cells: int, device) -> FailAcc:
    zi = torch.zeros(cells, dtype=_I32, device=device)
    zf = torch.zeros(cells, dtype=_F32, device=device)
    return FailAcc(zi, zi, zi, zi, zi, zi, zi, zf, zf, zf, zf)


def init_carry(cells: int, W: int, device) -> EvCarry:
    """The empty table every run starts from."""
    def zi():
        return torch.zeros((cells, W), dtype=_I32, device=device)

    def zf():
        return torch.zeros((cells, W), dtype=_F32, device=device)

    ws = WorkerTable(wid=zi(), alive=torch.zeros((cells, W), dtype=torch.bool,
                                                 device=device),
                     alloc_t=zf(), ready_at=zf(), avail=zf(), busy=zf(),
                     level=zi(), n_assign=zi(),
                     crash_t=torch.full((cells, W), torch.inf, device=device),
                     slow=torch.ones((cells, W), device=device), nfail=zi())
    z = torch.zeros(cells, dtype=_I32, device=device)
    return EvCarry(ws, zf(), zf(), z, z, z, _fail_zero(cells, device))


def init_tick_state(cells: int, n_max: int, device) -> TickState:
    def zf(*s):
        return torch.zeros((cells, *s), dtype=_F32, device=device)
    return TickState(H=zf(n_max, n_max),
                     n_lag=torch.zeros((cells, 2), dtype=_I32, device=device),
                     life_sum=zf(n_max), life_cnt=zf(n_max), F_prev=zf(),
                     C_prev=zf(), spins=zf(), energy=zf(6))


def _settle(es: EventScalars, is_f, c: EvCarry, ts: TickState, t, gate):
    """Dealloc settlement: retire every worker whose idle timeout (or
    crash time) passed strictly before ``t`` ``(C,)``, for the cells
    where ``gate`` ``(C,)`` holds (True: every cell). Arrivals only
    *mask* timed-out workers, so applying the accounting lazily here
    (ticks + final drain) is exact — each row is frozen from its timeout
    on. Matches EventSim._dealloc + _finalize per worker."""
    ws = c.ws
    idle_d = torch.maximum(ws.ready_at, ws.avail) + _kind(is_f, es.to_f,
                                                          es.to_c)
    # crashed rows settle at their (future-dated) crash time; the strict <
    # reproduces the oracle's tick-before-crash_settle order
    dtime = torch.where(ws.crash_t < torch.inf, ws.crash_t, idle_d)
    m = ws.alive & (dtime < _col(t))
    if gate is not True:
        m = m & _col(gate)
    mf = m.to(_F32)
    life = dtime - ws.alloc_t
    spin_s = _kind(is_f, es.A_f_s, es.A_c_s) * (1.0 + ws.nfail.to(_F32))
    idle = torch.clamp(life - ws.busy - spin_s, min=0.0)
    busy_j = ws.busy * _kind(is_f, es.B_f, es.B_c)
    idle_j = idle * _kind(is_f, es.I_f, es.I_c)
    cost = (life + _kind(is_f, es.d_f_s, es.d_c_s)) * _kind(is_f, es.C_f,
                                                            es.C_c)
    isf = is_f.to(_F32)
    energy = ts.energy + _exact_sum(torch.stack([
        mf * isf * busy_j, mf * isf * idle_j,
        mf * (1 - isf) * busy_j, mf * (1 - isf) * idle_j,
        mf * _kind(is_f, es.spin_e_f, es.spin_e_c), mf * cost], dim=1))
    # per-level lifetime statistics of the settled FPGAs: a float64
    # scatter of float32 values is exact, so atomics on the card add up
    # to the CPU's bits
    n_max = ts.life_sum.shape[-1]
    rec = m & is_f
    lvl = torch.clamp(ws.level, max=n_max - 1).long()
    life_add = torch.zeros(ts.life_sum.shape, dtype=torch.float64,
                           device=life.device).scatter_add_(
        1, lvl, torch.where(rec, life, 0.0).to(torch.float64))
    cnt_add = torch.zeros_like(life_add).scatter_add_(
        1, lvl, rec.to(torch.float64))
    ts = ts._replace(
        energy=energy,
        life_sum=(ts.life_sum.to(torch.float64) + life_add).to(_F32),
        life_cnt=(ts.life_cnt.to(torch.float64) + cnt_add).to(_F32))
    return c._replace(ws=ws._replace(alive=ws.alive & ~m)), ts


def _evac_ok(es: EventScalars, t, wid):
    """Feasibility mask for the evacuation window (EventSim._evac_now):
    False while a worker's hash-drawn evacuation membership is inside an
    active window. ``t`` is ``(C,)``, ``wid`` ``(C, W)``."""
    member = (failure_u01(_col(es.f_seed), wid, 0, DRAW_EVAC, xp=torch)
              < _col(es.f_efrac))
    active = (es.f_evac0 <= t) & (t < es.f_evac1)
    return ~(member & _col(active))


def _spin_fails(es: EventScalars, wid, R: int):
    """Leading-failure count of the spin-up attempt draws for ``wid``
    (``(C,)`` or ``(C, W)``; counter = attempt index), capped at R + 1 ==
    stillborn. Mirrors the oracle's while loop in EventSim._spin_up."""
    seed = es.f_seed if wid.dim() == 1 else _col(es.f_seed)
    p = es.f_spin_p if wid.dim() == 1 else _col(es.f_spin_p)
    nf = torch.zeros(wid.shape, dtype=_I32, device=wid.device)
    run = torch.ones(wid.shape, dtype=torch.bool, device=wid.device)
    for k in range(R + 1):
        run = run & (failure_u01(seed, wid, k, DRAW_SPINUP, xp=torch) < p)
        nf = nf + run.to(_I32)
    return nf


def _slow_draw(es: EventScalars, wid):
    """Straggler multiplier drawn once per worker at spin-up (``wid``
    ``(C,)`` or ``(C, W)``)."""
    col = (lambda x: x) if wid.dim() == 1 else _col
    u = failure_u01(col(es.f_seed), wid, 0, DRAW_STRAGGLE, xp=torch)
    return torch.where(u < col(es.f_sfrac), col(es.f_sfactor),
                       torch.ones((), device=wid.device))


def _find_candidates(es: EventScalars, code, w_f: int, is_f, idxW,
                     ws: WorkerTable, rr_pos, t, svc_w, live, ok):
    """Alg. 3 candidate search shared by the pristine and failure-aware
    arrival paths (`EventSim._try_type` / `_try_type_f` for the rules).
    ``t`` is ``(C,)``; ``svc_w`` the per-slot service time (straggler-
    scaled when the failure axis is on); ``ok`` the evacuation mask —
    evacuated workers keep their ring *positions* but are skipped.

    Returns (found, oh_cand, rr_found, n_ring, rank_win, any_free,
    slot_idx). ``rank_win`` is meaningful only where ``rr_found``."""
    W = idxW.shape[0]
    tc = _col(t)
    ready = live & (ws.ready_at < tc)
    pend = live & ~ready
    widf = ws.wid.to(_F32)

    # ring ranks: wid-comparison matrix over the FPGA region only
    ringf = ready[:, :w_f]
    wf = ws.wid[:, :w_f]
    less = (ringf[:, None, :] & ringf[:, :, None]
            & (wf[:, None, :] < wf[:, :, None]))
    rank = less.sum(dim=2, dtype=_I32)                        # (C, w_f)
    dl = tc + _col(es.deadline)
    slack = dl - svc_w
    feas_rr = (ringf & ok[:, :w_f]
               & (torch.maximum(ws.avail[:, :w_f], tc) <= slack[:, :w_f]))

    def pad(x, value):
        return torch.nn.functional.pad(x, (0, W - w_f), value=value)

    # reduction 1: candidate availabilities (4 groups) + ring size
    g_fr = ready & is_f & ok & (ws.avail <= slack)
    g_cr = ready & ~is_f & ok & (ws.avail <= slack)
    g_fp = pend & is_f & ok & (ws.avail + svc_w <= dl)
    g_cp = pend & ~is_f & ok & (ws.avail + svc_w <= dl)
    nring_v = pad(torch.where(ringf, (rank + 1).to(_F32), _NEG), _NEG)
    r1 = torch.stack([
        torch.where(g_fr, ws.avail, _NEG), torch.where(g_cr, ws.avail, _NEG),
        torch.where(g_fp, ws.avail, _NEG), torch.where(g_cp, ws.avail, _NEG),
        nring_v], dim=1).amax(dim=2)                          # (C, 5)
    am_fr, am_cr, am_fp, am_cp, nring_f = r1.unbind(1)
    any_fr, any_cr = am_fr > _NEG, am_cr > _NEG
    n_ring = torch.clamp(nring_f, min=1.0).to(_I32)

    # reduction 2: wid tie-breaks, cyclic ring priority, first free slot
    s = rr_pos % n_ring
    key = torch.where(rank < _col(s), rank + w_f, rank)
    keyv = pad(torch.where(feas_rr, -key.to(_F32), _NEG), _NEG)
    free_c = ~ws.alive & ~is_f
    t_fr = g_fr & (ws.avail == _col(am_fr))
    t_cr = g_cr & (ws.avail == _col(am_cr))
    t_fp = g_fp & (ws.avail == _col(am_fp))
    t_cp = g_cp & (ws.avail == _col(am_cp))
    r2 = torch.stack([
        torch.where(t_fr, widf, _NEG), torch.where(t_cr, widf, _NEG),
        torch.where(t_fp, -widf, _NEG), torch.where(t_cp, -widf, _NEG),
        keyv, torch.where(free_c, -idxW, _NEG)], dim=1).amax(dim=2)
    kmin = -r2[:, 4]
    rr_found = r2[:, 4] > _NEG
    slot_idx = -r2[:, 5]
    any_free = r2[:, 5] > _NEG
    # kmin is +inf where no ring worker is feasible: cast only under rr_found
    rank_win = torch.where(rr_found, kmin, 0.0).to(_I32) % w_f

    # winner one-hots (elementwise; tie values from reduction 2)
    oh_f = torch.where(_col(any_fr), t_fr & (widf == r2[:, 0:1]),
                       t_fp & (widf == -r2[:, 2:3]))
    oh_c = torch.where(_col(any_cr), t_cr & (widf == r2[:, 1:2]),
                       t_cp & (widf == -r2[:, 3:4]))
    oh_rr = pad(feas_rr & (key.to(_F32) == _col(kmin)), False)

    # policy select: every registered policy's `combine`, per cell code
    cand = Candidates(f_found=any_fr | (am_fp > _NEG),
                      c_found=any_cr | (am_cp > _NEG),
                      av_f=torch.where(any_fr, am_fr, am_fp),
                      av_c=torch.where(any_cr, am_cr, am_cp),
                      oh_f=oh_f, oh_c=oh_c, rr_found=rr_found, oh_rr=oh_rr)
    found, oh_cand = dispatch_select(code, cand)
    return found, oh_cand, rr_found, n_ring, rank_win, any_free, slot_idx


def _arrival_step(es: EventScalars, code, w_f: int, is_f, idxW,
                  c: EvCarry, t) -> EvCarry:
    """One request arrival per cell (``t`` ``(C,)``, +inf = none): Alg. 3
    dispatch under each cell's policy code, CPU spin-up fallback,
    assignment + per-slot accounting.

    Candidate rules (EventSim._try_type): ready workers (ready_at < t —
    the oracle processes arrivals before same-time ready events) busiest
    feasible first with max-wid tie-break; pending workers most queued
    load first with min-wid tie-break. The round-robin ring is the
    wid-ascending list of ready FPGAs with a raw positional cursor that is
    *not* adjusted when removals shrink the ring, like the oracle's; the
    cyclic scan from cursor position s resolves by minimizing the key
    (rank < s)*w_f + rank, whose minimizer k also yields the new cursor
    (k % w_f + 1) % n_ring.

    This is the *pristine* path (failure axis off); the failure-aware
    twin is `_arrival_fail`."""
    ws = c.ws
    real = torch.isfinite(t)
    tc = _col(t)
    svc_w = _kind(is_f, es.size / es.S, es.size)              # (C, W)
    dtime = torch.maximum(ws.ready_at, ws.avail) + _kind(is_f, es.to_f,
                                                         es.to_c)
    live = ws.alive & (dtime >= tc)
    ok = torch.ones_like(live)
    found, oh_cand, rr_found, n_ring, rank_win, any_free, slot_idx = \
        _find_candidates(es, code, w_f, is_f, idxW, ws, c.rr_pos, t,
                         svc_w, live, ok)
    rr_pos = torch.where(real & (code == 2) & rr_found,
                         (rank_win + 1) % n_ring, c.rr_pos)

    # no feasible worker: spin up a CPU in the first free CPU slot
    spin = real & ~found & any_free
    over = (real & ~found & ~any_free).to(_I32)
    oh_spin = (idxW == _col(slot_idx)) & _col(spin)
    do = real & (found | spin)
    oh_do = torch.where(_col(found), oh_cand, oh_spin) & _col(do)

    # assignment (EventSim._assign), all elementwise
    dl = tc + _col(es.deadline)
    t_ready = tc + _col(es.A_c_s)
    avail_base = torch.where(oh_spin, t_ready, ws.avail)
    new_av = torch.maximum(avail_base, tc) + svc_w
    missed = oh_do & (new_av > dl + 1e-9)
    ws = ws._replace(
        wid=torch.where(oh_spin, _col(c.next_wid + 1), ws.wid),
        alive=ws.alive | oh_spin,
        alloc_t=torch.where(oh_spin, tc, ws.alloc_t),
        ready_at=torch.where(oh_spin, t_ready, ws.ready_at),
        avail=torch.where(oh_do, new_av, ws.avail),
        busy=torch.where(oh_do, torch.where(oh_spin, 0.0, ws.busy) + svc_w,
                         ws.busy))
    return c._replace(
        ws=ws, serv_slot=c.serv_slot + oh_do.to(_F32) * svc_w,
        miss_slot=c.miss_slot + missed.to(_F32),
        next_wid=c.next_wid + spin.to(_I32), rr_pos=rr_pos,
        overflow=c.overflow + over)


def _arrival_fail(es: EventScalars, fstat: FailStatic, code, w_f: int,
                  is_f, idxW, c: EvCarry, t) -> EvCarry:
    """Failure-aware arrival: EventSim._on_arrival's deadline-aware
    failover loop, unrolled over ``1 + max_failover`` rounds. Each round
    runs the full candidate search; a round is consumed by a stillborn
    burst spin-up or a mid-service crash (the request re-enters dispatch
    at the same timestamp with its *original* deadline); a surviving
    assignment ends the loop; exhaustion drops the request (counted as a
    deadline miss attributable to failures). Rounds after every cell's
    request is placed would change nothing and are skipped (one host read
    per round)."""
    real = torch.isfinite(t)
    tc = _col(t)
    dl = tc + _col(es.deadline)
    R = fstat.max_retries
    act = real
    crashed_any = torch.zeros_like(real)
    base_svc = _kind(is_f, es.size / es.S, es.size)
    for r in range(1 + fstat.max_failover):
        if r > 0 and not bool(act.any()):
            break           # every request placed: the rest are no-ops
        ws, fl = c.ws, c.fail
        svc_w = base_svc * ws.slow
        idle_d = torch.maximum(ws.ready_at, ws.avail) + _kind(is_f, es.to_f,
                                                              es.to_c)
        # crashed workers leave dispatch the instant the crash is drawn
        live = ws.alive & (idle_d >= tc) & (ws.crash_t == torch.inf)
        ok = _evac_ok(es, t, ws.wid)
        found, oh_cand, rr_found, n_ring, rank_win, any_free, slot_idx = \
            _find_candidates(es, code, w_f, is_f, idxW, ws, c.rr_pos, t,
                             svc_w, live, ok)
        rr_pos = torch.where(act & (code == 2) & rr_found,
                             (rank_win + 1) % n_ring, c.rr_pos)

        # burst CPU spin-up with bounded retries; stillborn allocations
        # consume the wid + the failover round but never join the table
        spin = act & ~found & any_free
        over = (act & ~found & ~any_free).to(_I32)
        oh_spin = (idxW == _col(slot_idx)) & _col(spin)
        new_wid = c.next_wid + 1
        nf_new = _spin_fails(es, new_wid, R)
        still = nf_new > R
        spin_ok = spin & ~still
        spin_still = spin & still
        oh_occ = oh_spin & _col(spin_ok)
        nf_f = nf_new.to(_F32)
        a_c_eff = es.A_c_s * (1.0 + nf_f) + es.f_backoff * nf_f
        slow_new = _slow_draw(es, new_wid)
        spin_i = spin.to(_I32)
        fl = fl._replace(
            failed_spins=fl.failed_spins + spin_i * nf_new,
            retries=fl.retries + spin_i * torch.clamp(nf_new, max=R),
            wasted_j=fl.wasted_j
            + torch.where(spin, nf_f * (es.A_c_s * es.B_c), 0.0),
            extra_cost=fl.extra_cost + torch.where(
                spin_still,
                ((R + 1) * es.A_c_s + R * es.f_backoff) * es.C_c, 0.0),
            cpu_spins=fl.cpu_spins + spin_ok.to(_I32))

        # crash draw per assignment, keyed (wid, n_assigned); the worker
        # dies half a service in, burning half the service as busy time
        # and interval load (EventSim._crash)
        do = act & (found | spin_ok)
        oh_do = torch.where(_col(found), oh_cand, oh_spin) & _col(do)
        wid_eff = torch.where(oh_spin, _col(new_wid), ws.wid)
        nass_eff = torch.where(oh_spin, 0, ws.n_assign)
        crash_u = failure_u01(_col(es.f_seed), wid_eff, nass_eff, DRAW_CRASH,
                              xp=torch)
        crashed = oh_do & (crash_u < _col(es.f_crash_p))
        svc_used = torch.where(oh_spin, _col(es.size * slow_new), svc_w)
        t_occ = tc + _col(a_c_eff)
        start = torch.maximum(torch.where(oh_spin, t_occ, ws.avail), tc)
        new_av = start + svc_used
        half = svc_used * 0.5
        t_crash = start + half
        served = oh_do & ~crashed
        missed = served & (new_av > dl + 1e-9)
        used = torch.where(crashed, half, svc_used)
        ws = ws._replace(
            wid=torch.where(oh_occ, _col(new_wid), ws.wid),
            alive=ws.alive | oh_occ,
            alloc_t=torch.where(oh_occ, tc, ws.alloc_t),
            ready_at=torch.where(oh_occ, t_occ, ws.ready_at),
            avail=torch.where(served, new_av,
                              torch.where(oh_occ, t_occ, ws.avail)),
            busy=torch.where(oh_do, torch.where(oh_occ, 0.0, ws.busy) + used,
                             ws.busy),
            n_assign=torch.where(oh_do,
                                 torch.where(oh_occ, 0, ws.n_assign) + 1,
                                 ws.n_assign),
            crash_t=torch.where(crashed, t_crash,
                                torch.where(oh_occ, torch.inf, ws.crash_t)),
            slow=torch.where(oh_occ, _col(slow_new), ws.slow),
            nfail=torch.where(oh_occ, _col(nf_new), ws.nfail))

        served_s = served.any(dim=1)
        crash_s = crashed.any(dim=1)
        win_f = (served & is_f).any(dim=1)
        fl = fl._replace(
            crashes=fl.crashes + crash_s.to(_I32),
            recovered=fl.recovered + (served_s & crashed_any).to(_I32),
            work_f=fl.work_f + torch.where(win_f, es.size, 0.0),
            work_c=fl.work_c + torch.where(served_s & ~win_f, es.size, 0.0))
        if r > 0:
            fl = fl._replace(fail_misses=fl.fail_misses
                             + missed.any(dim=1).to(_I32))
        c = c._replace(
            ws=ws, serv_slot=c.serv_slot + torch.where(oh_do, used, 0.0),
            miss_slot=c.miss_slot + missed.to(_F32),
            next_wid=c.next_wid + spin_i, rr_pos=rr_pos,
            overflow=c.overflow + over, fail=fl)
        crashed_any = crashed_any | crash_s
        act = act & (spin_still | crash_s)

    dropped = act.to(_I32)      # failover rounds exhausted
    fl = c.fail
    return c._replace(fail=fl._replace(dropped=fl.dropped + dropped,
                                       fail_misses=fl.fail_misses + dropped))


def _tick_step(es: EventScalars, fstat: FailStatic, w_f: int, is_f,
               c: EvCarry, ts: TickState, t, active):
    """Per-interval Spork allocator (Algs. 1-2, EventSim._on_tick), for
    the cells where ``active`` ``(C,)`` holds: settle deallocs preceding
    the tick, observe + predict through `allocator_tick` (gated, so
    inactive cells keep H and n_lag), then spin up the shortfall into free
    FPGA slots (monotone wids, allocation levels counted like the oracle).
    Inactive cells leave all state bit-unchanged.

    With the failure axis on, the allocator sees the *shrunken* live
    fleet — crashed and evacuated FPGAs are excluded from ``n_curr`` —
    and each of the m provisioning attempts can fail: a stillborn attempt
    consumes its wid and allocation level but leaves the slot free."""
    c, ts = _settle(es, is_f, c, ts, t, active)
    ws = c.ws
    W = is_f.shape[0]
    vis = ws.alive & is_f
    if fstat.enabled:
        vis = vis & (ws.crash_t == torch.inf) & _evac_ok(es, t, ws.wid)
    n_curr = vis.sum(dim=1, dtype=_I32)
    F_tot = _exact_sum(c.serv_slot[:, :w_f])
    C_tot = _exact_sum(c.serv_slot[:, w_f:])
    lam = (F_tot - ts.F_prev) + (C_tot - ts.C_prev) / es.S
    do_alloc = active & es.allocate
    H, n_lag, target = allocator_tick(
        ts.H, ts.life_sum, ts.life_cnt, ts.n_lag, lam, n_curr, es.coeffs,
        es.T_s, es.tb, gate=do_alloc)
    room = torch.clamp(es.max_fpgas - n_curr, min=0)
    m = torch.where(do_alloc,
                    torch.minimum(torch.clamp(target - n_curr, min=0), room),
                    0)
    free_f = ~ws.alive[:, :w_f]
    fr = torch.cumsum(free_f.to(_I32), dim=1, dtype=_I32) - 1
    take = torch.nn.functional.pad(free_f & (fr < _col(m)), (0, W - w_f),
                                   value=False)
    frW = torch.nn.functional.pad(fr, (0, W - w_f))
    n_take = take.sum(dim=1, dtype=_I32)
    tc = _col(t)
    new_wids = _col(c.next_wid + 1) + frW
    if not fstat.enabled:
        t_up = tc + _col(es.A_f_s)
        ws = ws._replace(
            wid=torch.where(take, new_wids, ws.wid),
            alive=ws.alive | take,
            alloc_t=torch.where(take, tc, ws.alloc_t),
            ready_at=torch.where(take, t_up, ws.ready_at),
            avail=torch.where(take, t_up, ws.avail),
            busy=torch.where(take, 0.0, ws.busy),
            level=torch.where(take, _col(n_curr) + frW, ws.level))
        n_spun = n_take
    else:
        R = fstat.max_retries
        nf = _spin_fails(es, new_wids, R)
        still = nf > R
        succeed = take & ~still
        nf_f = nf.to(_F32)
        t_up = tc + (_col(es.A_f_s) * (1.0 + nf_f) + _col(es.f_backoff) * nf_f)
        takef = take.to(_F32)
        takei = take.to(_I32)
        fl = c.fail
        c = c._replace(fail=fl._replace(
            failed_spins=fl.failed_spins + (takei * nf).sum(dim=1, dtype=_I32),
            retries=fl.retries
            + (takei * torch.clamp(nf, max=R)).sum(dim=1, dtype=_I32),
            wasted_j=fl.wasted_j
            + _exact_sum(takef * nf_f) * (es.A_f_s * es.B_f),
            extra_cost=fl.extra_cost
            + _exact_sum((take & still).to(_F32))
            * (((R + 1) * es.A_f_s + R * es.f_backoff) * es.C_f)))
        ws = ws._replace(
            wid=torch.where(take, new_wids, ws.wid),
            alive=ws.alive | succeed,
            alloc_t=torch.where(succeed, tc, ws.alloc_t),
            ready_at=torch.where(succeed, t_up, ws.ready_at),
            avail=torch.where(succeed, t_up, ws.avail),
            busy=torch.where(succeed, 0.0, ws.busy),
            level=torch.where(take, _col(n_curr) + frW, ws.level),
            n_assign=torch.where(succeed, 0, ws.n_assign),
            crash_t=torch.where(succeed, torch.inf, ws.crash_t),
            slow=torch.where(succeed, _slow_draw(es, new_wids), ws.slow),
            nfail=torch.where(succeed, nf, ws.nfail))
        n_spun = succeed.sum(dim=1, dtype=_I32)
    c = c._replace(ws=ws, next_wid=c.next_wid + n_take,
                   overflow=c.overflow + torch.where(do_alloc, m - n_take, 0))
    ts = ts._replace(
        H=H, n_lag=n_lag,
        F_prev=torch.where(active, F_tot, ts.F_prev),
        C_prev=torch.where(active, C_tot, ts.C_prev),
        spins=ts.spins + n_spun.to(_F32))
    return c, ts


def _simulate_cells(n_max: int, w_fpga: int, w_cpu: int, fstat: FailStatic,
                    es: EventScalars, codes: torch.Tensor,
                    times: torch.Tensor, tick_t: torch.Tensor,
                    is_tick: torch.Tensor) -> tuple:
    """Cell-batched core: ``times`` ``(C, E, BLOCK)`` (+inf-padded),
    ``tick_t``/``is_tick`` ``(C, E)``, ``codes`` and every `EventScalars`
    leaf ``(C,)``, all on one device. Each entry applies one arrival block
    per cell (`kernels.arrival.ops.bind`, bound once per chunk), then one
    tick gated per cell; an entry where no cell ticks skips the tick,
    which would leave every cell bit-unchanged. ``fstat`` selects the pristine or the
    failure-aware arrival path. Returns ``(Accum, FailAcc, overflow)``,
    every leaf ``(C,)``."""
    # imported here: the kernel package imports this module
    from repro_torch.kernels.arrival.ops import bind

    cells, n_entries = tick_t.shape
    dev = times.device
    W = w_fpga + w_cpu
    is_f = torch.arange(W, device=dev) < w_fpga
    c = init_carry(cells, W, dev)
    ts = init_tick_state(cells, n_max, dev)
    ticks = is_tick.any(dim=0).tolist()            # one host read per chunk
    arrivals = bind(es, fstat, codes, w_fpga)
    for e in range(n_entries):
        c = arrivals(c, times[:, e])
        if ticks[e]:
            c, ts = _tick_step(es, fstat, w_fpga, is_f, c, ts, tick_t[:, e],
                               is_tick[:, e])
    return _finish(es, fstat, w_fpga, is_f, c, ts)


def _finish(es: EventScalars, fstat: FailStatic, w_fpga: int, is_f,
            c: EvCarry, ts: TickState) -> tuple:
    """Final drain (every remaining worker idles out at its own timeout)
    and the run's ``(Accum, FailAcc, overflow)``, every leaf ``(C,)``."""
    inf = torch.full((c.next_wid.shape[0],), torch.inf,
                     device=c.next_wid.device)
    c, ts = _settle(es, is_f, c, ts, inf, True)
    fl = c.fail
    if fstat.enabled:
        # stragglers / half-served crashes break the serv_slot -> work and
        # next_wid -> cpu_spinups derivations; the failure path counts
        # both explicitly
        work_f, work_c = fl.work_f, fl.work_c
        missed = _exact_sum(c.miss_slot) + fl.dropped.to(_F32)
        cpu_spins = fl.cpu_spins.to(_F32)
    else:
        work_f = _exact_sum(c.serv_slot[:, :w_fpga]) * es.S
        work_c = _exact_sum(c.serv_slot[:, w_fpga:])
        missed = _exact_sum(c.miss_slot)
        cpu_spins = c.next_wid.to(_F32) - ts.spins
    e6 = ts.energy.unbind(1)
    acc = Accum(fpga_busy_j=e6[0], fpga_idle_j=e6[1], cpu_busy_j=e6[2],
                cpu_idle_j=e6[3], spin_j=e6[4], cost=e6[5], work_f=work_f,
                work_c=work_c, missed_requests=missed,
                fpga_spinups=ts.spins, cpu_spinups=cpu_spins)
    return acc, fl, c.overflow


def _scalars(cell: "EventCell") -> tuple:
    fleet = cell.fleet
    tb, coeffs = objective_setup(fleet, cell.energy_weight)
    deadline = (10.0 * cell.size_s if cell.deadline_s is None
                else cell.deadline_s)
    f = cell.failures.normalized() if cell.failures is not None else None
    ff = f.floats() if f is not None else (0.0,) * 8
    return (cell.size_s, deadline, fleet.S, fleet.T_s, tb, coeffs.co_min,
            coeffs.co_over, coeffs.co_under, coeffs.amort_unit,
            fleet.fpga.spin_up_s, fleet.cpu.spin_up_s,
            fleet.fpga_idle_timeout_s, fleet.cpu_idle_timeout_s,
            fleet.fpga.busy_w, fleet.fpga.idle_w, fleet.cpu.busy_w,
            fleet.cpu.idle_w, fleet.fpga.cost_per_s, fleet.cpu.cost_per_s,
            fleet.fpga.spin_up_energy_j + fleet.fpga.spin_down_energy_j,
            fleet.cpu.spin_up_energy_j + fleet.cpu.spin_down_energy_j,
            fleet.fpga.spin_down_s, fleet.cpu.spin_down_s,
            *ff,
            fleet.max_fpgas, cell.allocate_fpgas)


@dataclass(frozen=True)
class EventCell:
    """One DES grid cell: one app trace under one dispatch policy.

    Demand is explicit (``arrival_times`` + ``size_s``) or a named
    workload (``scenario`` realized at ``seed``), which
    `repro_torch.sim.sweep.sweep_events` resolves
    (`repro_torch.sim.plan.resolve_scenarios`)."""

    dispatcher: str
    arrival_times: np.ndarray | None = None
    size_s: float | None = None
    fleet: FleetParams = DEFAULT_FLEET
    energy_weight: float = 1.0
    horizon_s: float | None = None
    deadline_s: float | None = None
    allocate_fpgas: bool = True
    tag: Any = None
    scenario: Any = None          # workloads.scenarios.ScenarioSpec
    seed: int = 0                 # scenario realization seed
    failures: FailureSpec | None = None   # fault model (static sweep axis)

    def __post_init__(self):
        """Fail-fast construction-time validation: malformed cells raise a
        clear ValueError here instead of a shape error in the planner."""
        if self.arrival_times is not None:
            a = np.asarray(self.arrival_times, np.float64)
            if a.ndim != 1:
                raise ValueError(
                    f"EventCell.arrival_times must be a 1-D time stream, "
                    f"got shape {a.shape}")
            if a.size and (not np.all(np.isfinite(a)) or np.any(a < 0)):
                raise ValueError(
                    "EventCell.arrival_times must be non-negative finite "
                    "timestamps")
            if a.size > 1 and np.any(np.diff(a) < 0):
                raise ValueError(
                    "EventCell.arrival_times must be sorted ascending "
                    "(the DES consumes a time-ordered stream)")
        if self.size_s is not None and not (
                np.isfinite(self.size_s) and self.size_s > 0):
            raise ValueError(
                f"EventCell.size_s must be a positive finite service "
                f"time, got {self.size_s!r}")
        if self.deadline_s is not None and not (
                np.isfinite(self.deadline_s) and self.deadline_s > 0):
            raise ValueError(
                f"EventCell.deadline_s must be > 0, got {self.deadline_s!r}")
        if self.horizon_s is not None and not (
                np.isfinite(self.horizon_s) and self.horizon_s > 0):
            raise ValueError(
                f"EventCell.horizon_s must be > 0, got {self.horizon_s!r}")
        if not np.isfinite(self.energy_weight):
            raise ValueError(
                f"EventCell.energy_weight must be finite, got "
                f"{self.energy_weight!r}")
        if np.ndim(self.seed) != 0:
            raise ValueError(
                f"EventCell.seed must be a scalar (one seed per cell — "
                f"expand seed batches into cells), got shape "
                f"{np.shape(self.seed)}")


def _entries(arr: np.ndarray, interval_s: float, horizon: float,
             payload: np.ndarray | None = None) -> list[tuple]:
    """Flat entry stream for one cell: ``(row, tick)`` pairs of
    fixed-width arrival blocks, with tick markers riding on the last block
    of each interval. Bucket k holds arrivals in ((k-1)*T_s, k*T_s] so
    every arrival precedes its tick (the oracle pops arrivals before
    same-time events), and the final bucket holds the post-last-tick
    tail.

    With ``payload`` (a per-arrival array aligned with ``arr``, e.g. the
    fleet layer's tenant indices) entries are ``(row, pay_row, tick)``
    3-tuples, the payload sliced identically to the times."""
    K = int(np.ceil(horizon / interval_s))
    idx = np.minimum(np.ceil(np.asarray(arr, np.float64) / interval_s)
                     .astype(np.int64), K)
    idx = np.maximum(idx, 0)
    out: list[tuple] = []

    def split(x):
        return [x[j:j + BLOCK] for j in range(0, len(x), BLOCK)] or [x[:0]]

    for k in range(K + 1):
        sel = idx == k
        blocks = split(np.asarray(arr)[sel])
        tick = k * interval_s if k < K else None
        if payload is None:
            out.extend((r, None) for r in blocks[:-1])
            out.append((blocks[-1], tick))
        else:
            pblocks = split(np.asarray(payload)[sel])
            out.extend((r, p, None) for r, p in zip(blocks[:-1], pblocks))
            out.append((blocks[-1], pblocks[-1], tick))
    return out


def _pad_pow2(n: int, lo: int = 4, hi: int | None = None) -> int:
    p = max(lo, 1 << int(math.ceil(math.log2(max(n, 1)))))
    return min(p, hi) if hi else p


def simulate_events_batch(cells: Iterable[EventCell], n_max: int = 512,
                          w_fpga: int = 32, w_cpu: int = 64,
                          backend=None,
                          device: str | torch.device | None = None
                          ) -> list[RunTotals]:
    """Run every DES cell, one dispatch per (entry-count bucket) group
    chunk; cell order is preserved. Totals carry
    ``breakdown['slot_overflow']`` (0 unless a table region or
    ``max_fpgas`` was too small for the trace). A thin plan + execute
    wrapper (`repro_torch.sim.plan.plan_events`, `repro_torch.sim.exec`);
    ``device=None`` runs on the card."""
    from repro_torch.sim.exec import execute
    from repro_torch.sim.plan import plan_events
    plan = plan_events(cells, n_max=n_max, w_fpga=w_fpga, w_cpu=w_cpu,
                       resolve=False)
    return execute(plan, backend, device=device).totals()


def simulate_events_batched(arrival_times: np.ndarray, size_s: float,
                            fleet: FleetParams, dispatcher: str = "spork",
                            energy_weight: float = 1.0,
                            horizon_s: float | None = None,
                            deadline_s: float | None = None,
                            allocate_fpgas: bool = True, n_max: int = 512,
                            w_fpga: int = 32, w_cpu: int = 64,
                            failures: FailureSpec | None = None,
                            device: str | torch.device | None = None
                            ) -> RunTotals:
    """Drop-in twin of `events.simulate_events` on the batched engine."""
    cell = EventCell(dispatcher, np.asarray(arrival_times), size_s, fleet,
                     energy_weight=energy_weight, horizon_s=horizon_s,
                     deadline_s=deadline_s, allocate_fpgas=allocate_fpgas,
                     failures=failures)
    return simulate_events_batch([cell], n_max=n_max, w_fpga=w_fpga,
                                 w_cpu=w_cpu, device=device)[0]
