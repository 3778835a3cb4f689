"""Rate-level policies (fluid simulator): the six paper policies as
plugin objects plus the predictive spin-up policy. Port of
`repro.policies.rate`; every method acts on a batch of cells at once.

Policy map (paper §5.1 / Table 4):

  * `Spork` — Alg. 1-2: NeededFPGAs breakeven rounding, conditional-
    histogram prediction (through the `spork_predict` kernel), per-level
    lifetime amortization; CPU fallback on the dispatch path.
  * `SporkIdeal` — perfect next-interval demand knowledge; no predictor
    state.
  * `CpuDynamic` — never allocates FPGAs; pure on-demand CPUs.
  * `FpgaStatic` — provision once for peak, never reclaim; FPGA-only
    FIFO queue with deadline misses.
  * `FpgaDynamic` — reactive autoscaler ("long-term" row of Table 4):
    capacity for the load just observed + fixed headroom.
  * `MarkIdeal` — MArk [93] with 2-interval oracle lookahead and
    round-robin serving.
  * `PredictiveSpinUp` — acts on a short-horizon linear-trend forecast
    ``lam_hat = lam + gain * (lam - lam_prev)``; at gain 0 it is
    `FpgaDynamic` exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.predictor import (allocator_tick,
                                        lifetime_update_from_rings)
from repro_torch.policies.base import RATE_REGISTRY, RateCtx, RatePolicy


def needed_fpgas(lam, interval_s, tb):
    """Alg. 1 NeededFPGAs: floor + breakeven rounding. lam in FPGA-seconds."""
    n = torch.floor(lam / interval_s)
    frac = lam - n * interval_s
    return (n + (frac > tb)).to(torch.int32)


def _zero_interval(state):
    return dict(F_acc=torch.zeros_like(state.F_acc),
                C_acc=torch.zeros_like(state.C_acc))


def _n_curr(state):
    """FPGAs up or on their way."""
    return state.up + state.pending.sum(dim=1, dtype=torch.int32)


def _schedule(ctx: RateCtx, state, new):
    """Pending ring with ``new`` spin-ups landing one spin-up latency out."""
    pending = state.pending.clone()
    pending[:, ctx.spin_up_s - 1] += new
    return pending


def _provision(ctx: RateCtx, state, target):
    """Shared allocation tail: clip the request to capacity, schedule
    the spin-ups one spin-up latency out, charge the spin-up counter."""
    n_curr = _n_curr(state)
    new = torch.clamp(target - n_curr, min=0)
    new = torch.minimum(new, ctx.n_max - 1 - n_curr)
    acc = state.accum._replace(
        fpga_spinups=state.accum.fpga_spinups + new.to(torch.float32))
    return _schedule(ctx, state, new), acc


@dataclass(frozen=True)
class _FpgaOnly(RatePolicy):
    """Serving rule for policies with no CPU fallback: FIFO fluid
    queue; a request misses when its queueing delay exceeds
    deadline - service time."""

    def dispatch_step(self, ctx, params, state, W, arrivals, up):
        cap_f = up.to(torch.float32) * ctx.fs.S
        backlog = state.queue + W
        fpga_work = torch.minimum(backlog, cap_f)
        cpu_work = torch.zeros_like(W)
        queue = backlog - fpga_work
        slack = 10.0 * ctx.size_s - ctx.size_s / ctx.fs.S
        delay = queue / torch.clamp(cap_f, min=1e-6)
        missed = torch.where(delay > slack, arrivals.to(torch.float32), 0.0)
        return fpga_work, cpu_work, queue, missed


@dataclass(frozen=True)
class Spork(RatePolicy):
    """Alg. 1-2: breakeven rounding + conditional-histogram prediction
    + lifetime amortization, CPU fallback on the dispatch path."""

    name: str = "spork"
    ideal = False
    uses_predictor = True

    def allocator_tick(self, ctx, params, state, xs):
        next_true_needed, _, _ = xs
        n_curr = _n_curr(state)
        if self.ideal:
            # Perfect information: the predictor state is never consulted.
            target = torch.clamp(next_true_needed, max=ctx.n_max - 1)
            H, n_lag = state.H, state.n_lag
        else:
            # Fold the previous interval's per-second push/pop counts
            # into the per-level lifetime stats (read only here, so
            # replaying the rings at the tick is exact).
            alloc_time, life_sum, life_cnt = lifetime_update_from_rings(
                state.alloc_time, state.life_sum, state.life_cnt,
                state.young_ring, state.dealloc_ring, state.up, state.t)
            state = state._replace(alloc_time=alloc_time, life_sum=life_sum,
                                   life_cnt=life_cnt)
            lam = state.F_acc + state.C_acc / ctx.fs.S      # FPGA-seconds
            H, n_lag, target = allocator_tick(
                state.H, life_sum, life_cnt, state.n_lag, lam, n_curr,
                ctx.coeffs, float(ctx.interval_s), ctx.tb)
        pending, acc = _provision(ctx, state, target)
        return state._replace(pending=pending, H=H, n_lag=n_lag, accum=acc,
                              **_zero_interval(state))


@dataclass(frozen=True)
class SporkIdeal(Spork):
    name: str = "spork_ideal"
    ideal = True
    uses_predictor = False


@dataclass(frozen=True)
class CpuDynamic(RatePolicy):
    """On-demand CPUs only; never allocates FPGAs."""

    name: str = "cpu_dynamic"
    latency_free = True

    def allocator_tick(self, ctx, params, state, xs):
        return state._replace(**_zero_interval(state))


@dataclass(frozen=True)
class FpgaStatic(_FpgaOnly):
    """Provision `RateParams.static_level` once (warm, before the trace
    starts), never reclaim."""

    name: str = "fpga_static"
    latency_free = True

    def reclaim(self, ctx, params, used_ring, young_ring, up, used_f):
        return torch.zeros_like(up)

    def allocator_tick(self, ctx, params, state, xs):
        fs = ctx.fs
        new = torch.clamp(params.static_level - _n_curr(state), min=0)
        # provisioned before the trace starts: arrives immediately (warm),
        # spin-up energy/cost still charged below via accounting.
        up = state.up + new
        new_f = new.to(torch.float32)
        acc = state.accum
        acc = acc._replace(
            spin_j=acc.spin_j + new_f * fs.B_f * fs.A_f_s,
            cost=acc.cost + new_f * fs.C_f * fs.A_f_s,
            fpga_spinups=acc.fpga_spinups + new_f)
        return state._replace(up=up, accum=acc, **_zero_interval(state))


@dataclass(frozen=True)
class FpgaDynamic(_FpgaOnly):
    """Reactive autoscaler at allocation-interval granularity (Table 4,
    "long-term"): minimum FPGAs for the load just observed + fixed
    headroom; spin-ups land one interval later. Downsizing via the
    standard idle timeout (headroom is protected in `protect`)."""

    name: str = "fpga_dynamic"

    def protect(self, ctx, params, protected, used_f):
        return torch.maximum(protected, used_f + params.headroom)

    def init_alloc(self, ctx, params, counts):
        # starts warm (pre-warmed reactive autoscaler): initial capacity
        # for the first second's demand + headroom, spin-up charged.
        w0 = counts[:, 0, 0].to(torch.float32) * ctx.size_s
        init_up = (torch.ceil(w0 / ctx.fs.S).to(torch.int32)
                   + params.headroom)
        return init_up, init_up.to(torch.float32)

    def _target(self, ctx, params, state):
        lam_prev = state.F_acc + state.C_acc / ctx.fs.S
        needed_now = torch.ceil(lam_prev / float(ctx.interval_s)).to(torch.int32)
        return needed_now + params.headroom

    def allocator_tick(self, ctx, params, state, xs):
        n_curr = _n_curr(state)
        target = self._target(ctx, params, state)
        new = torch.clamp(target - n_curr, min=0)
        new = torch.clamp(torch.minimum(new, ctx.n_max - 1 - n_curr), min=0)
        acc = state.accum._replace(
            fpga_spinups=state.accum.fpga_spinups + new.to(torch.float32))
        return state._replace(pending=_schedule(ctx, state, new), accum=acc,
                              lam_hist=state.F_acc + state.C_acc / ctx.fs.S,
                              **_zero_interval(state))


@dataclass(frozen=True)
class PredictiveSpinUp(FpgaDynamic):
    """`FpgaDynamic` acting on a short-horizon forecast instead of the
    observed load:

        lam_hat = max(lam + gain * (lam - lam_prev), 0)

    and targets capacity for ``lam_hat`` (+ headroom). With ``gain = 0``
    this IS `FpgaDynamic`. ``lam_prev`` is carried in ``SimState.
    lam_hist``; the gain rides in `RateParams.gain`."""

    name: str = "predictive"

    def _target(self, ctx, params, state):
        lam = state.F_acc + state.C_acc / ctx.fs.S
        lam_hat = torch.clamp(lam + params.gain * (lam - state.lam_hist),
                              min=0.0)
        needed = torch.ceil(lam_hat / float(ctx.interval_s)).to(torch.int32)
        return needed + params.headroom


@dataclass(frozen=True)
class MarkIdeal(RatePolicy):
    """MArk [93] with perfect demand knowledge two intervals ahead
    (§5.1): round-robin serving, allocate for the next interval,
    downsize only what neither of the next two intervals needs."""

    name: str = "mark_ideal"

    def dispatch_step(self, ctx, params, state, W, arrivals, up):
        # Round-robin split: each up worker receives an equal request share.
        cap_f = up.to(torch.float32) * ctx.fs.S
        n_c_prev = state.cpu_prev.to(torch.float32)
        n_tot = up.to(torch.float32) + n_c_prev
        share_c = torch.where(n_tot > 0,
                              n_c_prev / torch.clamp(n_tot, min=1.0), 0.0)
        cpu_work0 = torch.minimum(W * share_c, n_c_prev)
        fpga_work = torch.minimum(W - cpu_work0, cap_f)
        residual = torch.clamp(W - cpu_work0 - fpga_work, min=0.0)
        cpu_work = cpu_work0 + residual
        return fpga_work, cpu_work, state.queue, torch.zeros_like(W)

    def cpu_keep(self, state, up, arrivals, n_cpu):
        # RR keeps every worker receiving requests alive.
        keep = arrivals >= (up + state.cpu_prev)
        cpu_alive = torch.maximum(
            n_cpu, torch.where(keep, state.cpu_prev, 0))
        return cpu_alive, cpu_alive

    def allocator_tick(self, ctx, params, state, xs):
        # The predictive controller also releases surplus on-demand
        # CPUs (cost-breakeven rounding throughout).
        _, next_W, next2_W = xs
        fs = ctx.fs
        interval = float(ctx.interval_s)
        n_curr = _n_curr(state)
        tb_cost = interval * fs.C_f / (fs.S * fs.C_c)
        t1 = needed_fpgas(next_W / fs.S, interval, tb_cost)
        t2 = needed_fpgas(next2_W / fs.S, interval, tb_cost)
        target = torch.clamp(t1, max=ctx.n_max - 1)
        keep_floor = torch.clamp(torch.maximum(t1, t2), max=ctx.n_max - 1)
        new = torch.clamp(target - n_curr, min=0)
        drop = torch.clamp(state.up - keep_floor, min=0)
        cap_next = target.to(torch.float32) * fs.S * interval
        cpu_needed = torch.ceil(
            torch.clamp(next_W - cap_next, min=0.0) / interval
        ).to(torch.int32)
        cpu_prev = torch.minimum(state.cpu_prev, cpu_needed)
        up_next = state.up - drop
        drop_f = drop.to(torch.float32)
        acc = state.accum
        acc = acc._replace(
            fpga_spinups=acc.fpga_spinups + new.to(torch.float32),
            spin_j=acc.spin_j + drop_f * fs.d_f,
            cost=acc.cost + drop_f * fs.C_f * fs.d_f_s)
        return state._replace(pending=_schedule(ctx, state, new), up=up_next,
                              accum=acc, cpu_prev=cpu_prev,
                              **_zero_interval(state))


SPORK = RATE_REGISTRY.register(Spork())
SPORK_IDEAL = RATE_REGISTRY.register(SporkIdeal())
CPU_DYNAMIC = RATE_REGISTRY.register(CpuDynamic())
FPGA_STATIC = RATE_REGISTRY.register(FpgaStatic())
FPGA_DYNAMIC = RATE_REGISTRY.register(FpgaDynamic())
MARK_IDEAL = RATE_REGISTRY.register(MarkIdeal())
PREDICTIVE = RATE_REGISTRY.register(PredictiveSpinUp())
