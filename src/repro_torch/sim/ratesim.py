"""Batched rate-level simulator for hybrid/homogeneous platforms (PyTorch).

Port of `repro.sim.ratesim`, with the same semantics (1-second fluid
buckets, paper §3 and §5.1):

  * Arrivals: per-second request counts from a Trace.
  * FPGA pool: allocations issued by the per-interval policy arrive after
    the spin-up latency (pending ring buffer); workers draw busy power
    while reconfiguring; idle workers are reclaimed after sitting fully
    idle for the idle timeout (= one scheduling interval).
  * CPU pool: allocated on the dispatch path within a second, reclaimed
    after a short idle timeout (1 s fluid model).
  * FPGA-only policies have no CPU fallback: excess work queues; a request
    misses its deadline when its queueing delay exceeds deadline - service
    time.

Where the reference vmaps one cell's `lax.scan`, the port runs every
cell of a chunk at once: each tensor carries a leading cell axis and a
Python loop walks the seconds. The second index ``t`` is a Python int
shared by all cells, so the loop never reads a tensor on the host. The
Spork policy's allocator tick evaluates Alg. 2 through the
`spork_predict` CUDA kernel, one launch per tick for the whole chunk.

Entry points: `simulate` (one trace), `simulate_batch` + `batch_totals`
(a batch of traces), `tune_fpga_dynamic` (every headroom level in one
batch), and `_simulate_cells`, the batched core that `repro_torch.sim.
exec` runs for each sweep chunk. Each takes ``device=None`` (the card).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.breakeven import ObjectiveCoeffs
from repro_torch.core.metrics import RunTotals
from repro_torch.core.workers import FleetParams
from repro_torch.device import resolve_device
from repro_torch.policies import RateCtx, RateParams, get_rate_policy
from repro_torch.policies.rate import needed_fpgas


class FleetScalars(NamedTuple):
    """Per-cell worker parameters, each a ``(C,)`` float32 tensor."""

    S: torch.Tensor          # FPGA speedup over CPU
    B_f: torch.Tensor        # FPGA busy W
    I_f: torch.Tensor        # FPGA idle W
    B_c: torch.Tensor        # CPU busy W
    I_c: torch.Tensor        # CPU idle W
    C_f: torch.Tensor        # FPGA $/s
    C_c: torch.Tensor        # CPU $/s
    a_c: torch.Tensor        # CPU spin-up energy J
    A_c_s: torch.Tensor      # CPU spin-up seconds
    d_f: torch.Tensor        # FPGA spin-down energy J
    d_f_s: torch.Tensor      # FPGA spin-down seconds
    d_c: torch.Tensor        # CPU spin-down energy J
    A_f_s: torch.Tensor      # FPGA spin-up seconds, rounded like the
                             # loop's 1-second-granularity latency

    @staticmethod
    def from_fleet(fleet: FleetParams, cells: int = 1,
                   device: str | torch.device | None = None) -> "FleetScalars":
        """``fleet`` repeated over ``cells`` cells."""
        row = torch.as_tensor(fleet_scalars_np(fleet),
                              device=resolve_device(device))
        return FleetScalars(*(row[j].expand(cells).contiguous()
                              for j in range(len(FleetScalars._fields))))


def fleet_scalars_np(fleet: FleetParams) -> np.ndarray:
    """The `FleetScalars` leaf values of one fleet, float32, in field
    order: the single host-side source of the fleet-to-scalars mapping."""
    return np.array([
        fleet.S, fleet.fpga.busy_w, fleet.fpga.idle_w, fleet.cpu.busy_w,
        fleet.cpu.idle_w, fleet.fpga.cost_per_s, fleet.cpu.cost_per_s,
        fleet.cpu.spin_up_energy_j, fleet.cpu.spin_up_s,
        fleet.fpga.spin_down_energy_j, fleet.fpga.spin_down_s,
        fleet.cpu.spin_down_energy_j,
        max(int(round(fleet.fpga.spin_up_s)), 1)], np.float32)


def coeffs_in_graph(fs: FleetScalars, interval_s: float, spin_up_s,
                    energy_weight) -> tuple[ObjectiveCoeffs, torch.Tensor]:
    """Tensor twin of core.breakeven, per cell.

    Returns (Alg.-2 objective coefficients, breakeven threshold T_b)."""
    T = float(interval_s)
    w = torch.clamp(torch.as_tensor(energy_weight, dtype=torch.float32,
                                    device=fs.S.device), 0.0, 1.0)
    e = ObjectiveCoeffs(fs.B_f * T, fs.I_f * T, fs.S * fs.B_c * T,
                        fs.B_f * spin_up_s)
    c = ObjectiveCoeffs(fs.C_f * T, fs.C_f * T, fs.S * fs.C_c * T,
                        fs.C_f * spin_up_s)
    e_unit, c_unit = fs.B_f * T, fs.C_f * T
    mix = ObjectiveCoeffs(*[w * ev / e_unit + (1 - w) * cv / c_unit
                            for ev, cv in zip(e, c)])
    # breakeven thresholds
    den = fs.B_c - fs.B_f / fs.S + fs.I_f / fs.S
    tb_e = torch.where(den > 0, T * fs.I_f / torch.clamp(den, min=1e-9),
                       torch.inf)
    tb_c = T * fs.C_f / (fs.S * fs.C_c)
    tb = w * torch.clamp(tb_e, max=T) + (1 - w) * tb_c
    return mix, tb


class Accum(NamedTuple):
    fpga_busy_j: torch.Tensor
    fpga_idle_j: torch.Tensor
    cpu_busy_j: torch.Tensor
    cpu_idle_j: torch.Tensor
    spin_j: torch.Tensor
    cost: torch.Tensor
    work_f: torch.Tensor       # CPU-seconds served on FPGAs
    work_c: torch.Tensor       # CPU-seconds served on CPUs
    missed_requests: torch.Tensor
    fpga_spinups: torch.Tensor
    cpu_spinups: torch.Tensor

    @staticmethod
    def zero(cells: int, device: torch.device) -> "Accum":
        return Accum(*(torch.zeros(cells, dtype=torch.float32, device=device)
                       for _ in Accum._fields))


class SimState(NamedTuple):
    """Batched simulator state: every tensor has the cell axis first;
    ``t`` (seconds elapsed) is a Python int shared by all cells."""

    up: torch.Tensor               # (C,) FPGAs spun up
    pending: torch.Tensor          # (C, pending_max) arriving in k seconds
    used_ring: torch.Tensor        # (C, interval_s) used FPGAs per past second
    young_ring: torch.Tensor       # (C, interval_s) spin-up completions
    dealloc_ring: torch.Tensor     # (C, interval_s) idle reclaims
    alloc_time: torch.Tensor       # (C, n_max) per-slot alloc timestamps
    H: torch.Tensor                # (C, n_max, n_max) conditional histograms
    life_sum: torch.Tensor         # (C, n_max)
    life_cnt: torch.Tensor         # (C, n_max)
    n_lag: torch.Tensor            # (C, 2) needed counts [lag1, lag2]
    F_acc: torch.Tensor            # (C,) FPGA busy seconds this interval
    C_acc: torch.Tensor            # (C,) CPU work (cpu-s) this interval
    cpu_prev: torch.Tensor         # (C,) CPU workers used last second
    queue: torch.Tensor            # (C,) queued work (FPGA-only policies)
    lam_hist: torch.Tensor         # (C,) previous interval's observed load
    t: int                         # seconds elapsed
    accum: Accum


def _second_step(policy, ctx: RateCtx, params: RateParams, state: SimState,
                 arrivals: torch.Tensor) -> SimState:
    """Advance every cell one second: arrivals -> spin-up completions ->
    serving (`policy.dispatch_step` / `policy.cpu_keep`) -> reclaim
    (`policy.reclaim`) -> shared accounting. ``arrivals`` is the ``(C,)``
    request count this second.

    The three rings are written in place (the simulator owns the state).
    The reference's buckets are ``dt = 1`` second long; its ``* dt``
    factors are exact identities in float32 and are left out here."""
    fs, size_s = ctx.fs, ctx.size_s
    W = arrivals.to(torch.float32) * size_s             # CPU-seconds of demand
    acc = state.accum

    # --- spin-up completions ---
    completions = state.pending[:, 0]
    pending = torch.cat([state.pending[:, 1:],
                         torch.zeros_like(state.pending[:, :1])], dim=1)
    up = state.up + completions

    # --- serving (policy dispatch rule) ---
    fpga_work, cpu_work, queue, missed = policy.dispatch_step(
        ctx, params, state, W, arrivals, up)

    busy_f = fpga_work / fs.S                            # FPGA busy seconds
    used_f = torch.ceil(busy_f - 1e-6).to(torch.int32)

    # --- CPU pool (dispatch-path allocation, policy linger rule) ---
    n_cpu = torch.ceil(cpu_work - 1e-6).to(torch.int32)
    cpu_alive, cpu_prev_next = policy.cpu_keep(state, up, arrivals, n_cpu)
    new_cpus = torch.clamp(n_cpu - state.cpu_prev, min=0).to(torch.float32)

    # --- idle reclaim (policy protection rule) ---
    slot = state.t % ctx.interval_s
    state.used_ring[:, slot] = used_f
    state.young_ring[:, slot] = completions
    dealloc = policy.reclaim(ctx, params, state.used_ring, state.young_ring,
                             up, used_f)
    up_next = up - dealloc
    # Lifetime stats are not updated here: the allocator tick replays the
    # push/pop counts of the rings (`predictor.lifetime_update_from_rings`).
    state.dealloc_ring[:, slot] = dealloc

    # --- accounting ---
    upf = up.to(torch.float32)
    pend_tot = pending.sum(dim=1, dtype=torch.int32).to(torch.float32)
    dealloc_f32 = dealloc.to(torch.float32)
    alive_f32 = cpu_alive.to(torch.float32)
    acc = Accum(
        fpga_busy_j=acc.fpga_busy_j + busy_f * fs.B_f,
        fpga_idle_j=acc.fpga_idle_j + (upf - busy_f) * fs.I_f,
        cpu_busy_j=acc.cpu_busy_j + cpu_work * fs.B_c,
        cpu_idle_j=acc.cpu_idle_j + (alive_f32 - cpu_work) * fs.I_c,
        spin_j=acc.spin_j + pend_tot * fs.B_f + dealloc_f32 * fs.d_f
        + new_cpus * fs.a_c,
        cost=acc.cost + (upf + pend_tot) * fs.C_f
        + dealloc_f32 * fs.C_f * fs.d_f_s
        + alive_f32 * fs.C_c + new_cpus * fs.C_c * fs.A_c_s,
        work_f=acc.work_f + fpga_work,
        work_c=acc.work_c + cpu_work,
        missed_requests=acc.missed_requests + missed,
        fpga_spinups=acc.fpga_spinups,
        cpu_spinups=acc.cpu_spinups + new_cpus,
    )

    return state._replace(
        up=up_next, pending=pending, F_acc=state.F_acc + busy_f,
        C_acc=state.C_acc + cpu_work, cpu_prev=cpu_prev_next, queue=queue,
        t=state.t + 1, accum=acc)


def _simulate_cells(policy, interval_s: int, spin_up_s: int, n_max: int,
                    horizon_s: int, counts: torch.Tensor,
                    size_s: torch.Tensor, fs: FleetScalars,
                    energy_weight: torch.Tensor,
                    params: RateParams) -> Accum:
    """Batched core: ``counts`` ``(C, T)``, ``size_s``/``energy_weight``
    and every `FleetScalars`/`RateParams` leaf ``(C,)``, all on one
    device. ``policy`` is a `RatePolicy`; the four ints fix ring sizes
    and loop lengths. Returns an `Accum` of ``(C,)`` tensors."""
    cells, dev = counts.shape[0], counts.device
    k = horizon_s // interval_s
    counts = counts[:, :k * interval_s].reshape(cells, k, interval_s).to(
        torch.int32)
    W_per_interval = (counts.sum(dim=2, dtype=torch.int32).to(torch.float32)
                      * size_s[:, None])
    zeros2 = torch.zeros((cells, 2), dtype=torch.float32, device=dev)
    next_W = torch.cat([W_per_interval[:, 1:], zeros2[:, :1]], dim=1)
    next2_W = torch.cat([W_per_interval[:, 2:], zeros2], dim=1)[:, :k]
    coeffs, tb = coeffs_in_graph(fs, interval_s, fs.A_f_s, energy_weight)
    ctx = RateCtx(interval_s=interval_s, spin_up_s=spin_up_s, n_max=n_max,
                  fs=fs, size_s=size_s, coeffs=coeffs, tb=tb)
    # true needed counts for the *next* interval (ideal variants)
    next_true = needed_fpgas(next_W / fs.S[:, None], float(interval_s),
                             tb[:, None])

    # Policy warm start (e.g. the pre-warmed reactive autoscaler):
    # initial capacity, spin-up energy/cost charged here.
    init_up, init_spin = policy.init_alloc(ctx, params, counts)
    acc0 = Accum.zero(cells, dev)._replace(
        spin_j=init_spin * fs.B_f * fs.A_f_s,
        cost=init_spin * fs.C_f * fs.A_f_s,
        fpga_spinups=init_spin)

    def zi(*shape):
        return torch.zeros((cells, *shape), dtype=torch.int32, device=dev)

    def zf(*shape):
        return torch.zeros((cells, *shape), dtype=torch.float32, device=dev)

    # Lifetime/histogram state only exists for the Spork variants (the
    # only consumers); the others carry placeholders.
    n_life = n_max if policy.uses_predictor else 1
    state = SimState(
        up=init_up, pending=zi(max(spin_up_s, 1) + 1),
        used_ring=zi(interval_s), young_ring=zi(interval_s),
        dealloc_ring=zi(interval_s), alloc_time=zf(n_life),
        H=zf(n_life, n_life), life_sum=zf(n_life), life_cnt=zf(n_life),
        n_lag=zi(2), F_acc=zf(), C_acc=zf(), cpu_prev=zi(), queue=zf(),
        lam_hist=zf(), t=0, accum=acc0)

    for i in range(k):
        state = policy.allocator_tick(
            ctx, params, state, (next_true[:, i], next_W[:, i], next2_W[:, i]))
        for s in range(interval_s):
            state = _second_step(policy, ctx, params, state, counts[:, i, s])
    # Closing: spin down everything still up.
    upf = state.up.to(torch.float32)
    acc = state.accum
    return acc._replace(spin_j=acc.spin_j + upf * fs.d_f,
                        cost=acc.cost + upf * fs.C_f * fs.d_f_s)


def accum_to_totals(acc: Accum, total_work: float,
                    total_requests: int) -> RunTotals:
    """One cell's accumulators (0-d tensors or numpy scalars) as totals."""
    g = float
    energy = (g(acc.fpga_busy_j) + g(acc.fpga_idle_j) + g(acc.cpu_busy_j)
              + g(acc.cpu_idle_j) + g(acc.spin_j))
    return RunTotals(
        energy_j=energy, cost_usd=g(acc.cost), work_cpu_s=total_work,
        work_on_fpga_cpu_s=g(acc.work_f), work_on_cpu_cpu_s=g(acc.work_c),
        requests=total_requests, deadline_misses=int(g(acc.missed_requests)),
        fpga_spinups=int(g(acc.fpga_spinups)), cpu_spinups=int(g(acc.cpu_spinups)),
        fpga_idle_j=g(acc.fpga_idle_j), fpga_busy_j=g(acc.fpga_busy_j),
        cpu_busy_j=g(acc.cpu_busy_j), spinup_j=g(acc.spin_j))


def accum_numpy(acc: Accum) -> Accum:
    """An `Accum` of device tensors as numpy arrays, in one transfer."""
    return Accum(*torch.stack(list(acc)).cpu().numpy())


def static_level_for(counts: np.ndarray, size_s: float, fleet: FleetParams,
                     n_max: int = 512) -> int:
    """fpga_static provisioning level: per-second peak demand in FPGA units."""
    peak = np.max(np.asarray(counts).astype(np.float64) * size_s / fleet.S)
    return min(int(np.ceil(peak)), n_max - 1)


def _batch_args(counts_batch: np.ndarray, size_s: float, fleet: FleetParams,
                energy_weight: float, params_np: tuple, dev: torch.device):
    """`_simulate_cells` arguments for one fleet/size over a trace batch."""
    cells = counts_batch.shape[0]
    full = lambda v, dt: torch.full((cells,), v, dtype=dt, device=dev)  # noqa: E731
    headroom, levels, gain = params_np
    params = RateParams(torch.as_tensor(headroom, dtype=torch.int32, device=dev),
                        torch.as_tensor(levels, dtype=torch.int32, device=dev),
                        torch.as_tensor(gain, dtype=torch.float32, device=dev))
    return (torch.as_tensor(counts_batch, dtype=torch.int32, device=dev),
            full(size_s, torch.float32),
            FleetScalars.from_fleet(fleet, cells, dev),
            full(energy_weight, torch.float32), params)


def _static_args(fleet: FleetParams, n_counts: int) -> tuple[int, int, int]:
    interval_s = max(int(round(fleet.T_s)), 1)
    spin_up_s = max(int(round(fleet.fpga.spin_up_s)), 1)
    return interval_s, spin_up_s, (n_counts // interval_s) * interval_s


def simulate(policy, counts: np.ndarray, size_s: float,
             fleet: FleetParams, energy_weight: float = 1.0,
             headroom: int = 0, n_max: int = 512,
             forecast_gain: float = 1.0,
             device: str | torch.device | None = None) -> RunTotals:
    """Run one policy (registered name or `RatePolicy` object) on one
    trace; returns paper-style totals."""
    policy = get_rate_policy(policy)
    dev = resolve_device(device)
    interval_s, spin_up_s, horizon = _static_args(fleet, len(counts))
    counts = np.asarray(counts[:horizon])
    static_level = 0
    if policy.name == "fpga_static":
        static_level = static_level_for(counts, size_s, fleet, n_max)
    args = _batch_args(counts[None], size_s, fleet, energy_weight,
                       ([headroom], [static_level], [forecast_gain]), dev)
    acc = accum_numpy(_simulate_cells(policy, interval_s, spin_up_s, n_max,
                                      horizon, *args))
    total_work = float(np.sum(counts) * size_s)
    return accum_to_totals(Accum(*(leaf[0] for leaf in acc)), total_work,
                           int(np.sum(counts)))


def simulate_batch(policy, counts_batch: np.ndarray, size_s: float,
                   fleet: FleetParams, energy_weight: float = 1.0,
                   headroom: int = 0, n_max: int = 512,
                   forecast_gain: float = 1.0,
                   device: str | torch.device | None = None) -> Accum:
    """Run one policy on a batch of traces at once.

    ``counts_batch`` is ``(B, T)`` per-second arrival counts (equal
    horizons). Returns an `Accum` of ``(B,)`` tensors on the device;
    convert with `batch_totals`.
    """
    policy = get_rate_policy(policy)
    dev = resolve_device(device)
    counts_batch = np.asarray(counts_batch)
    if counts_batch.ndim != 2:
        raise ValueError(f"counts_batch must be (B, T), got {counts_batch.shape}")
    B = counts_batch.shape[0]
    interval_s, spin_up_s, horizon = _static_args(fleet, counts_batch.shape[1])
    counts_batch = counts_batch[:, :horizon]
    if policy.name == "fpga_static":
        levels = [static_level_for(c, size_s, fleet, n_max) for c in counts_batch]
    else:
        levels = [0] * B
    args = _batch_args(counts_batch, size_s, fleet, energy_weight,
                       ([headroom] * B, levels, [forecast_gain] * B), dev)
    return _simulate_cells(policy, interval_s, spin_up_s, n_max, horizon,
                           *args)


def batch_totals(acc: Accum, counts_batch: np.ndarray,
                 size_s: float) -> list[RunTotals]:
    """Convert a stacked `Accum` from `simulate_batch` to per-trace totals."""
    counts_batch = np.asarray(counts_batch)
    acc_np = accum_numpy(acc)
    return [accum_to_totals(Accum(*(leaf[i] for leaf in acc_np)),
                            float(counts_batch[i].sum() * size_s),
                            int(counts_batch[i].sum()))
            for i in range(counts_batch.shape[0])]


def headroom_unit(counts: np.ndarray, size_s: float,
                  fleet: FleetParams) -> int:
    """Tuning step for fpga_dynamic: the max consecutive-interval demand
    delta, in whole FPGA workers (§5.1)."""
    interval_s = max(int(round(fleet.T_s)), 1)
    k_int = len(counts) // interval_s
    W = (np.asarray(counts[:k_int * interval_s], dtype=np.float64)
         .reshape(k_int, interval_s).sum(1) * size_s)
    if len(W) < 2:
        return 1
    return max(1, int(np.ceil(np.max(np.abs(np.diff(W)))
                              / (fleet.S * interval_s))))


def tune_fpga_dynamic(counts: np.ndarray, size_s: float, fleet: FleetParams,
                      n_max: int = 512, max_k: int = 32,
                      device: str | torch.device | None = None
                      ) -> tuple[int, RunTotals]:
    """§5.1: least headroom (integer multiples of the max consecutive-interval
    demand delta, in workers) with zero deadline misses.

    All ``max_k + 1`` headroom levels run as one batch of cells; the
    selected level matches the serial search exactly.
    """
    dev = resolve_device(device)
    interval_s, spin_up_s, horizon = _static_args(fleet, len(counts))
    counts = np.asarray(counts[:horizon])
    unit = headroom_unit(counts, size_s, fleet)
    K = max_k + 1
    args = _batch_args(np.tile(counts, (K, 1)), size_s, fleet,
                       1.0, (np.arange(K) * unit, [0] * K, [1.0] * K), dev)
    acc = accum_numpy(_simulate_cells(get_rate_policy("fpga_dynamic"),
                                      interval_s, spin_up_s, n_max, horizon,
                                      *args))
    zero = np.nonzero(acc.missed_requests == 0)[0]
    k = int(zero[0]) if len(zero) else max_k
    tot = accum_to_totals(Accum(*(leaf[k] for leaf in acc)),
                          float(np.sum(counts) * size_s), int(np.sum(counts)))
    return k * unit, tot
