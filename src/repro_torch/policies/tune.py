"""Gradient-based policy tuning through a fluid relaxation of the rate
simulator (port of `repro.policies.tune`).

The §5.1 grid search (`ratesim.tune_fpga_dynamic`) evaluates every
integer headroom level; it scales linearly in levels and cannot tune the
predictive policy's forecast gain at all. This module tunes `RateParams`
by gradient descent on a smooth *fluid relaxation* of the fpga_dynamic /
predictive control loop (`relaxed_cost`): provisioning becomes a
first-order lag whose speed encodes the spin-up latency, and the
deadline-miss indicator a softplus of capacity shortfall. The continuous
optimum is then integer-refined with the REAL simulator, together with
the grid-search optimum itself, so `tune_gradient` matches or beats
`tune_fpga_dynamic` on the true objective by construction.

Where the reference compiles the relaxation into one XLA scan and takes
`jax.grad` of it, a tensor on the card goes through the hand-written
`relax` kernels (one launch forward, one backward, behind a
`torch.autograd.Function`); a tensor on the CPU through the plain torch
loop, with autograd. The relaxation follows theta's type: the gradient
checks run it in float64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.metrics import RunTotals
from repro_torch.core.workers import FleetParams
from repro_torch.device import resolve_device
from repro_torch.kernels import relax
from repro_torch.kernels.relax import ref as relax_ref

#: One deadline miss outweighs any plausible energy saving — the grid
#: search's lexicographic (misses, then energy) order, as one scalar.
MISS_PENALTY_J = 1e9


class RelaxSpec(NamedTuple):
    """Static description of one relaxed tuning problem: the per-interval
    demand on a device, then the plain floats the kernels take as their
    constants (in this order)."""

    demand: torch.Tensor    # (K,) work per interval, CPU-seconds
    interval_s: float
    spin_up_s: float
    S: float                # FPGA speedup
    I_f: float              # FPGA idle W
    B_f: float              # FPGA busy W
    miss_weight: float      # J-equivalent per CPU-second of shortfall
    sharp: float            # softness knob: higher == closer to exact


def make_spec(counts, size_s: float, fleet: FleetParams,
              miss_weight: float = 2000.0, sharp: float = 4.0,
              dtype=torch.float32,
              device: str | torch.device | None = None) -> RelaxSpec:
    """Build a `RelaxSpec` from a per-second trace + fleet parameters;
    the demand is summed in float64 and cast to ``dtype`` on ``device``."""
    interval_s = max(int(round(fleet.T_s)), 1)
    spin_up_s = max(int(round(fleet.fpga.spin_up_s)), 1)
    counts = np.asarray(counts, np.float64)
    k = len(counts) // interval_s
    demand = counts[:k * interval_s].reshape(k, interval_s).sum(1) * size_s
    return RelaxSpec(
        demand=torch.as_tensor(demand, dtype=dtype,
                               device=resolve_device(device)),
        interval_s=float(interval_s), spin_up_s=float(spin_up_s),
        S=float(fleet.S), I_f=float(fleet.fpga.idle_w),
        B_f=float(fleet.fpga.busy_w), miss_weight=float(miss_weight),
        sharp=float(sharp))


def _softplus(x, sharp):
    """Smooth max(x, 0) with sharpness knob; -> relu as sharp -> inf.
    Exact at every x (``torch.nn.functional.softplus`` turns linear above
    20, ``jax.nn.softplus`` does not)."""
    return relax_ref.softplus(x, sharp)


def _theta(theta, spec: RelaxSpec) -> torch.Tensor:
    if isinstance(theta, torch.Tensor):
        return theta
    return torch.as_tensor(theta, dtype=spec.demand.dtype,
                           device=spec.demand.device)


def relaxed_cost(theta, spec: RelaxSpec) -> torch.Tensor:
    """Differentiable surrogate of the fpga_dynamic / predictive loop.

    ``theta`` is ``(headroom, gain, util)``: continuous headroom in
    workers, the predictive trend-extrapolation gain, and the
    utilization target the provisioner divides demand by. Per interval:
    forecast ``lam_hat = lam + gain * (lam - lam_prev)``, target
    ``lam_hat / util + headroom``, then the FPGA count relaxes toward the
    target, upward at the spin-up-lagged rate ``interval / (interval +
    spin_up)``, downward at once. Cost: idle energy + spin-up energy +
    ``miss_weight`` x softplus capacity shortfall, summed over the
    intervals.

    A theta on the card goes through the `relax` kernels (forward and
    reverse one launch each; the sum kept in double, in interval order);
    a theta on the CPU through the plain loop (``torch.sum`` of the
    stacked costs, pairwise, as the reference sums after its scan).
    float32: the two agree to rtol 1e-5; float64 to 1e-10. A tuple or
    list theta is made a tensor on the spec's device and type."""
    theta = _theta(theta, spec)
    consts = tuple(spec[1:])
    if theta.device.type == "cpu":
        return relax_ref.relaxed_cost_ref(theta, spec.demand, consts)
    return relax.relaxed_cost(theta, spec.demand, consts)


def relaxed_grad(theta, spec: RelaxSpec) -> torch.Tensor:
    """dcost/dtheta (3,) at ``theta`` (the reference's ``jax.grad`` of
    `relaxed_cost`)."""
    th = _theta(theta, spec).detach().requires_grad_(True)
    with torch.enable_grad():
        g, = torch.autograd.grad(relaxed_cost(th, spec), th)
    return g


def fit(spec: RelaxSpec, theta0=(0.0, 1.0, 0.9), steps: int = 300,
        lr: float = 0.1):
    """Adam on `relaxed_cost` with the reference's constants. Returns
    (theta, loss_curve). Projection after each step keeps theta in the
    domain the real policies accept (headroom >= 0, gain in [0, 4], util
    in [0.5, 1]).

    Each step is one forward of `relaxed_cost`, which gives the loss at
    theta_t, and one reverse pass, which gives its gradient; the step then
    moves theta. The losses stay on the device and are read once, at the
    end (``steps + 1`` of them: the last at the final theta)."""
    dt, dev = spec.demand.dtype, spec.demand.device
    theta = torch.as_tensor(theta0, dtype=dt, device=dev)
    lo = torch.tensor([0.0, 0.0, 0.5], dtype=dt, device=dev)
    hi = torch.tensor([1e6, 4.0, 1.0], dtype=dt, device=dev)
    b1, b2, eps = 0.9, 0.999, 1e-8
    m = torch.zeros_like(theta)
    v = torch.zeros_like(theta)
    losses = []
    for t in range(1, steps + 1):
        th = theta.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = relaxed_cost(th, spec)
            g, = torch.autograd.grad(loss, th)
        losses.append(loss.detach())
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        theta = torch.clamp(theta - lr * mhat / (torch.sqrt(vhat) + eps),
                            lo, hi)
    with torch.no_grad():
        losses.append(relaxed_cost(theta, spec))
    return theta, torch.stack(losses).tolist()


class TuneResult(NamedTuple):
    """Outcome of `tune_gradient` (all real-simulator numbers)."""

    headroom: int           # selected integer headroom (workers)
    gain: float             # selected forecast gain (1.0 for fpga_dynamic)
    totals: RunTotals       # real-simulator totals at the selection
    objective: float        # energy_j + MISS_PENALTY_J * misses
    theta: tuple            # continuous optimum (headroom, gain, util)
    losses: tuple           # surrogate loss curve (monitoring)
    grid_headroom: int      # §5.1 grid-search optimum, for comparison
    grid_objective: float
    source: str             # "gradient" (refined point won) | "grid"
    n_sim_evals: int        # real-simulator evaluations spent refining


def objective_of(tot: RunTotals) -> float:
    """Scalar true objective: energy with a lexicographic-scale miss
    penalty, so zero-miss always beats any-miss (the grid search's
    selection rule)."""
    return float(tot.energy_j) + MISS_PENALTY_J * float(tot.deadline_misses)


def tune_gradient(counts, size_s: float, fleet: FleetParams,
                  policy: str = "fpga_dynamic", n_max: int = 512,
                  steps: int = 300, lr: float = 0.1,
                  miss_weight: float = 2000.0,
                  device: str | torch.device | None = None) -> TuneResult:
    """Gradient-tune a rate policy's `RateParams` on one trace, on
    ``device`` (None: the card).

    Descends `relaxed_cost` (float32, as the reference), integer-refines
    the continuous optimum with real-simulator evaluations (floor, ceil
    and ceil + 1 of the continuous headroom, and the grid optimum's two
    lower neighbours; x {1, the fitted gain} for the predictive policy),
    and compares against the §5.1 grid-search optimum, which joins the
    candidate set."""
    from repro_torch.sim import ratesim

    dev = resolve_device(device)
    spec = make_spec(counts, size_s, fleet, miss_weight=miss_weight,
                     device=dev)
    theta, losses = fit(spec, steps=steps, lr=lr)
    theta = tuple(theta.tolist())
    h_star, g_star = theta[0], theta[1]

    grid_h, grid_tot = ratesim.tune_fpga_dynamic(counts, size_s, fleet,
                                                 n_max=n_max, device=dev)
    grid_obj = objective_of(grid_tot)

    # Refine window: around the continuous optimum AND just below the
    # grid optimum (the grid samples only multiples of its unit, so the
    # integer optimum often sits between (k-1) and k units).
    heads = sorted({max(h, 0) for h in
                    (int(np.floor(h_star)), int(np.ceil(h_star)),
                     int(np.ceil(h_star)) + 1,
                     int(grid_h) - 2, int(grid_h) - 1)})
    gains = ((1.0,) if policy != "predictive"
             else tuple(sorted({1.0, round(g_star, 3)})))
    best = (grid_obj, int(grid_h), 1.0, grid_tot, "grid")
    n_evals = 0
    for h in heads:
        for g in gains:
            tot = ratesim.simulate(policy, counts, size_s, fleet,
                                   headroom=h, n_max=n_max,
                                   forecast_gain=g, device=dev)
            n_evals += 1
            obj = objective_of(tot)
            if obj < best[0]:
                best = (obj, h, g, tot, "gradient")

    obj, h, g, tot, source = best
    return TuneResult(
        headroom=h, gain=g, totals=tot, objective=obj, theta=theta,
        losses=tuple(losses), grid_headroom=int(grid_h),
        grid_objective=grid_obj, source=source, n_sim_evals=n_evals)
