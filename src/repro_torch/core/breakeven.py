"""Breakeven thresholds (paper Eq. 1 and §4.4) and objective coefficients.

The per-interval allocator rounds the needed-FPGA estimate up when the
residual work exceeds the breakeven service threshold T_b: the service time
beyond which running work on an FPGA beats a CPU for the chosen objective.

The predictor's expected-objective evaluation (Alg. 2) is expressed with
three coefficients so that energy-, cost-, and weighted-optimized variants
share one code path (and one CUDA kernel, `spork_predict`):

    obj(n_hat, n) = co_min  * min(n_hat, n)        # FPGAs doing useful work
                  + co_over * max(n_hat - n, 0)    # over-allocated FPGAs
                  + co_under* max(n - n_hat, 0)    # demand spilling to CPUs

For energy (J per interval):  co_min = B_f*T_s, co_over = I_f*T_s,
                              co_under = S*B_c*T_s
For cost ($ per interval):    co_min = co_over = C_f*T_s (billed idle or not),
                              co_under = S*C_c*T_s
Weighted variants take w*energy_hat + (1-w)*cost_hat with each term
normalized by "one busy FPGA interval" of that metric, making the weight
scale-free.
"""

from __future__ import annotations

from typing import NamedTuple

from .workers import FleetParams


def energy_breakeven_s(fleet: FleetParams) -> float:
    """Eq. 1: T_b * B_c = (T_b/S) * B_f + (T_s - T_b/S) * I_f."""
    S = fleet.S
    num = fleet.T_s * fleet.fpga.idle_w
    den = fleet.cpu.busy_w - fleet.fpga.busy_w / S + fleet.fpga.idle_w / S
    if den <= 0:
        # FPGA is never more efficient than a CPU for this config.
        return float("inf")
    return num / den


def cost_breakeven_s(fleet: FleetParams) -> float:
    """§4.4: T_b = T_s * C_f / (S * C_c)."""
    return fleet.T_s * fleet.fpga.cost_per_hr / (fleet.S * fleet.cpu.cost_per_hr)


def weighted_breakeven_s(fleet: FleetParams, energy_weight: float) -> float:
    """Interpolate the two thresholds for the balanced variant."""
    e = energy_breakeven_s(fleet)
    c = cost_breakeven_s(fleet)
    if e == float("inf"):
        return c
    return energy_weight * e + (1.0 - energy_weight) * c


class ObjectiveCoeffs(NamedTuple):
    """Per-interval objective coefficients for Alg. 2 (see module docstring).

    ``amort_unit`` is the per-new-worker spin-up contribution before the
    lifetime amortization divide (B_f*A_f for energy; C_f*A_f for cost).

    The rate simulator fills the leaves with ``(C,)`` tensors, one value
    per sweep cell; host-side callers use plain floats.
    """

    co_min: float
    co_over: float
    co_under: float
    amort_unit: float

    def scaled(self, s: float) -> "ObjectiveCoeffs":
        return ObjectiveCoeffs(self.co_min * s, self.co_over * s,
                               self.co_under * s, self.amort_unit * s)

    def combine(self, other: "ObjectiveCoeffs") -> "ObjectiveCoeffs":
        return ObjectiveCoeffs(self.co_min + other.co_min,
                               self.co_over + other.co_over,
                               self.co_under + other.co_under,
                               self.amort_unit + other.amort_unit)


def objective_setup(fleet: FleetParams,
                    energy_weight: float) -> tuple[float, ObjectiveCoeffs]:
    """(breakeven threshold T_b, Alg.-2 coefficients) for one objective mix.

    The single host-side source of truth shared by both event-driven
    engines (`sim.events.EventSim` and `sim.events_batched`): weight 1.0
    selects the energy objective, 0.0 the cost objective, anything in
    between the scale-free weighted mix. T_b is clamped to one scheduling
    interval (a request can never buy more than T_s of FPGA time).
    """
    if energy_weight >= 1.0:
        tb, coeffs = energy_breakeven_s(fleet), energy_coeffs(fleet)
    elif energy_weight <= 0.0:
        tb, coeffs = cost_breakeven_s(fleet), cost_coeffs(fleet)
    else:
        tb = weighted_breakeven_s(fleet, energy_weight)
        coeffs = weighted_coeffs(fleet, energy_weight)
    return min(tb, fleet.T_s), coeffs


def energy_coeffs(fleet: FleetParams) -> ObjectiveCoeffs:
    T = fleet.T_s
    return ObjectiveCoeffs(
        co_min=fleet.fpga.busy_w * T,
        co_over=fleet.fpga.idle_w * T,
        co_under=fleet.S * fleet.cpu.busy_w * T,
        amort_unit=fleet.fpga.busy_w * fleet.fpga.spin_up_s,
    )


def cost_coeffs(fleet: FleetParams) -> ObjectiveCoeffs:
    T = fleet.T_s
    return ObjectiveCoeffs(
        co_min=fleet.fpga.cost_per_s * T,
        co_over=fleet.fpga.cost_per_s * T,
        co_under=fleet.S * fleet.cpu.cost_per_s * T,
        amort_unit=fleet.fpga.cost_per_s * fleet.fpga.spin_up_s,
    )


def weighted_coeffs(fleet: FleetParams, energy_weight: float) -> ObjectiveCoeffs:
    """Scale-free weighted objective (see module docstring)."""
    e = energy_coeffs(fleet)
    c = cost_coeffs(fleet)
    e_unit = fleet.fpga.busy_w * fleet.T_s         # J of one busy FPGA interval
    c_unit = fleet.fpga.cost_per_s * fleet.T_s     # $ of one FPGA interval
    return e.scaled(energy_weight / e_unit).combine(
        c.scaled((1.0 - energy_weight) / c_unit))
