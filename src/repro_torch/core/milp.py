"""Pareto-optimal MILP scheduler (paper Table 3), solved exactly with HiGHS.

With perfect knowledge of per-interval arrivals X_t, choose integer worker
allocations Y^w_t (w in {cpu, fpga}) and fractional busy counts B^w_t to
minimize energy, cost, or a weighted sum, subject to:

    r^c B^c_t + r^f B^f_t = X_t              (all work served in-interval)
    B^w_t <= Y^w_t <= N_w
    U^w_t >= Y^w_t - Y^w_{t-1},  D^w_t >= Y^w_{t-1} - Y^w_t   (linearized max)
    Y^f_t >= sum_{tau=t-S+1..t} U^f_tau      (min allocation duration, S>=1)

Energy objective:  sum_t sum_w [ a_w U + d_w D + e_b,w B + e_i,w (Y - B) ]
Cost objective:    sum_t sum_w [ C_w T_s Y + C_w A_w U ]
(the paper's cost formulation "only considers the duration for which
workers are spun up"; spin-up occupancy is billed).

The idealized §3 assumptions hold: allocations are instantaneous but incur
spin-up energy/cost, and all arrivals complete within their interval.

This module is the ground truth; `repro_torch.core.dp` is the scalable
PyTorch equivalent validated against it in tests/test_torch_milp.py.
Transliterated from `repro.core.milp` (numpy + scipy's HiGHS; the port
keeps its own copy).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy import sparse
from scipy.optimize import Bounds, LinearConstraint, milp

from .workers import FleetParams


@dataclass(frozen=True)
class MilpSolution:
    y_cpu: np.ndarray
    y_fpga: np.ndarray
    b_cpu: np.ndarray
    b_fpga: np.ndarray
    objective: float
    energy_j: float
    cost_usd: float
    status: int
    message: str


def _objective_vectors(T: int, fleet: FleetParams):
    """Return (energy_c, cost_c) coefficient vectors over the variable layout
    [Yc(T), Yf(T), Bc(T), Bf(T), Uc(T+1), Dc(T+1), Uf(T+1), Df(T+1)]."""
    Ts = fleet.T_s
    cpu, fpga = fleet.cpu, fleet.fpga
    n = 4 * T + 4 * (T + 1)
    e = np.zeros(n)
    c = np.zeros(n)
    sl = _slices(T)
    # energy: idle on Y, (busy - idle) on B, spin up/down on U/D
    e[sl["Yc"]] = cpu.idle_w * Ts
    e[sl["Yf"]] = fpga.idle_w * Ts
    e[sl["Bc"]] = (cpu.busy_w - cpu.idle_w) * Ts
    e[sl["Bf"]] = (fpga.busy_w - fpga.idle_w) * Ts
    e[sl["Uc"]] = cpu.spin_up_energy_j
    e[sl["Dc"]] = cpu.spin_down_energy_j
    e[sl["Uf"]] = fpga.spin_up_energy_j
    e[sl["Df"]] = fpga.spin_down_energy_j
    # cost: occupancy on Y, spin-up occupancy on U
    c[sl["Yc"]] = cpu.cost_per_s * Ts
    c[sl["Yf"]] = fpga.cost_per_s * Ts
    c[sl["Uc"]] = cpu.cost_per_s * cpu.spin_up_s
    c[sl["Uf"]] = fpga.cost_per_s * fpga.spin_up_s
    return e, c


def _slices(T: int) -> dict[str, slice]:
    names = ["Yc", "Yf", "Bc", "Bf"]
    sl, off = {}, 0
    for nm in names:
        sl[nm] = slice(off, off + T)
        off += T
    for nm in ["Uc", "Dc", "Uf", "Df"]:
        sl[nm] = slice(off, off + T + 1)
        off += T + 1
    return sl


def solve_milp(work_cpu_s: np.ndarray, fleet: FleetParams,
               energy_weight: float = 1.0,
               allow_cpu: bool = True, allow_fpga: bool = True,
               time_limit_s: float | None = 120.0,
               mip_rel_gap: float = 1e-4) -> MilpSolution:
    """Solve Table 3 for per-interval demand ``work_cpu_s`` (CPU-seconds).

    energy_weight=1 -> energy-optimal; 0 -> cost-optimal; in between the
    weighted sum uses scale-free normalization by one busy-FPGA-interval of
    each metric (see core.breakeven).
    """
    W = np.asarray(work_cpu_s, dtype=np.float64)
    T = W.shape[0]
    Ts = fleet.T_s
    S = fleet.S
    sl = _slices(T)
    nvar = 4 * T + 4 * (T + 1)

    e_vec, c_vec = _objective_vectors(T, fleet)
    e_unit = fleet.fpga.busy_w * Ts
    c_unit = fleet.fpga.cost_per_s * Ts
    if energy_weight >= 1.0:
        obj = e_vec
    elif energy_weight <= 0.0:
        obj = c_vec
    else:
        obj = energy_weight * e_vec / e_unit + (1 - energy_weight) * c_vec / c_unit

    rows, lbs, ubs = [], [], []

    def add(row_idx_vals, lb, ub):
        rows.append(row_idx_vals)
        lbs.append(lb)
        ubs.append(ub)

    # 1) serve all work within its interval: Bc_t*Ts + Bf_t*S*Ts = W_t
    for t in range(T):
        add([(sl["Bc"].start + t, Ts), (sl["Bf"].start + t, S * Ts)], W[t], W[t])
    # 2) busy <= allocated
    for w in ("c", "f"):
        for t in range(T):
            add([(sl[f"B{w}"].start + t, 1.0), (sl[f"Y{w}"].start + t, -1.0)],
                -np.inf, 0.0)
    # 3/4) U/D linearization with Y_{-1} = Y_T = 0 boundaries
    for w in ("c", "f"):
        for t in range(T + 1):
            prev = [(sl[f"Y{w}"].start + t - 1, 1.0)] if t >= 1 else []
            cur = [(sl[f"Y{w}"].start + t, 1.0)] if t < T else []
            # U_t >= Y_t - Y_{t-1}   <=>   U_t + Y_{t-1} - Y_t >= 0
            add([(sl[f"U{w}"].start + t, 1.0)] + prev
                + [(i, -v) for i, v in cur], 0.0, np.inf)
            # D_t >= Y_{t-1} - Y_t   <=>   D_t - Y_{t-1} + Y_t >= 0
            add([(sl[f"D{w}"].start + t, 1.0)]
                + [(i, -v) for i, v in prev] + cur, 0.0, np.inf)
    # 5) FPGA minimum allocation duration over S_int intervals
    s_int = max(1, int(round(fleet.fpga.spin_up_s / Ts)))
    if allow_fpga and s_int > 1:
        for t in range(T):
            lo = max(0, t - s_int + 1)
            terms = [(sl["Yf"].start + t, 1.0)]
            terms += [(sl["Uf"].start + tau, -1.0) for tau in range(lo, t + 1)]
            add(terms, 0.0, np.inf)

    data, ri, ci = [], [], []
    for r, row in enumerate(rows):
        for i, v in row:
            ri.append(r)
            ci.append(i)
            data.append(v)
    A = sparse.csr_matrix((data, (ri, ci)), shape=(len(rows), nvar))

    lb = np.zeros(nvar)
    ub = np.full(nvar, np.inf)
    ub[sl["Yc"]] = fleet.max_cpus if allow_cpu else 0
    ub[sl["Yf"]] = fleet.max_fpgas if allow_fpga else 0
    ub[sl["Bc"]] = fleet.max_cpus if allow_cpu else 0
    ub[sl["Bf"]] = fleet.max_fpgas if allow_fpga else 0

    integrality = np.zeros(nvar)
    integrality[sl["Yc"]] = 1
    integrality[sl["Yf"]] = 1

    options = {"mip_rel_gap": mip_rel_gap}
    if time_limit_s is not None:
        options["time_limit"] = time_limit_s
    res = milp(c=obj, constraints=LinearConstraint(A, np.array(lbs), np.array(ubs)),
               integrality=integrality, bounds=Bounds(lb, ub), options=options)
    if res.x is None:
        raise RuntimeError(f"MILP failed: {res.message}")
    x = res.x
    return MilpSolution(
        y_cpu=np.round(x[sl["Yc"]]).astype(int),
        y_fpga=np.round(x[sl["Yf"]]).astype(int),
        b_cpu=x[sl["Bc"]], b_fpga=x[sl["Bf"]],
        objective=float(res.fun),
        energy_j=float(e_vec @ x),
        cost_usd=float(c_vec @ x),
        status=res.status, message=str(res.message),
    )
