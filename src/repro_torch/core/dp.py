"""Min-plus dynamic-programming equivalent of the Table 3 MILP, in PyTorch.

Port of `repro.core.dp` (derivation in its module docstring): given the
FPGA allocation path, the optimal CPU allocation and FPGA/CPU work split
have closed forms, so the MILP collapses to a shortest path over FPGA
levels j in [0, N):

    F_t(j) = min_i [ F_{t-1}(i) + trans_t(i, j) ] + stage_t(j)
    trans(i, j) = af*(j-i)+ + df*(i-j)+ + ac*(v(j)-u(i))+ + dc*(u(i)-v(j))+

with u, v the implied CPU counts of the source and destination interval.
Every function carries a leading batch axis where the reference vmaps:
``(B, N)`` rows and ``(B, 4)`` churn coefficients (af, df, ac, dc). The
time axis is a Python loop over intervals with the whole batch in each
step.

Transition backends (``transition=`` on the solvers), as in the reference:

  dense       O(N^2) per interval: `kernels.minplus.ops.minplus_step`,
              which launches the hand-written dense CUDA kernel on a CUDA
              tensor and runs `minplus_step` (the plain version, the
              reference's `minplus_step_jnp`) on a CPU tensor.
  structured  exact O(N log N) per interval, plain PyTorch (default): the
              value-only pass `_structured_apply_values` plus a dense-row
              backtrack over the stored F history.
  kernel      `kernels.minplus.ops.minplus_step_structured`, the structured
              transition with argmins (hand-written CUDA on the card, the
              plain `minplus_step_structured` on the CPU).

Min and argmin results are bit-identical to the reference on inputs where
float32 arithmetic is exact, with the first minimizer winning every tie;
each product and sum is evaluated in the reference's order.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device

from .metrics import RunTotals
from .workers import FleetParams

_F32 = torch.float32
_I32 = torch.int32
_INF = float("inf")


@dataclass(frozen=True)
class DpSolution:
    y_fpga: np.ndarray           # (T,) optimal FPGA allocation path
    y_cpu: np.ndarray            # (T,) implied CPU allocations
    objective: float
    energy_j: float
    cost_usd: float
    totals: RunTotals


def _check_structure(fleet: FleetParams) -> None:
    cpu, fpga, S, Ts = fleet.cpu, fleet.fpga, fleet.S, fleet.T_s
    if (fpga.busy_w - fpga.idle_w) / S > (cpu.busy_w - cpu.idle_w):
        raise ValueError(
            "FPGA-first serving is not optimal for this config; use core.milp")
    churn = cpu.spin_up_energy_j + cpu.spin_down_energy_j
    if churn > cpu.idle_w * Ts or cpu.spin_up_s > 0.1 * Ts:
        raise ValueError(
            "holding idle CPUs may beat re-allocation for this config; use core.milp")


def _stage_tables(W: torch.Tensor, fleet: FleetParams, n_levels: int,
                  allow_cpu: bool):
    """Per-(interval, level) stage energy/cost and implied CPU counts for
    ``W`` of shape ``(..., T)``; every table is ``(..., T, N)``. The two
    divisors are device tensors: a CUDA division by a host scalar may be
    taken as a product with its reciprocal, which is not bitwise the
    CPU's quotient."""
    Ts, S = fleet.T_s, fleet.S
    cpu, fpga = fleet.cpu, fleet.fpga
    dev = W.device
    j = torch.arange(n_levels, dtype=_F32, device=dev)
    Wt = W.to(_F32)[..., None]
    cap = j * S * Ts
    served_f = torch.minimum(Wt, cap)
    overflow = Wt - served_f
    b_f = served_f / torch.tensor(S * Ts, dtype=_F32, device=dev)
    b_c = overflow / torch.tensor(Ts, dtype=_F32, device=dev)
    y_c = torch.ceil(b_c - 1e-9)
    feasible = (overflow <= 1e-9) | allow_cpu
    stage_e = (fpga.idle_w * Ts * j + (fpga.busy_w - fpga.idle_w) * Ts * b_f
               + cpu.idle_w * Ts * y_c + (cpu.busy_w - cpu.idle_w) * Ts * b_c)
    stage_c = fpga.cost_per_s * Ts * j + cpu.cost_per_s * Ts * y_c
    stage_e = torch.where(feasible, stage_e, 1e30)
    stage_c = torch.where(feasible, stage_c, 1e30)
    return stage_e, stage_c, y_c, served_f, overflow


def _coeff_cols(coeffs, F: torch.Tensor):
    """(af, df, ac, dc), each ``(B, 1)`` float32 on F's device, from a
    ``(B, 4)`` tensor or four scalars / ``(B,)`` tensors."""
    if isinstance(coeffs, torch.Tensor) and coeffs.dim() == 2:
        c = coeffs.to(device=F.device, dtype=_F32)
    else:
        c = torch.stack([torch.as_tensor(x, dtype=_F32, device=F.device)
                         .expand(F.shape[0]) for x in coeffs], dim=1)
    return tuple(c[:, k:k + 1] for k in range(4))


def minplus_step(F: torch.Tensor, yc_prev: torch.Tensor, yc_cur: torch.Tensor,
                 coeffs):
    """One dense min-plus transition for each row: returns (new_F, first
    argmin_i) per destination j, ``(B, N)`` float32 and int32.

    The plain version of the dense `minplus` kernel and the port of the
    reference's ``minplus_step_jnp``: it builds the ``(B, N, N)`` matrix,
    which the kernel never materialises."""
    af, df, ac, dc = (c[:, :, None] for c in _coeff_cols(coeffs, F))
    n = F.shape[-1]
    i = torch.arange(n, dtype=_F32, device=F.device)[:, None]
    jj = torch.arange(n, dtype=_F32, device=F.device)[None, :]
    relu = functools.partial(torch.clamp_min, min=0.0)
    trans = (af * relu(jj - i) + df * relu(i - jj)
             + ac * relu(yc_cur[:, None, :] - yc_prev[:, :, None])
             + dc * relu(yc_prev[:, :, None] - yc_cur[:, None, :]))
    m = F[:, :, None] + trans
    return torch.amin(m, dim=1), torch.argmin(m, dim=1).to(_I32)


# --------------------------------------------------------------------------
# Structured (monotone-decomposition) transition — see the reference's
# module docstring for the segment derivation.
# --------------------------------------------------------------------------

def _first_min_pair(v1, i1, v2, i2):
    """Elementwise (min value, first index) combine: smaller value wins,
    ties go to the smaller index. Commutative and associative."""
    take1 = (v1 < v2) | ((v1 == v2) & (i1 <= i2))
    return torch.where(take1, v1, v2), torch.where(take1, i1, i2)


def _prefix_min_pair(g: torch.Tensor):
    """Inclusive running (min, first-argmin) of ``g`` along its last axis.
    The running min is non-increasing, so the first source attaining
    pv[i] is the first index where pv equals pv[i]: a searchsorted of pv
    against itself (`torch.cummin`'s own indices follow another tie
    rule)."""
    pv = torch.cummin(g, dim=-1).values
    neg = (-pv).contiguous()
    return pv, torch.searchsorted(neg, neg, side="left").to(_I32)


def _suffix_min_pair(g: torch.Tensor):
    """Inclusive running (min, first-argmin) of ``g``, right to left: the
    first minimizer of g[m:] is the first "suffix record" j >= m (a j with
    g[j] == sv[j]), so a reverse cummin over record indices recovers it."""
    n = g.shape[-1]
    sv = torch.cummin(g.flip(-1), dim=-1).values.flip(-1)
    idx = torch.arange(n, dtype=_I32, device=g.device)
    rec = torch.where(g == sv, idx, n)
    return sv, torch.cummin(rec.flip(-1), dim=-1).values.flip(-1)


def _shift_left(x: torch.Tensor, h: int, fill) -> torch.Tensor:
    """x[..., h:] padded on the right with ``fill`` to x's length."""
    pad = torch.full(x.shape[:-1] + (h,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[..., h:], pad], dim=-1)


def _range_min_table(g: torch.Tensor):
    """Doubling (sparse) range-min table over the LAST axis: level s entry
    [..., i] holds the (min, first-argmin) of g[..., i : i + 2**s];
    returns ``(L, *g.shape)`` values and int32 indices."""
    n = g.shape[-1]
    v = g
    a = torch.arange(n, dtype=_I32, device=g.device).expand(g.shape)
    levels_v, levels_a = [v], [a]
    for s in range(1, max(1, n.bit_length())):
        h = 1 << (s - 1)
        v, a = _first_min_pair(v, a, _shift_left(v, h, _INF),
                               _shift_left(a, h, n))
        levels_v.append(v)
        levels_a.append(a)
    return torch.stack(levels_v), torch.stack(levels_a)


def _table_level(length: torch.Tensor, n_table_levels: int) -> torch.Tensor:
    """floor(log2(max(length, 1))) clipped to ``n_table_levels - 1``, from
    the integer bit length: the count of powers 2**r, 1 <= r < L, that do
    not exceed ``length``. The CUDA kernel computes the same value as
    ``31 - __clz(max(length, 1))``; the reference takes a float log2."""
    s = torch.zeros_like(length)
    for r in range(1, n_table_levels):
        s += (length >= (1 << r)).to(length.dtype)
    return s


def _structured_sides(yc_prev: torch.Tensor, yc_cur: torch.Tensor, coeffs,
                      n_table_levels: int):
    """Everything in the structured transition that does NOT depend on F:
    g-vector offsets ``(B, 4, N)``, per-destination h terms, segment
    boundaries and range-query indices (each ``(B, N)``)."""
    af, df, ac, dc = _coeff_cols(coeffs, yc_prev)
    n = yc_prev.shape[-1]
    i = torch.arange(n, dtype=_F32, device=yc_prev.device)
    j = torch.arange(n, dtype=_I32, device=yc_prev.device)

    # Crossing of the CPU relu pair: first i with yc_prev[i] <= yc_cur[j].
    k = torch.searchsorted((-yc_prev).contiguous(), (-yc_cur).contiguous(),
                           side="left").to(_I32)
    m1 = torch.minimum(j, k)
    m2 = torch.maximum(j, k)
    s = _table_level(m2 - m1, n_table_levels)
    r2 = torch.clamp_min(m2 - torch.bitwise_left_shift(torch.ones_like(s), s),
                         0)
    use_g2 = k <= j

    base = torch.stack([-af * i + dc * yc_prev,       # g1 = F + base[:, 0]
                        -af * i - ac * yc_prev,       # g2
                        df * i + dc * yc_prev,        # g3
                        df * i - ac * yc_prev],       # g4
                       dim=-2)
    h1 = af * i - dc * yc_cur
    h4 = -df * i + ac * yc_cur
    h_mid = torch.where(use_g2, af * i + ac * yc_cur, -df * i - dc * yc_cur)
    # table row: 0 -> g2 (k <= j: alloc FPGAs + CPUs), 1 -> g3
    w_mid = torch.where(use_g2, 0, 1).to(_I32)
    return base, (h1, h_mid, h4), (m1, m2, s, r2, w_mid)


def _pad_read(x: torch.Tensor, idx: torch.Tensor, fill, left: bool):
    """``x`` (B, N) padded with one ``fill`` entry (on the left or the
    right) and read at ``idx`` (B, N) in [0, N]."""
    pad = torch.full(x.shape[:-1] + (1,), fill, dtype=x.dtype, device=x.device)
    parts = [pad, x] if left else [x, pad]
    return torch.cat(parts, dim=-1).gather(-1, idx.long())


def _structured_apply(F: torch.Tensor, base: torch.Tensor, hs, qs):
    """F-dependent half of the structured transition: three range-min
    queries per destination over the g vectors, with first argmins."""
    h1, h_mid, h4 = hs
    m1, m2, s, r2, w_mid = qs
    g = F[:, None, :] + base                        # (B, 4, N)

    # Prefix segment [0, m1): exclusive running min of g1.
    pv, pa = _prefix_min_pair(g[:, 0])
    pv = _pad_read(pv, m1, _INF, left=True) + h1
    pa = _pad_read(pa, m1, 0, left=True)

    # Suffix segment [m2, N): exclusive-from-the-right running min of g4.
    sv, sa = _suffix_min_pair(g[:, 3])
    sv = _pad_read(sv, m2, _INF, left=False) + h4
    sa = _pad_read(sa, m2, 0, left=False)

    # Middle segment [m1, m2): one stacked doubling table answers both the
    # g2 (k <= j) and g3 (k > j) cases; w_mid picks the row per query.
    tv, ta = _range_min_table(g[:, 1:3])            # (L, B, 2, N) each
    b = torch.arange(F.shape[0], device=F.device)[:, None]
    s, w_mid = s.long(), w_mid.long()
    q1 = (s, b, w_mid, m1.long())
    q2 = (s, b, w_mid, r2.long())
    mv, ma = _first_min_pair(tv[q1], ta[q1], tv[q2], ta[q2])
    empty = m2 <= m1
    mv = torch.where(empty, _INF, mv) + h_mid
    ma = torch.where(empty, 0, ma)

    # Combine in source-index order (prefix < middle < suffix); strict <
    # keeps the earliest segment on ties => global first minimizer.
    best_v, best_a = pv, pa
    take = mv < best_v
    best_v, best_a = torch.where(take, mv, best_v), torch.where(take, ma, best_a)
    take = sv < best_v
    best_v, best_a = torch.where(take, sv, best_v), torch.where(take, sa, best_a)
    return best_v, best_a.to(_I32)


def _structured_apply_values(F: torch.Tensor, base: torch.Tensor, hs, qs):
    """Value-only `_structured_apply`: every scan, table and query is a
    bare minimum. The DP forward pass runs this and recovers exact argmins
    in the backtrack from the stored F history."""
    h1, h_mid, h4 = hs
    m1, m2, s, r2, w_mid = qs
    n = F.shape[-1]
    g = F[:, None, :] + base

    pv = _pad_read(torch.cummin(g[:, 0], dim=-1).values, m1, _INF,
                   left=True) + h1
    sv = torch.cummin(g[:, 3].flip(-1), dim=-1).values.flip(-1)
    sv = _pad_read(sv, m2, _INF, left=False) + h4

    v = g[:, 1:3]
    levels = [v]
    for s_ in range(1, max(1, n.bit_length())):
        v = torch.minimum(v, _shift_left(v, 1 << (s_ - 1), _INF))
        levels.append(v)
    tv = torch.stack(levels)
    b = torch.arange(F.shape[0], device=F.device)[:, None]
    s, w_mid = s.long(), w_mid.long()
    mv = torch.minimum(tv[s, b, w_mid, m1.long()], tv[s, b, w_mid, r2.long()])
    mv = torch.where(m2 <= m1, _INF, mv) + h_mid
    return torch.minimum(torch.minimum(pv, mv), sv)


def _structured_transition(F: torch.Tensor, yc_prev: torch.Tensor,
                           yc_cur: torch.Tensor, coeffs):
    """Exact structured min-plus transition; requires every row of yc_prev
    and yc_cur non-increasing."""
    L = max(1, F.shape[-1].bit_length())
    base, hs, qs = _structured_sides(yc_prev, yc_cur, coeffs, L)
    return _structured_apply(F, base, hs, qs)


def minplus_step_structured(F: torch.Tensor, yc_prev: torch.Tensor,
                            yc_cur: torch.Tensor, coeffs, check: bool = True):
    """Drop-in replacement for `minplus_step` in O(N log N) per row.

    Exact — values, argmins and first-minimizer ties match the dense
    transition — on rows whose y_c vectors are both non-increasing, which
    `_stage_tables` guarantees by construction. With ``check=True`` each
    row is checked and rows that break the precondition take the dense
    transition, as the reference's ``lax.cond`` does per row; the DP and
    the structured kernel's plain version use ``check=False``. This is the
    plain version of the `minplus_structured` kernel."""
    if not check:
        return _structured_transition(F, yc_prev, yc_cur, coeffs)
    c = torch.cat(_coeff_cols(coeffs, F), dim=1)
    mono = ((yc_prev[:, 1:] <= yc_prev[:, :-1]).all(dim=1)
            & (yc_cur[:, 1:] <= yc_cur[:, :-1]).all(dim=1))
    out = torch.empty_like(F, dtype=_F32)
    arg = torch.empty(F.shape, dtype=_I32, device=F.device)
    for rows, step in ((mono, _structured_transition), (~mono, minplus_step)):
        if bool(rows.any()):
            out[rows], arg[rows] = step(F[rows], yc_prev[rows], yc_cur[rows],
                                        c[rows])
    return out, arg


TRANSITIONS = ("dense", "structured", "kernel")


def _transition_step(transition: str):
    """Resolve a transition backend name to a batched step function (see
    the module docstring). `_stage_tables` y_c is non-increasing by
    construction, so the structured paths skip the monotonicity check."""
    if transition == "dense":
        from repro_torch.kernels.minplus import ops as minplus_ops
        return minplus_ops.minplus_step
    if transition == "structured":
        return functools.partial(minplus_step_structured, check=False)
    if transition == "kernel":
        from repro_torch.kernels.minplus import ops as minplus_ops
        return minplus_ops.minplus_step_structured
    raise ValueError(f"unknown transition {transition!r}; "
                     f"expected one of {TRANSITIONS}")


def _dp_forward_core(stage_obj: torch.Tensor, y_c: torch.Tensor,
                     coeffs: torch.Tensor, n_levels: int,
                     transition: str = "structured"):
    """Forward min-plus pass + backtrack for a batch of problems:
    stage_obj, y_c ``(B, T, N)``, coeffs ``(B, 4)``. Returns the paths
    ``(B, T)`` int32 and the optimal objectives ``(B,)``."""
    af, df, ac, dc = _coeff_cols(coeffs, stage_obj)
    B, T, N = stage_obj.shape
    dev = stage_obj.device
    j = torch.arange(n_levels, dtype=_F32, device=dev)
    # boundary 0: from empty fleet
    F = af * j + ac * y_c[:, 0] + stage_obj[:, 0]

    if transition == "structured":
        # Value-only forward pass (no argmin bookkeeping); each interval's
        # incoming F row is kept, and the backtrack recovers each argmin by
        # evaluating ONE dense transition row per interval (first-minimizer
        # semantics of the dense formula by construction).
        L = max(1, int(n_levels).bit_length())
        F_hist = torch.empty((B, T - 1, N), dtype=_F32, device=dev)
        for t in range(T - 1):
            F_hist[:, t] = F
            base, hs, qs = _structured_sides(y_c[:, t], y_c[:, t + 1],
                                             coeffs, L)
            F = _structured_apply_values(F, base, hs, qs) + stage_obj[:, t + 1]
        # closing boundary: dealloc everything
        end = F + df * j + dc * y_c[:, -1]
        carry = torch.argmin(end, dim=1).to(_I32)
        path = [carry]
        relu = functools.partial(torch.clamp_min, min=0.0)
        for t in reversed(range(T - 1)):
            jf = carry.to(_F32)[:, None]
            yc_prev = y_c[:, t]
            v = y_c[:, t + 1].gather(1, carry.long()[:, None])
            row = (F_hist[:, t] + af * relu(jf - j) + df * relu(j - jf)
                   + ac * relu(v - yc_prev) + dc * relu(yc_prev - v))
            carry = torch.argmin(row, dim=1).to(_I32)
            path.append(carry)
        return torch.stack(path[::-1], dim=1), torch.amin(end, dim=1)

    step = _transition_step(transition)
    args = torch.empty((B, T - 1, N), dtype=_I32, device=dev)
    for t in range(T - 1):
        newF, arg = step(F, y_c[:, t], y_c[:, t + 1], coeffs)
        F = newF + stage_obj[:, t + 1]
        args[:, t] = arg
    # closing boundary: dealloc everything
    end = F + df * j + dc * y_c[:, -1]
    carry = torch.argmin(end, dim=1).to(_I32)
    path = [carry]
    for t in reversed(range(T - 1)):
        carry = args[:, t].gather(1, carry.long()[:, None])[:, 0]
        path.append(carry)
    return torch.stack(path[::-1], dim=1), torch.amin(end, dim=1)


def _objective_weights(energy_weight: float, fleet: FleetParams):
    """(we, wc) mixing weights in normalized objective units."""
    e_unit = fleet.fpga.busy_w * fleet.T_s
    c_unit = fleet.fpga.cost_per_s * fleet.T_s
    we = energy_weight / e_unit if energy_weight > 0 else 0.0
    wc = (1 - energy_weight) / c_unit if energy_weight < 1 else 0.0
    if energy_weight >= 1.0:
        we, wc = 1.0, 0.0
    if energy_weight <= 0.0:
        we, wc = 0.0, 1.0
    return we, wc


def _churn_coeffs(we, wc, fleet: FleetParams):
    return [
        we * fleet.fpga.spin_up_energy_j
        + wc * fleet.fpga.cost_per_s * fleet.fpga.spin_up_s,
        we * fleet.fpga.spin_down_energy_j,
        we * fleet.cpu.spin_up_energy_j
        + wc * fleet.cpu.cost_per_s * fleet.cpu.spin_up_s,
        we * fleet.cpu.spin_down_energy_j,
    ]


def _solve_batch(W_b: np.ndarray, wewc: np.ndarray, coeffs_b: np.ndarray,
                 fleet: FleetParams, n_levels: int, allow_cpu: bool,
                 transition: str, dev: torch.device):
    """Stage tables + min-plus forward for a whole batch on ``dev``.

    W_b: (B, T) per-interval work; wewc: (B, 2) float32 objective weights;
    coeffs_b: (B, 4) float32 churn coefficients. Returns numpy (paths
    (B, T), objectives (B,))."""
    W = torch.as_tensor(W_b, dtype=_F32, device=dev)
    stage_e, stage_c, y_c, _, _ = _stage_tables(W, fleet, n_levels, allow_cpu)
    w = torch.as_tensor(wewc, dtype=_F32, device=dev)
    stage_obj = w[:, 0, None, None] * stage_e + w[:, 1, None, None] * stage_c
    del stage_e, stage_c
    paths, objs = _dp_forward_core(
        stage_obj, y_c, torch.as_tensor(coeffs_b, dtype=_F32, device=dev),
        n_levels, transition)
    return paths.cpu().numpy(), objs.cpu().numpy()


def _resolve_transition(transition: str, use_kernel: bool) -> str:
    """``use_kernel=True`` means the structured kernel, as in the
    reference, where it predates the ``transition`` selector."""
    if use_kernel:
        transition = "kernel"
    if transition not in TRANSITIONS:
        raise ValueError(f"unknown transition {transition!r}; "
                         f"expected one of {TRANSITIONS}")
    return transition


def level_buckets(work_batch: np.ndarray, fleet: FleetParams,
                  allow_fpga: bool = True, n_levels: int | None = None,
                  transition: str = "structured") -> np.ndarray:
    """The level count each row of `solve_dp_batch` is solved at; rows of
    one count go in one batched dispatch. Dense: each row's own
    peak-demand count rounded up to a multiple of 128, since its work is
    O(N^2) per interval. Structured/kernel: every row at the batch's
    largest count, one dispatch per call. An explicit ``n_levels`` (or
    ``allow_fpga=False``: one level) overrides both."""
    W = np.asarray(work_batch, dtype=np.float64)
    B = W.shape[0]
    if not allow_fpga:
        return np.ones((B,), dtype=np.int64)
    if n_levels is not None:
        return np.full((B,), n_levels, dtype=np.int64)
    per_row = np.ceil(W.max(axis=1) / (fleet.S * fleet.T_s)) + 2
    buckets = (128 * np.ceil(per_row / 128)).astype(np.int64)
    if transition != "dense":
        buckets = np.full((B,), buckets.max(), dtype=np.int64)
    return buckets


def solve_dp_batch(work_batch: np.ndarray, fleet: FleetParams,
                   energy_weights, allow_cpu: bool = True,
                   allow_fpga: bool = True, n_levels: int | None = None,
                   use_kernel: bool = False, transition: str = "structured",
                   device: str | torch.device | None = None
                   ) -> list[DpSolution]:
    """Batched `solve_dp`: row i of ``work_batch`` is solved with
    ``energy_weights[i]``, one batched dispatch per level bucket
    (`level_buckets`). The DP optimum is invariant to extra levels, so the
    bucket is a pure shape/speed choice; per-row results equal `solve_dp`
    at the same ``n_levels``. ``device=None`` means the CUDA card."""
    transition = _resolve_transition(transition, use_kernel)
    _check_structure(fleet)
    dev = resolve_device(device)
    W_np = np.asarray(work_batch, dtype=np.float64)
    if W_np.ndim != 2:
        raise ValueError(f"work_batch must be (B, T), got {W_np.shape}")
    B = W_np.shape[0]
    weights = np.asarray(energy_weights, dtype=np.float64)
    if weights.shape != (B,):
        raise ValueError("energy_weights must align with work_batch rows")

    buckets = level_buckets(W_np, fleet, allow_fpga, n_levels, transition)
    wewc = np.array([_objective_weights(float(w), fleet) for w in weights],
                    np.float32)
    coeffs_b = np.array([_churn_coeffs(we, wc, fleet) for we, wc in wewc],
                        np.float32)

    out: list[DpSolution | None] = [None] * B
    for nl in np.unique(buckets):
        rows = np.nonzero(buckets == nl)[0]
        paths, objs = _solve_batch(W_np[rows], wewc[rows], coeffs_b[rows],
                                   fleet, int(nl), allow_cpu, transition, dev)
        for k, b in enumerate(rows):
            out[b] = evaluate_path(W_np[b], paths[k], fleet,
                                   objective=float(objs[k]))
    return out


def solve_dp(work_cpu_s: np.ndarray, fleet: FleetParams,
             energy_weight: float = 1.0, allow_cpu: bool = True,
             allow_fpga: bool = True, n_levels: int | None = None,
             use_kernel: bool = False, transition: str = "structured",
             device: str | torch.device | None = None) -> DpSolution:
    """Solve the idealized scheduler by min-plus DP and evaluate the path.
    ``device=None`` means the CUDA card."""
    transition = _resolve_transition(transition, use_kernel)
    _check_structure(fleet)
    dev = resolve_device(device)
    Ts, S = fleet.T_s, fleet.S
    if n_levels is None:
        n_levels = int(np.ceil(float(np.max(work_cpu_s)) / (S * Ts))) + 2
    if not allow_fpga:
        n_levels = 1
    we, wc = _objective_weights(energy_weight, fleet)
    # the churn coefficients from the float64 weights, as the reference's
    # single solve takes them (the batch takes them from float32 weights)
    coeffs = np.array([_churn_coeffs(we, wc, fleet)], np.float32)
    W = np.asarray(work_cpu_s, dtype=np.float64)
    paths, objs = _solve_batch(W[None], np.array([[we, wc]], np.float32),
                               coeffs, fleet, n_levels, allow_cpu, transition,
                               dev)
    return evaluate_path(W, paths[0], fleet, objective=float(objs[0]))


def evaluate_path(W: np.ndarray, y_fpga: np.ndarray, fleet: FleetParams,
                  objective: float = float("nan")) -> DpSolution:
    """Exact energy/cost accounting for a given FPGA allocation path
    (FPGA-first serving, implied CPU allocations). NumPy float64."""
    Ts, S = fleet.T_s, fleet.S
    cpu, fpga = fleet.cpu, fleet.fpga
    y = np.asarray(y_fpga, dtype=np.float64)
    W = np.asarray(W, dtype=np.float64)
    cap = y * S * Ts
    served_f = np.minimum(W, cap)
    overflow = W - served_f
    if np.any(overflow > 1e-6) and fleet.max_cpus == 0:
        raise ValueError("infeasible path: overflow with no CPUs allowed")
    b_f = served_f / (S * Ts)
    b_c = overflow / Ts
    y_cpu = np.ceil(b_c - 1e-9)

    dy_f = np.diff(np.concatenate([[0.0], y, [0.0]]))
    dy_c = np.diff(np.concatenate([[0.0], y_cpu, [0.0]]))
    alloc_f, dealloc_f = np.sum(np.maximum(dy_f, 0)), np.sum(np.maximum(-dy_f, 0))
    alloc_c, dealloc_c = np.sum(np.maximum(dy_c, 0)), np.sum(np.maximum(-dy_c, 0))

    fpga_busy_j = float(np.sum(b_f) * fpga.busy_w * Ts)
    fpga_idle_j = float(np.sum(y - b_f) * fpga.idle_w * Ts)
    cpu_busy_j = float(np.sum(b_c) * cpu.busy_w * Ts)
    cpu_idle_j = float(np.sum(y_cpu - b_c) * cpu.idle_w * Ts)
    spin_j = float(alloc_f * fpga.spin_up_energy_j + dealloc_f * fpga.spin_down_energy_j
                   + alloc_c * cpu.spin_up_energy_j + dealloc_c * cpu.spin_down_energy_j)
    energy = fpga_busy_j + fpga_idle_j + cpu_busy_j + cpu_idle_j + spin_j
    cost = float(np.sum(y) * fpga.cost_per_s * Ts + np.sum(y_cpu) * cpu.cost_per_s * Ts
                 + alloc_f * fpga.cost_per_s * fpga.spin_up_s
                 + alloc_c * cpu.cost_per_s * cpu.spin_up_s)

    totals = RunTotals(
        energy_j=energy, cost_usd=cost, work_cpu_s=float(np.sum(W)),
        work_on_fpga_cpu_s=float(np.sum(served_f)),
        work_on_cpu_cpu_s=float(np.sum(overflow)),
        fpga_spinups=int(alloc_f), cpu_spinups=int(alloc_c),
        fpga_idle_j=fpga_idle_j, fpga_busy_j=fpga_busy_j, cpu_busy_j=cpu_busy_j,
        spinup_j=spin_j,
    )
    return DpSolution(y_fpga=y.astype(int), y_cpu=y_cpu.astype(int),
                      objective=objective, energy_j=energy, cost_usd=cost,
                      totals=totals)


PARETO_WEIGHTS = np.concatenate([[0.0], np.geomspace(0.02, 1.0, 9)])


def pareto_front(work_cpu_s: np.ndarray, fleet: FleetParams,
                 weights: np.ndarray | None = None, **kw) -> list[DpSolution]:
    """Sweep the energy/cost weighting (paper Fig. 3 pareto curves): all
    weights are solved in one `solve_dp_batch` call (``device=`` and the
    other keywords pass through)."""
    if weights is None:
        weights = PARETO_WEIGHTS
    weights = np.asarray(weights, dtype=np.float64)
    W = np.asarray(work_cpu_s, dtype=np.float64)
    W_b = np.broadcast_to(W, (len(weights), len(W)))
    return solve_dp_batch(W_b, fleet, weights, **kw)
