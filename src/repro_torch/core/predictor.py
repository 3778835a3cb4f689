"""Spork's lightweight predictor (paper Alg. 2) — conditional-histogram
expected-objective minimization, plus the lifetime map for amortizing
spin-up overheads.

Port of the in-graph half of `repro.core.predictor`. Every function
carries a leading cell axis (the reference vmaps over cells): ``H`` is
``(C, N, N)``, histograms, lifetime statistics and objectives are
``(C, N)``, per-cell scalars are ``(C,)``. `expected_objective` is the
plain PyTorch version of J (a transliteration of
``expected_objective_jnp``); `predict` evaluates J through the
`spork_predict` wrapper, which launches the hand-written CUDA kernel on
the card and uses the plain version for CPU tensors. The stateful
`Predictor` (NumPy state, `predict` on a device) serves the serial
discrete-event simulator.

The expected objective of allocating n_hat given the conditional histogram
p(n) is (see core.breakeven for the coefficient mapping):

    J(n_hat) = amort(n_hat)
             + sum_n p(n) [ co_min*min(n_hat,n) + co_over*(n_hat-n)+
                            + co_under*(n-n_hat)+ ]

    amort(n_hat) = sum_{lvl=n_curr}^{n_hat-1} amort_unit / ceil(life(lvl)/T_s)

Candidates outside [min bin, max bin] of the observed distribution are
dominated and are masked out (+inf), matching Alg. 2's candidate set.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.spork_predict import ops as spork_predict_ops

from .breakeven import ObjectiveCoeffs

_PFX_BLOCK = 32


def _col(x, like: torch.Tensor) -> torch.Tensor:
    """A per-cell scalar (float or ``(C,)`` tensor) as a ``(C, 1)`` or
    ``(1, 1)`` float32 column on ``like``'s device."""
    return torch.as_tensor(x, dtype=torch.float32,
                           device=like.device).reshape(-1, 1)


def _prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis.

    For block-aligned sizes this is the reference's two-level blocked
    scan — prefix-within-block via one triangular matmul, plus the
    cross-block offsets via a second — so the summation order (and the
    fp32 matmul precision it relies on) is the reference's. Other sizes
    use `torch.cumsum`, where the reference uses an associative scan:
    the two agree to float32 rounding.

    The offsets product always runs over at least two rows: over one row
    it is a vector-matrix product, which the CPU's BLAS does not sum in
    sequential order, so a cell's prefix would differ in the last bit
    between a batch of one and a larger batch."""
    n = x.shape[-1]
    b = _PFX_BLOCK
    if n < 2 * b or n % b:
        return torch.cumsum(x, dim=-1)
    k = n // b
    blocks = x.reshape(*x.shape[:-1], k, b)
    incl = torch.triu(torch.ones((b, b), dtype=x.dtype, device=x.device))
    within = blocks @ incl                               # prefix within block
    sums = within[..., -1].reshape(-1, k)                # block totals
    rows = sums.shape[0]
    if rows == 1:
        sums = torch.cat([sums, torch.zeros_like(sums)])
    strict = torch.triu(torch.ones((k, k), dtype=x.dtype, device=x.device), 1)
    offsets = (sums @ strict)[:rows]                     # exclusive offsets
    return (within + offsets.reshape(*x.shape[:-1], k, 1)).reshape(x.shape)


def amortization_vector(life_sum: torch.Tensor, life_cnt: torch.Tensor,
                        n_curr: torch.Tensor, interval_s: float,
                        amort_unit) -> torch.Tensor:
    """amort(n_hat) for every candidate n_hat in [0, N), per cell.

    life_sum/life_cnt: ``(C, N)`` per-level lifetime statistics. Levels
    with no data default to one interval (full spin-up charged,
    conservative). n_curr: ``(C,)``; amort_unit and interval_s: floats or
    ``(C,)`` tensors.
    """
    n = life_sum.shape[-1]
    if torch.is_tensor(interval_s):             # one interval per cell
        interval_s = interval_s.reshape(-1, 1)
    avg_life = torch.where(life_cnt > 0,
                           life_sum / torch.clamp(life_cnt, min=1.0),
                           interval_s)
    epochs = torch.clamp(torch.ceil(avg_life / interval_s), min=1.0)
    per_level = _col(amort_unit, life_sum) / epochs   # cost of a spin-up at level
    lvl = torch.arange(n, device=life_sum.device)
    gated = torch.where(lvl >= n_curr.reshape(-1, 1), per_level, 0.0)
    csum = _prefix_sum(gated)
    # amort(n_hat) = sum over levels < n_hat
    return torch.cat([torch.zeros_like(csum[..., :1]), csum[..., :-1]], dim=-1)


def expected_objective(hist: torch.Tensor, coeffs: ObjectiveCoeffs,
                       amort: torch.Tensor) -> torch.Tensor:
    """J(n_hat) for all n_hat: the plain PyTorch version of the
    `spork_predict` kernel (and the reference for it).

    hist, amort: ``(C, N)`` float32; hist is the unnormalized count
    histogram. coeffs leaves: floats or ``(C,)`` tensors. O(N) via
    prefix sums, with P/M the cumulative probability / first-moment sums:

      E[min(c, n)]  = M(c-1) + c * (P_tot - P(c-1))
      E[(c - n)+]   = c * P(c-1) - M(c-1)
      E[(n - c)+]   = (M_tot - M(c-1)) - c * (P_tot - P(c-1))
    """
    n = hist.shape[-1]
    total = hist.sum(dim=-1, keepdim=True)
    p = hist / torch.clamp(total, min=1.0)
    bins = torch.arange(n, dtype=torch.float32, device=hist.device)
    P = _prefix_sum(p)
    M = _prefix_sum(p * bins)
    zero = torch.zeros_like(P[..., :1])
    Pm1 = torch.cat([zero, P[..., :-1]], dim=-1)         # P(c-1)
    Mm1 = torch.cat([zero, M[..., :-1]], dim=-1)         # M(c-1)
    tail_p = P[..., -1:] - Pm1                           # P(n >= c)
    e_min = Mm1 + bins * tail_p
    e_over = bins * Pm1 - Mm1
    e_under = (M[..., -1:] - Mm1) - bins * tail_p
    j = (_col(coeffs.co_min, hist) * e_min + _col(coeffs.co_over, hist) * e_over
         + _col(coeffs.co_under, hist) * e_under + amort)
    # Candidate range: [min observed bin, max observed bin] (Alg. 2).
    has = hist > 0
    idx = torch.arange(n, device=hist.device)
    lo = torch.where(has, idx, n).amin(dim=-1, keepdim=True)
    hi = torch.where(has, idx, -1).amax(dim=-1, keepdim=True)
    mask = (idx >= lo) & (idx <= hi)
    return torch.where(mask, j, torch.inf)


def predict(H: torch.Tensor, life_sum: torch.Tensor, life_cnt: torch.Tensor,
            n_prev: torch.Tensor, n_curr: torch.Tensor,
            coeffs: ObjectiveCoeffs, interval_s: float) -> torch.Tensor:
    """Alg. 2: n_{t+1} from the histogram conditioned on n_{t-1}, per cell.

    J goes through the `spork_predict` wrapper (the CUDA kernel for CUDA
    tensors). Falls back to n_prev when the conditional histogram is
    empty; `torch.argmin` returns the first minimizer, like the
    reference's `jnp.argmin`.
    """
    rows = torch.arange(H.shape[0], device=H.device)
    hist = H[rows, n_prev.long()]
    amort = amortization_vector(life_sum, life_cnt, n_curr, interval_s,
                                coeffs.amort_unit)
    j = spork_predict_ops.expected_objective(hist, coeffs, amort)
    best = torch.argmin(j, dim=-1).to(torch.int32)
    empty = hist.sum(dim=-1) <= 0
    return torch.where(empty, n_prev.to(torch.int32), best)


def allocator_tick(H: torch.Tensor, life_sum: torch.Tensor,
                   life_cnt: torch.Tensor, n_lag: torch.Tensor,
                   lam: torch.Tensor, n_curr: torch.Tensor,
                   coeffs: ObjectiveCoeffs, interval_s, tb, gate=True
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One complete Alg. 1+2 allocator tick for every cell.

    Folds NeededFPGAs (floor + breakeven rounding on the observed interval
    load ``lam``, in FPGA-seconds), the histogram observation
    ``H[n_lag2, n_needed] += 1``, the lag shift, and `predict`.
    ``n_lag`` is ``(C, 2)`` = [lag1, lag2]. ``H`` is updated in place
    (the simulator owns it) and returned. ``interval_s`` and ``tb`` are
    floats or ``(C,)`` tensors.

    ``gate`` (``(C,)`` bool, or True for every cell) makes the tick a
    no-op on an inactive cell's H and n_lag, bit for bit, while still
    computing a (discarded) target: the discrete-event engine runs one
    gated tick per entry of its flat stream. As in the reference, the
    gate scales the histogram increment rather than selecting between
    two histograms.

    Returns ``(H, n_lag, target)``.
    """
    n_max = H.shape[-1]
    n = torch.floor(lam / interval_s)
    frac = lam - n * interval_s
    n_needed = torch.clamp((n + (frac > tb)).to(torch.int32), max=n_max - 1)
    rows = torch.arange(H.shape[0], device=H.device)
    lag2 = torch.clamp(n_lag[:, 1], max=n_max - 1)
    inc = torch.ones_like(lam) if gate is True else gate.to(lam.dtype)
    H.index_put_((rows, lag2.long(), n_needed.long()), inc, accumulate=True)
    shifted = torch.stack([n_needed, n_lag[:, 0]], dim=1)
    n_lag = shifted if gate is True else torch.where(gate[:, None], shifted,
                                                     n_lag)
    target = predict(H, life_sum, life_cnt, n_needed, n_curr, coeffs,
                     interval_s)
    return H, n_lag, target


def lifetime_update_from_rings(alloc_time: torch.Tensor,
                               life_sum: torch.Tensor, life_cnt: torch.Tensor,
                               young_ring: torch.Tensor,
                               dealloc_ring: torch.Tensor,
                               up_end: torch.Tensor, t_end: int
                               ) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Replay one interval's worth of per-second pool changes into the
    per-level lifetime statistics, in one vectorized pass per cell.

    The rate simulator allocates FPGA slots as a stack: completions push
    levels ``[u, u+c)`` at the top, idle reclaim pops ``[u-d, u)``. The
    per-second loop only records the push/pop COUNTS (``young_ring``/
    ``dealloc_ring``, ``(C, S)``); this replay reconstructs which levels
    were pushed and popped each second:

        alloc_time[i] = last second that pushed level i
        life_sum[i]  += (pop second) - (matching push second)  per pop
        life_cnt[i]  += 1                                      per pop

    All quantities are small integers in float32, so the replay is exact.
    ``t_end`` is the tick time in seconds, shared by every cell; ring slot
    s corresponds to absolute second ``t_end - S + s``.
    """
    S = young_ring.shape[-1]
    n = alloc_time.shape[-1]
    c = young_ring.to(torch.int32)
    d = dealloc_ring.to(torch.int32)
    delta = c - d
    pre = torch.cumsum(delta, dim=-1, dtype=torch.int32)
    u_after = up_end.reshape(-1, 1) - (pre[:, -1:] - pre)   # up after second s
    u_before = u_after - delta                              # up entering second s
    top = u_before + c                                      # up after completions
    lvl = torch.arange(n, device=alloc_time.device)
    pushed = (lvl >= u_before[..., None]) & (lvl < top[..., None])   # (C, S, n)
    popped = (lvl >= u_after[..., None]) & (lvl < top[..., None])
    t_s = (torch.arange(S, device=alloc_time.device) + (t_end - S)).to(
        torch.float32)[:, None]
    push_t = torch.where(pushed, t_s, -torch.inf)
    # alloc time in effect at second s = last push <= s, else the carried
    # alloc_time (push times are monotone, so a running max is exact)
    eff = torch.maximum(torch.cummax(push_t, dim=1).values,
                        alloc_time[:, None, :])
    life_sum = life_sum + torch.where(popped, t_s - eff, 0.0).sum(dim=1)
    life_cnt = life_cnt + popped.sum(dim=1).to(torch.float32)
    return eff[:, -1], life_sum, life_cnt


class Predictor:
    """Stateful Alg. 2 predictor of the serial event-driven simulator.

    Histogram and lifetime statistics are float64 NumPy arrays, as in the
    reference; `predict` hands them to `predict` (as float32, like the
    reference's jitted call) on ``device`` (None: the card), so on the
    card every tick goes through the `spork_predict` kernel."""

    def __init__(self, n_max: int, coeffs: ObjectiveCoeffs, interval_s: float,
                 device: torch.device | str | None = None):
        self.n_max = n_max
        self.coeffs = coeffs
        self.interval_s = interval_s
        self.device = resolve_device(device)
        self.H = np.zeros((n_max, n_max), dtype=np.float64)
        self.life_sum = np.zeros(n_max)
        self.life_cnt = np.zeros(n_max)

    def observe(self, n_lag2: int, n_needed: int) -> None:
        self.H[min(n_lag2, self.n_max - 1), min(n_needed, self.n_max - 1)] += 1

    def record_lifetime(self, level: int, lifetime_s: float) -> None:
        level = min(level, self.n_max - 1)
        self.life_sum[level] += lifetime_s
        self.life_cnt[level] += 1

    def predict(self, n_prev: int, n_curr: int) -> int:
        n_prev = min(n_prev, self.n_max - 1)

        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x)[None], dtype=dtype,
                                   device=self.device)

        out = predict(t(self.H), t(self.life_sum), t(self.life_cnt),
                      t(n_prev, torch.int32), t(n_curr, torch.int32),
                      self.coeffs, self.interval_s)
        return int(out[0])
