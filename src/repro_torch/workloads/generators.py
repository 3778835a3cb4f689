"""Workload generators on a `torch.Generator`: per-second rates, counts
and request sizes.

Port of `repro.workloads.generators`. Every generator is a function of an
explicit ``torch.Generator`` plus scalar shape parameters and returns a
float32 tensor on the generator's device, so
`repro_torch.workloads.scenarios.realize` synthesizes a scenario's seed
batch on the card. The reference draws from `jax.random`, whose streams
cannot be reproduced here: the two agree in distribution only, which the
`repro_torch.workloads.stats` validators check against the registry's
ranges.

Families:

  * ``bmodel_rates`` — the paper's §5.1 self-similar b-model at
    per-minute resolution with linear interpolation to seconds.
  * ``mmpp_rates`` — a 2-state Markov-modulated Poisson process:
    geometric burst episodes at a multiple of the baseline rate,
    normalized so the stationary mean equals the target.
  * ``diurnal_rates`` — two-harmonic daily shape with lognormal
    multiplicative noise; ``flash_crowd_overlay`` multiplies in a
    ramp-then-exponential-decay spike at a random onset.
  * ``pareto_sizes`` / ``lognormal_sizes`` — heavy-tail request-size
    samplers.
  * ``poisson_counts`` — Poisson arrival counts for a rate grid.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.bmodel import bmodel_series_torch

_F32 = torch.float32


def _arange(n: int, g: torch.Generator) -> torch.Tensor:
    return torch.arange(n, dtype=_F32, device=g.device)


def interp_minutes(per_min: torch.Tensor, horizon_s: int) -> torch.Tensor:
    """Linear per-minute -> per-second interpolation (paper §5.1 rates
    "change linearly within each minute"). ``per_min`` has ``minutes + 1``
    entries so the last minute interpolates toward a real endpoint."""
    minutes = per_min.shape[0] - 1
    t = torch.arange(horizon_s, dtype=_F32, device=per_min.device)
    idx = torch.clamp((t // 60).long(), max=minutes - 1)
    frac = (t % 60) / 60.0
    return (per_min[idx] * (1 - frac)
            + per_min[torch.clamp(idx + 1, max=minutes)] * frac)


def bmodel_rates(g: torch.Generator, bias: float, horizon_s: int,
                 mean_rate: float) -> torch.Tensor:
    """Per-second rates from a per-minute b-model cascade + interpolation:
    the smallest power-of-two cascade covering ``minutes + 1`` per-minute
    volumes, truncated, then interpolated to seconds."""
    minutes = int(np.ceil(horizon_s / 60.0))
    levels = max(1, int(np.ceil(np.log2(max(minutes + 1, 2)))))
    n = 2 ** levels
    total = float(np.float32(mean_rate) * np.float32(n))
    per_min = bmodel_series_torch(g, bias, levels, total)[:minutes + 1]
    return interp_minutes(per_min, horizon_s)


def mmpp_rates(g: torch.Generator, horizon_s: int, mean_rate,
               burst_ratio=8.0, p_enter=0.02, p_exit=0.2) -> torch.Tensor:
    """2-state MMPP rates, one step a second.

    State 0 emits a baseline rate, state 1 emits ``burst_ratio`` x the
    baseline; per-second transition probabilities ``p_enter``/``p_exit``
    give geometric episode lengths (mean burst ``1/p_exit`` s). The
    baseline is scaled so the *stationary* mean rate equals
    ``mean_rate``. The uniforms are drawn in one call on the generator's
    device; the chain itself is sequential, so it runs as a host loop
    over the seconds (one transfer each way)."""
    ratio = np.float32(burst_ratio)
    pe, px = np.float32(p_enter), np.float32(p_exit)
    pi_burst = pe / (pe + px)
    base = np.float32(mean_rate) / (np.float32(1.0)
                                    + (ratio - np.float32(1.0)) * pi_burst)
    u = torch.rand(horizon_s, generator=g, device=g.device).cpu().numpy()
    stay, enter = np.float32(1.0) - px, pe
    burst = np.zeros(horizon_s, bool)
    state = False
    for k in range(horizon_s):
        state = bool(u[k] < (stay if state else enter))
        burst[k] = state
    rates = np.where(burst, base * ratio, base).astype(np.float32)
    return torch.from_numpy(rates).to(g.device)


def diurnal_rates(g: torch.Generator, horizon_s: int, mean_rate,
                  period_s=86400.0, amp1=0.6, amp2=0.25, phase=0.0,
                  noise=0.08) -> torch.Tensor:
    """Two-harmonic diurnal shape with lognormal multiplicative noise,
    renormalized so the realized mean equals ``mean_rate``."""
    t = _arange(horizon_s, g)
    w = 2.0 * math.pi * t / float(np.float32(period_s))
    shape = (1.0 + float(np.float32(amp1)) * torch.sin(w + phase)
             + float(np.float32(amp2)) * torch.sin(2.0 * w + 0.7 + phase))
    shape = torch.clamp(shape, min=0.0)
    nz = float(np.float32(noise))
    z = torch.randn(horizon_s, generator=g, device=g.device)
    mult = torch.exp(nz * z - 0.5 * nz * nz)
    rates = shape * mult
    return (float(np.float32(mean_rate)) * rates
            / torch.clamp(rates.mean(), min=1e-9))


def flash_crowd_overlay(g: torch.Generator, horizon_s: int, amp=8.0,
                        ramp_s=30.0, decay_s=300.0,
                        window=(0.2, 0.7)) -> torch.Tensor:
    """Multiplicative flash-crowd spike: 1 everywhere except a linear
    ramp to ``amp`` over ``ramp_s`` starting at a random onset (uniform
    in ``window`` as a fraction of the horizon), then exponential decay
    with time constant ``decay_s``. Multiply into any base rate."""
    t = _arange(horizon_s, g)
    lo, hi = window
    u = torch.rand((), generator=g, device=g.device)
    t0 = (lo + (hi - lo) * u) * horizon_s
    dt = t - t0
    ramp = torch.clamp(dt / float(ramp_s), 0.0, 1.0)
    decay = torch.exp(-torch.clamp(dt - float(ramp_s), min=0.0)
                      / float(decay_s))
    return 1.0 + (float(amp) - 1.0) * ramp * decay


def pareto_sizes(g: torch.Generator, n: int, alpha=1.6, x_min_s=0.020,
                 cap_s=10.0) -> torch.Tensor:
    """Pareto(alpha) request sizes with scale ``x_min_s``, capped at
    ``cap_s`` (the paper's longest bucket bound)."""
    u = torch.rand(n, generator=g, device=g.device) * (1.0 - 1e-6) + 1e-6
    return torch.clamp(float(np.float32(x_min_s))
                       * u ** (-1.0 / float(np.float32(alpha))),
                       max=float(np.float32(cap_s)))


def lognormal_sizes(g: torch.Generator, n: int, median_s=0.1, sigma=0.8,
                    lo_s=0.010, hi_s=10.0) -> torch.Tensor:
    """Lognormal request sizes clipped to ``[lo_s, hi_s]`` (the demand
    skew used by the production stand-ins)."""
    z = torch.randn(n, generator=g, device=g.device)
    return torch.clamp(torch.exp(math.log(median_s) + float(sigma) * z),
                       float(np.float32(lo_s)), float(np.float32(hi_s)))


def poisson_counts(g: torch.Generator, rates: torch.Tensor) -> torch.Tensor:
    """Poisson arrival counts for a rate grid (int64): `torch.poisson` on
    the generator's device."""
    return torch.poisson(torch.clamp(rates, min=0.0),
                         generator=g).to(torch.int64)
