"""Workload statistics + validators: quantitatively flag every stand-in.

Transliterated from `repro.workloads.stats` (numpy only). The port's
generators cannot reproduce the reference's `jax.random` streams, so
these validators are how they are checked: by distribution, against the
registry's own ranges.

The paper's claims hinge on workload *shape* (burstiness above all — the
reported Spork advantage shrinks on the less-bursty Alibaba trace), so
every synthetic scenario in `repro_torch.workloads.registry` declares expected
ranges for the statistics below, and `validate` checks each realized
batch against them. A scenario whose generator drifts (or whose numbers
were mis-transcribed from the paper) fails its own validator in the
scenario suite and in the tests, instead of silently
producing results with the wrong shape.

Statistics:

  * ``bias_estimate`` — the b-model bias b via the standard pairwise
    aggregation estimator (Wang et al., ICDE 2002): at each dyadic
    aggregation level, the mean fraction of each adjacent pair's volume
    taken by the larger half estimates b (0.5 = uniform, 0.75 = highly
    bursty). ``agg_s`` pre-aggregates to the generator's native
    resolution (60 s for the per-minute b-model traces) so linear
    interpolation smoothing doesn't dilute the estimate.
  * ``peak_to_mean`` — max/mean of the series.
  * ``autocorr`` — lag-k autocorrelation (short-range self-similarity /
    smoothness; ~0 for white noise, ~1 for slow shapes).
  * ``cv`` — coefficient of variation.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _aggregate(x: np.ndarray, agg_s: int) -> np.ndarray:
    if agg_s <= 1:
        return x
    k = x.size // agg_s
    return x[:k * agg_s].reshape(k, agg_s).sum(1)


def bias_estimate(series: np.ndarray, agg_s: int = 1) -> float:
    """Pairwise-aggregation estimate of the b-model bias.

    Repeatedly merges adjacent pairs; at each level the mean of
    ``max(pair) / sum(pair)`` over nonempty pairs estimates b (exact in
    expectation for a b-model cascade at every level). Returns 0.5 for
    constant series."""
    x = _aggregate(np.asarray(series, np.float64), agg_s)
    if x.size < 2:
        return 0.5
    k = int(np.floor(np.log2(x.size)))
    x = x[:2 ** k]
    ests = []
    while x.size >= 2:
        pairs = x.reshape(-1, 2)
        s = pairs.sum(1)
        m = pairs.max(1)
        mask = s > 0
        if mask.any():
            ests.append(float(np.mean(m[mask] / s[mask])))
        x = s
    return float(np.mean(ests)) if ests else 0.5


def peak_to_mean(series: np.ndarray) -> float:
    x = np.asarray(series, np.float64)
    m = x.mean()
    return float(x.max() / m) if m > 0 else float("inf")


def autocorr(series: np.ndarray, lag: int = 1) -> float:
    x = np.asarray(series, np.float64)
    if x.size <= lag + 1:
        return 0.0
    a, b = x[:-lag], x[lag:]
    sa, sb = a.std(), b.std()
    if sa == 0 or sb == 0:
        return 1.0 if np.allclose(a, b) else 0.0
    return float(np.mean((a - a.mean()) * (b - b.mean())) / (sa * sb))


def cv(series: np.ndarray) -> float:
    x = np.asarray(series, np.float64)
    m = x.mean()
    return float(x.std() / m) if m > 0 else 0.0


def trace_stats(rates: np.ndarray, agg_s: int = 60) -> dict:
    """The validator statistics for one per-second rate series."""
    return {
        "bias_est": bias_estimate(rates, agg_s=agg_s),
        "peak_to_mean": peak_to_mean(rates),
        "autocorr_1": autocorr(rates, 1),
        "autocorr_60": autocorr(rates, 60),
        "cv": cv(rates),
    }


def batch_stats(rates_batch: np.ndarray, agg_s: int = 60) -> dict:
    """Seed-batch means of `trace_stats` (rows = seeds)."""
    per_seed = [trace_stats(r, agg_s=agg_s) for r in np.atleast_2d(rates_batch)]
    return {k: float(np.mean([d[k] for d in per_seed])) for k in per_seed[0]}


def validate(spec, rates_batch: np.ndarray,
             agg_s: int | None = None) -> tuple[bool, dict, list[str]]:
    """Check a realized batch against ``spec.expect`` ranges.

    Returns ``(ok, stats, failures)``: seed-averaged statistics plus one
    message per violated ``(stat, lo, hi)`` expectation. A spec with no
    expectations vacuously passes (but still gets its stats measured)."""
    if agg_s is None:
        agg_s = int(dict(spec.params).get("stats_agg_s", 60))
    stats = batch_stats(rates_batch, agg_s=agg_s)
    failures = []
    for stat, lo, hi in spec.expect:
        val = stats.get(stat)
        if val is None:
            failures.append(f"{spec.name}: unknown statistic {stat!r}")
        elif not (lo <= val <= hi):
            failures.append(
                f"{spec.name}: {stat}={val:.4f} outside [{lo}, {hi}]")
    return (not failures), stats, failures
