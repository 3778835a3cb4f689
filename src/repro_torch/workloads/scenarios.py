"""Trace container, §5.1 synthetic traces and the Table 7 app stand-ins.

Port of the trace half of `repro.workloads.scenarios`. The per-app
request sizes, mean demands and biases come from
``np.random.default_rng(seed)`` exactly as in the reference, so they are
equal draw for draw; only the b-model rates differ (see
`repro_torch.core.bmodel`). The scenario vocabulary (`ScenarioSpec`,
`realize`, ...) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.bmodel import bmodel_rates_np

BUCKETS_S = {
    "short": (0.010, 0.100),
    "medium": (0.100, 1.0),
    "long": (1.0, 10.0),
}

# Table 7: number of heavy-demand applications per bucket.
TABLE7 = {
    "azure": {"short": 13, "medium": 101, "long": 241},
    "alibaba": {"short": 99, "medium": 31},
}

# Stand-in burstiness (b-model bias) for the production sources.
SOURCE_BIAS = {"azure": 0.68, "alibaba": 0.58}


@dataclass
class Trace:
    """One application's workload.

    rates_per_s[t] is the *expected* request arrival rate (req/s) in second
    t. ``counts`` optionally holds a Poisson sample of actual per-second
    arrival counts (used by the simulators so they see identical demand).
    """

    name: str
    request_size_s: float          # service time on a CPU worker
    rates_per_s: np.ndarray        # (T,) float
    deadline_s: float | None = None  # default: 10x request size (paper §5.1)
    counts: np.ndarray | None = None  # (T,) int sampled arrivals
    meta: dict = field(default_factory=dict)

    @property
    def horizon_s(self) -> int:
        return int(self.rates_per_s.shape[0])

    @property
    def deadline(self) -> float:
        return 10.0 * self.request_size_s if self.deadline_s is None else self.deadline_s

    def sample_counts(self, seed: int) -> np.ndarray:
        rng = np.random.default_rng(seed)
        self.counts = rng.poisson(np.maximum(self.rates_per_s, 0.0)).astype(np.int64)
        return self.counts

    def total_work_cpu_s(self) -> float:
        c = self.counts if self.counts is not None else self.rates_per_s
        return float(np.sum(c) * self.request_size_s)

    def arrival_times(self, seed: int) -> np.ndarray:
        """Event-level arrival timestamps: Poisson counts per second placed
        uniformly within the second."""
        counts = self.counts if self.counts is not None else self.sample_counts(seed)
        rng = np.random.default_rng(seed + 1)
        parts = [t + np.sort(rng.random(int(c))) for t, c in enumerate(counts) if c > 0]
        if not parts:
            return np.empty((0,), dtype=np.float64)
        return np.concatenate(parts)


def synthetic_trace(seed: int, bias: float = 0.6, horizon_s: int = 7200,
                    request_size_s: float = 0.050, mean_demand_workers: float = 100.0,
                    name: str | None = None) -> Trace:
    """§5.1 synthetic traces: request size from a bucket, b-model per-minute
    rates sized so ~``mean_demand_workers`` CPU workers are needed on
    average, Poisson interarrivals. Defaults: 2h, short sizes, b=0.6."""
    mean_rate = mean_demand_workers / request_size_s
    minutes = int(np.ceil(horizon_s / 60.0))
    per_min = bmodel_rates_np(seed, bias, minutes + 1, mean_rate)
    # Rates change linearly within each minute (paper §5.1).
    t = np.arange(horizon_s, dtype=np.float64)
    idx = np.minimum((t // 60).astype(int), minutes - 1)
    frac = (t % 60) / 60.0
    rates = per_min[idx] * (1 - frac) + per_min[np.minimum(idx + 1, minutes)] * frac
    tr = Trace(name or f"synthetic-b{bias}-s{seed}", request_size_s,
               rates.astype(np.float64), meta={"bias": bias, "seed": seed})
    tr.sample_counts(seed + 17)
    return tr


def _bucket_sizes(rng: np.random.Generator, bucket: str, n: int) -> np.ndarray:
    lo, hi = BUCKETS_S[bucket]
    return np.exp(rng.uniform(np.log(lo), np.log(hi), size=n))


def production_like_apps(source: str, bucket: str, seed: int = 0,
                         horizon_s: int = 7200, n_apps: int | None = None,
                         ) -> list[Trace]:
    """Stand-in for the Azure/Alibaba heavy-demand app subsets (Table 7)."""
    if bucket not in TABLE7[source]:
        raise ValueError(f"{source} trace has no {bucket} bucket (Table 7)")
    n = TABLE7[source][bucket] if n_apps is None else n_apps
    rng = np.random.default_rng(seed)
    sizes = _bucket_sizes(rng, bucket, n)
    # Skewed heavy demand: lognormal mean worker demand, median ~20 workers.
    demands = np.minimum(np.exp(rng.normal(np.log(20.0), 0.8, size=n)), 400.0)
    bias = SOURCE_BIAS[source]
    traces = []
    for i in range(n):
        app_bias = float(np.clip(rng.normal(bias, 0.03), 0.5, 0.75))
        traces.append(synthetic_trace(
            seed=seed * 100_003 + i, bias=app_bias, horizon_s=horizon_s,
            request_size_s=float(sizes[i]), mean_demand_workers=float(demands[i]),
            name=f"{source}-{bucket}-{i}"))
        traces[-1].meta.update(source=source, bucket=bucket)
    return traces


def azure_like_apps(bucket: str, **kw) -> list[Trace]:
    return production_like_apps("azure", bucket, **kw)


def alibaba_like_apps(bucket: str, **kw) -> list[Trace]:
    return production_like_apps("alibaba", bucket, **kw)
