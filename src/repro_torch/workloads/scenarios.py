"""Trace container, §5.1 synthetic traces, the Table 7 app stand-ins,
and scenario specs with their batched synthesis.

Port of `repro.workloads.scenarios`. The per-app request sizes, mean
demands and biases of the stand-ins come from
``np.random.default_rng(seed)`` exactly as in the reference, so they are
equal draw for draw; only the b-model rates differ (see
`repro_torch.core.bmodel`). On top sits the scenario vocabulary:

  * `ScenarioSpec` — a small frozen (hashable) dataclass naming one
    workload shape: generator kind + parameters + horizon + demand
    scale + the expected-statistics ranges `repro_torch.workloads.stats`
    validates against. `SweepCell` / `EventCell` accept a spec directly
    (``scenario=spec, seed=k``); `repro_torch.sim.plan.resolve_scenarios`
    turns such cells into explicit demand.
  * `realize(spec, seeds)` — synthesizes the seed batch (per-second
    rates, Poisson counts, per-seed request sizes) with the
    `repro_torch.workloads.generators` on one device, the card unless
    the caller asks for the CPU (`SYNTH_DISPATCHES` counts the calls
    that synthesized; the batch is cached per (spec, seeds, device)).
    Each seed draws from its own ``torch.Generator``, seeded from the
    crc32 of the spec's name and the seed, so a seed's draw does not
    depend on the batch it is realized in.
  * `scenario_traces(spec, seeds)` — the same batch as host-side `Trace`
    objects (`traces_from_batch` builds them from any realized batch),
    and `scenario_arrivals(spec, seed)` one seed's cached arrival-time
    stream.

The reference draws from `jax.random`, which cannot be reproduced in
torch: the two agree in distribution only, and the engines are held to
the reference on arrays the reference realized.
"""

from __future__ import annotations

import functools
import os
import zlib
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.bmodel import bmodel_rates_np
from repro_torch.device import resolve_device
from repro_torch.workloads import generators, ingest

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


# --------------------------------------------------------------- scenarios

KINDS = ("bmodel", "mmpp", "diurnal", "flash", "heavy_tail", "replay")

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@dataclass(frozen=True)
class ScenarioSpec:
    """One named workload shape, hashable so it can key sweep groups.

    ``params`` and ``expect`` are flat tuples (not dicts) to keep the
    spec hashable: ``params`` holds ``(key, value)`` generator arguments,
    ``expect`` holds ``(stat_name, lo, hi)`` ranges that
    `repro_torch.workloads.stats.validate` checks on every realized batch.
    ``failures`` (a frozen `repro_torch.ft.failures.FailureSpec`, or None)
    attaches a fault-injection profile: sweep cells that name this
    scenario inherit it unless they pin their own (`resolve_scenarios`).
    """

    name: str
    kind: str
    horizon_s: int = 1800
    request_size_s: float = 0.050
    mean_demand_workers: float = 100.0
    params: tuple = ()
    expect: tuple = ()
    failures: Any = None    # repro_torch.ft.failures.FailureSpec | None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown scenario kind {self.kind!r}")
        # fail-fast shape validation: a bad spec raises here, not inside
        # the synthesis
        if not self.horizon_s > 0:
            raise ValueError(
                f"ScenarioSpec.horizon_s must be > 0, got "
                f"{self.horizon_s!r}")
        if not (np.isfinite(self.request_size_s)
                and self.request_size_s > 0):
            raise ValueError(
                f"ScenarioSpec.request_size_s must be a positive finite "
                f"service time, got {self.request_size_s!r}")
        if not (np.isfinite(self.mean_demand_workers)
                and self.mean_demand_workers >= 0):
            raise ValueError(
                f"ScenarioSpec.mean_demand_workers must be >= 0 (negative "
                f"rate?), got {self.mean_demand_workers!r}")

    @property
    def p(self) -> dict:
        return dict(self.params)

    def with_(self, **fields) -> "ScenarioSpec":
        """Copy with dataclass fields replaced (e.g. a fast-mode horizon)."""
        return replace(self, **fields)


class ScenarioBatch(NamedTuple):
    """One realized seed batch (host numpy)."""

    rates: np.ndarray      # (S, T) float64 per-second expected rates
    counts: np.ndarray     # (S, T) int64 Poisson-sampled arrivals
    sizes: np.ndarray      # (S,) float64 per-seed request sizes


#: Number of batch syntheses (one per `realize` cache miss).
SYNTH_DISPATCHES = 0

# Independent streams of one seed, as the reference splits its key.
_STREAM_RATE, _STREAM_COUNT, _STREAM_SIZE, _STREAM_EXTRA = range(4)


def _generator(spec: ScenarioSpec, seed: int, stream: int,
               device: torch.device) -> torch.Generator:
    """The generator of one (spec, seed, stream): the spec's root (crc32
    of its name, not Python's hash) in the high 32 bits of the seed, the
    seed and the stream in the low 32."""
    root = zlib.crc32(spec.name.encode()) & 0x7FFFFFFF
    g = torch.Generator(device=device)
    g.manual_seed((root << 32) | ((int(seed) * 4 + stream) & 0xFFFFFFFF))
    return g


def _realize_one(spec: ScenarioSpec, seed: int, base, dev: torch.device):
    """(rates (T,) float32, counts (T,) int64, size) of one seed."""
    kind, p, H = spec.kind, spec.p, spec.horizon_s
    mean_rate = spec.mean_demand_workers / spec.request_size_s

    def gen(stream):
        return _generator(spec, seed, stream, dev)

    size = torch.tensor(spec.request_size_s, dtype=torch.float32, device=dev)
    if kind == "bmodel":
        rates = generators.bmodel_rates(gen(_STREAM_RATE), p.get("bias", 0.6),
                                        H, mean_rate)
    elif kind == "mmpp":
        rates = generators.mmpp_rates(
            gen(_STREAM_RATE), H, mean_rate,
            burst_ratio=p.get("burst_ratio", 8.0),
            p_enter=p.get("p_enter", 0.02), p_exit=p.get("p_exit", 0.2))
    elif kind == "diurnal":
        rates = generators.diurnal_rates(
            gen(_STREAM_RATE), H, mean_rate,
            period_s=H * p.get("period_frac", 1.0),
            amp1=p.get("amp1", 0.6), amp2=p.get("amp2", 0.25),
            phase=p.get("phase", 0.0), noise=p.get("noise", 0.08))
    elif kind == "flash":
        base_rates = generators.diurnal_rates(
            gen(_STREAM_RATE), H, mean_rate, period_s=H, amp1=0.0, amp2=0.0,
            noise=p.get("noise", 0.05))
        overlay = generators.flash_crowd_overlay(
            gen(_STREAM_EXTRA), H, amp=p.get("amp", 8.0),
            ramp_s=p.get("ramp_s", 30.0), decay_s=p.get("decay_s", 300.0),
            window=(p.get("window_lo", 0.2), p.get("window_hi", 0.7)))
        rates = base_rates * overlay
    elif kind == "heavy_tail":
        # Heavy-tail request sizes; rates scale inversely so the mean
        # *worker demand* stays at spec.mean_demand_workers per seed.
        size = generators.pareto_sizes(
            gen(_STREAM_SIZE), 1, alpha=p.get("alpha", 1.6),
            x_min_s=p.get("x_min_s", 0.020), cap_s=p.get("cap_s", 2.0))[0]
        rates = generators.bmodel_rates(
            gen(_STREAM_RATE), p.get("bias", 0.6), H,
            float(np.float32(spec.mean_demand_workers) / size.item()))
    elif kind == "replay":
        rates = base
    else:       # pragma: no cover — guarded by ScenarioSpec.__post_init__
        raise ValueError(f"unknown scenario kind {kind!r}")
    counts = generators.poisson_counts(gen(_STREAM_COUNT), rates)
    return rates, counts, size


@functools.lru_cache(maxsize=64)
def _replay_base(spec: ScenarioSpec) -> tuple:
    """Replayed per-second base rates for a ``replay`` spec (tiled to the
    horizon and rescaled to the spec's mean demand), as a hashable tuple."""
    path = spec.p.get("path", "sample_trace.csv")
    if not os.path.isabs(path):
        path = os.path.join(_DATA_DIR, path)
    rates = ingest.replay_rates(
        ingest.read_series(path), spec.horizon_s,
        mean_rate=spec.mean_demand_workers / spec.request_size_s)
    return tuple(float(r) for r in rates)


@functools.lru_cache(maxsize=64)
def _realize(spec: ScenarioSpec, seeds: tuple, device: str) -> ScenarioBatch:
    global SYNTH_DISPATCHES
    dev = torch.device(device)
    base = (torch.tensor(_replay_base(spec), dtype=torch.float32, device=dev)
            if spec.kind == "replay" else None)
    parts = [_realize_one(spec, s, base, dev) for s in seeds]
    rates = torch.stack([r for r, _, _ in parts])
    counts = torch.stack([c for _, c, _ in parts])
    sizes = torch.stack([z for _, _, z in parts])
    SYNTH_DISPATCHES += 1
    return ScenarioBatch(rates.cpu().numpy().astype(np.float64),
                         counts.cpu().numpy().astype(np.int64),
                         sizes.cpu().numpy().astype(np.float64))


def realize(spec: ScenarioSpec, seeds: tuple,
            device: str | torch.device | None = None) -> ScenarioBatch:
    """Synthesize the whole seed batch for one spec on ``device`` (None:
    the card). ``seeds`` must be a tuple; the realized batch is cached per
    (spec, seeds, device), so validators and the sweep resolver share one
    synthesis."""
    return _realize(spec, tuple(int(s) for s in seeds),
                    str(resolve_device(device)))


def traces_from_batch(spec: ScenarioSpec, seeds: Sequence[int],
                      batch: ScenarioBatch) -> list[Trace]:
    """A realized batch as host-side `Trace` objects, one per seed, counts
    attached (so both simulator families see identical demand)."""
    traces = []
    for i, seed in enumerate(seeds):
        tr = Trace(f"{spec.name}-s{seed}", float(batch.sizes[i]),
                   batch.rates[i],
                   meta={"scenario": spec.name, "seed": int(seed)})
        tr.counts = batch.counts[i]
        traces.append(tr)
    return traces


def scenario_traces(spec: ScenarioSpec, seeds: Sequence[int],
                    device: str | torch.device | None = None) -> list[Trace]:
    """The realized batch (`realize` on ``device``) as `Trace` objects."""
    seeds = tuple(int(s) for s in seeds)
    return traces_from_batch(spec, seeds, realize(spec, seeds, device))


# Per-(spec, seed, device) event arrival streams: the stream is a pure
# function of them (each seed draws from its own generator, and
# `Trace.arrival_times` is deterministic in its seed), so repeated planner
# resolutions of the same event cells share one computed stream.
_ARRIVALS_CACHE: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
# Byte-capped, not entry-capped: paper-scale streams run ~100 MB per
# (spec, seed), so an entry cap could silently pin gigabytes.
_ARRIVALS_CACHE_MAX_BYTES = 256 * 1024 * 1024
_arrivals_cache_bytes = 0


def scenario_arrivals(spec: ScenarioSpec, seed: int,
                      _trace: Trace | None = None,
                      device: str | torch.device | None = None) -> np.ndarray:
    """Cached arrival-time stream for one (spec, seed) realized on
    ``device``.

    ``_trace`` lets a caller that already realized the seed batch (the
    sweep planner's `resolve_scenarios`) donate its `Trace` on a cache
    miss; without it a miss realizes the single-seed batch itself."""
    global _arrivals_cache_bytes
    key = (spec, int(seed), str(resolve_device(device)))
    arr = _ARRIVALS_CACHE.get(key)
    if arr is None:
        tr = _trace if _trace is not None \
            else scenario_traces(spec, (int(seed),), device)[0]
        arr = tr.arrival_times(int(seed))
        # handed out by reference (resolved cells hold the cached array
        # itself); freeze it so an in-place edit can't poison the cache
        arr.setflags(write=False)
        _ARRIVALS_CACHE[key] = arr
        _arrivals_cache_bytes += arr.nbytes
        while (_arrivals_cache_bytes > _ARRIVALS_CACHE_MAX_BYTES
               and len(_ARRIVALS_CACHE) > 1):
            _, old = _ARRIVALS_CACHE.popitem(last=False)
            _arrivals_cache_bytes -= old.nbytes
    else:
        _ARRIVALS_CACHE.move_to_end(key)
    return arr


def clear_caches() -> None:
    """Drop every realized batch and arrival stream (a caller that swaps
    the realization, as the tests do, starts from a clean state)."""
    global _arrivals_cache_bytes
    _realize.cache_clear()
    _ARRIVALS_CACHE.clear()
    _arrivals_cache_bytes = 0
