"""Real-trace ingestion: CSV / JSONL replay into the workloads layer.

Transliterated from `repro.workloads.ingest` (csv/json/numpy only).

The paper evaluates on Azure Functions and Alibaba microservice traces
that are not redistributable in this offline container; this module is
the drop-in point for when real production traces ARE available: parse a
per-second (or timestamped) rate series from a CSV or JSONL file,
resample it to the simulator's 1-second grid, and replay it — tiled to
any horizon and optionally rescaled to a target mean rate — as a
`repro_torch.workloads.scenarios.Trace` or as the base series of a ``replay``
`ScenarioSpec` (see `repro_torch.workloads.registry`'s ``csv_replay``).

Accepted formats (no third-party parsers — csv/json stdlib only):

  * CSV with a header: any column named ``rate`` (configurable); an
    optional ``t`` column holds timestamps in seconds (non-uniform ok —
    linearly resampled to the 1 s grid).
  * Headerless CSV: one value per row (rates), or ``t,rate`` rows.
  * JSONL: one object per line, same ``t``/``rate`` keys.

A tiny synthetic sample ships at ``src/repro_torch/workloads/data/
sample_trace.csv`` (a byte-identical copy of the reference's) so the
replay path stays exercised by the tests and the scenario suite.
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np


def _parse_csv(path: str, column: str) -> tuple[np.ndarray | None, np.ndarray]:
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r and any(c.strip() for c in r)]
    if not rows:
        raise ValueError(f"{path}: empty trace file")
    header = rows[0]
    has_header = not all(_is_float(c) for c in header)
    if has_header:
        names = [c.strip().lower() for c in header]
        if column not in names:
            raise ValueError(f"{path}: no {column!r} column in {names}")
        vi = names.index(column)
        ti = names.index("t") if "t" in names else None
        body = rows[1:]
    else:
        vi = len(rows[0]) - 1
        ti = 0 if len(rows[0]) > 1 else None
        body = rows
    vals = np.array([float(r[vi]) for r in body], np.float64)
    ts = (np.array([float(r[ti]) for r in body], np.float64)
          if ti is not None else None)
    return ts, vals


def _parse_jsonl(path: str, column: str) -> tuple[np.ndarray | None, np.ndarray]:
    ts, vals = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            vals.append(float(obj[column]))
            ts.append(float(obj["t"]) if "t" in obj else None)
    if not vals:
        raise ValueError(f"{path}: empty trace file")
    if any(t is None for t in ts):
        return None, np.asarray(vals, np.float64)
    return np.asarray(ts, np.float64), np.asarray(vals, np.float64)


def _is_float(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def read_series(path: str, column: str = "rate") -> np.ndarray:
    """Per-second rate series from a CSV/JSONL file (by extension).

    Timestamped rows are linearly resampled onto the integer-second grid
    ``[0, max(t)]``; untimestamped rows are taken as already per-second."""
    ext = os.path.splitext(path)[1].lower()
    ts, vals = (_parse_jsonl(path, column) if ext in (".jsonl", ".ndjson")
                else _parse_csv(path, column))
    if ts is None:
        return np.maximum(vals, 0.0)
    order = np.argsort(ts)
    ts, vals = ts[order], vals[order]
    grid = np.arange(0.0, ts[-1] + 1.0)
    return np.maximum(np.interp(grid, ts, vals), 0.0)


def replay_rates(series: np.ndarray, horizon_s: int,
                 mean_rate: float | None = None) -> np.ndarray:
    """Tile/truncate a per-second series to ``horizon_s`` seconds; if
    ``mean_rate`` is given, rescale so the replayed mean matches it."""
    series = np.asarray(series, np.float64)
    if series.size == 0:
        raise ValueError("empty replay series")
    reps = int(np.ceil(horizon_s / series.size))
    out = np.tile(series, reps)[:horizon_s]
    if mean_rate is not None:
        m = out.mean()
        if m <= 0:
            raise ValueError("replay series has non-positive mean")
        out = out * (mean_rate / m)
    return out


def replay_trace(path: str, request_size_s: float, horizon_s: int | None = None,
                 mean_demand_workers: float | None = None, seed: int = 0,
                 column: str = "rate", name: str | None = None):
    """One `Trace` replayed from a file (counts Poisson-sampled at ``seed``)."""
    from repro_torch.workloads.scenarios import Trace
    series = read_series(path, column)
    horizon = int(horizon_s if horizon_s is not None else series.size)
    mean_rate = (None if mean_demand_workers is None
                 else mean_demand_workers / request_size_s)
    rates = replay_rates(series, horizon, mean_rate)
    tr = Trace(name or f"replay-{os.path.basename(path)}", request_size_s,
               rates, meta={"source": path})
    tr.sample_counts(seed)
    return tr
