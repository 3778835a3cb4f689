"""b-model self-similar trace generator (Wang et al., ICDE 2002; paper [87]).

The b-model recursively splits a volume of work over a time range: at each
of ``k`` levels a segment's volume is split (b, 1-b) between its two halves
with the biased side chosen uniformly at random. ``bias=0.5`` yields a
uniform trace; ``bias=0.75`` is highly variable (the paper reports >20x
load differences between consecutive intervals at b=0.75).

Port of `repro.core.bmodel`. The reference draws its coin flips with
`jax.random`, whose bits cannot be reproduced here, so this cascade draws
from a numpy `Generator` seeded from ``seed`` and matches the reference
in distribution only (same float32 cascade arithmetic, same volume and
mean). Trace preparation is host-side setup, so it stays in numpy;
`bmodel_series_torch` is the same cascade on a `torch.Generator`, for
the workload library's batch synthesis on the card.
"""

from __future__ import annotations

import numpy as np
import torch


def bmodel_series(rng: np.random.Generator, bias: float, levels: int,
                  total_volume: float) -> np.ndarray:
    """Generate ``2**levels`` per-interval float32 volumes summing to
    total_volume."""
    vols = np.asarray([total_volume], dtype=np.float32)
    b = np.float32(bias)
    one = np.float32(1.0)
    for _ in range(levels):
        bits = rng.random(vols.shape[0]) < 0.5
        left = np.where(bits, b, one - b)
        vols = np.stack([vols * left, vols * (one - left)], axis=1).reshape(-1)
    return vols


def bmodel_series_torch(g: torch.Generator, bias: float, levels: int,
                        total_volume: float) -> torch.Tensor:
    """`bmodel_series` on the generator's device: ``2**levels`` float32
    volumes summing to total_volume, the coin flips drawn from ``g``."""
    vols = torch.full((1,), float(total_volume), dtype=torch.float32,
                      device=g.device)
    b = torch.tensor(bias, dtype=torch.float32, device=g.device)
    for _ in range(levels):
        bits = torch.rand(vols.shape[0], generator=g, device=g.device) < 0.5
        left = torch.where(bits, b, 1.0 - b)
        vols = torch.stack([vols * left, vols * (1.0 - left)],
                           dim=1).reshape(-1)
    return vols


def bmodel_rates(rng: np.random.Generator, bias: float, horizon_s: int,
                 mean_rate: float) -> np.ndarray:
    """Per-second arrival rates (req/s) over >= horizon_s seconds.

    Uses the smallest power-of-two cascade covering the horizon and
    truncates; total volume is scaled so the *mean* over the cascade equals
    ``mean_rate``.
    """
    levels = max(1, int(np.ceil(np.log2(max(horizon_s, 2)))))
    n = 2 ** levels
    return bmodel_series(rng, bias, levels, mean_rate * n)[:horizon_s]


def bmodel_rates_np(seed: int, bias: float, horizon_s: int,
                    mean_rate: float) -> np.ndarray:
    """`bmodel_rates` on a numpy generator seeded from ``seed``."""
    return bmodel_rates(np.random.default_rng(seed), bias, horizon_s,
                        mean_rate)
