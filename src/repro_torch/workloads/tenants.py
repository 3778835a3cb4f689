"""Tenant population builders for the multi-tenant fleet layer.

Transliterated from `repro.workloads.tenants`.
`repro_torch.fleet.FleetCell` wants a tuple of `TenantSpec`s; this module
builds realistic *populations* of them from the named scenario library:
Zipf-weighted fairness shares (a few heavy tenants, a long light tail —
the canonical multi-tenant skew), a cycling scenario mix, a cycling SLO
mix, and per-tenant seeds so every tenant draws distinct demand.

Scale discipline: tenant demand is quantized onto a FEW distinct
`ScenarioSpec` variants (``scenarios`` x ``demand_levels``), so
resolving even a 1024-tenant population costs one batched synthesis
per variant (`repro_torch.fleet.resolve_fleet_cell` groups tenant
seeds per spec), not one per tenant. Per-tenant demand defaults are
deliberately small — N tenants share ONE fleet, so the population's
aggregate demand is what must fit the fleet, and merged-stream length
is what the batched engine walks.
"""

from __future__ import annotations

import numpy as np

from repro_torch.workloads import registry

__all__ = ["tenant_population", "zipf_weights"]


def zipf_weights(n: int, a: float = 1.0) -> np.ndarray:
    """Zipf(a) fairness weights for n tenants, normalized to mean 1.0
    (so admission-policy knobs keep their per-tenant meaning): weight_i
    proportional to 1/(i+1)^a. ``a=0`` gives uniform weights."""
    if n <= 0:
        raise ValueError(f"need n > 0 tenants, got {n}")
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), a)
    return w * (n / w.sum())


def tenant_population(n: int,
                      scenarios=("steady", "bursty_short", "diurnal"),
                      slo_mix=("standard", "tight", "relaxed"),
                      zipf_a: float = 1.0,
                      demand_levels=(1.0, 0.5),
                      horizon_s: float = 60.0,
                      mean_demand_workers: float = 0.05,
                      seed: int = 0) -> tuple:
    """Build an n-tenant population over the named scenario library.

    Tenant i gets: scenario variant ``(scenarios x demand_levels)[i %
    V]`` rescaled to ``horizon_s`` and ``mean_demand_workers * level``
    (a small per-tenant share of one shared fleet), SLO class
    ``slo_mix[i % len(slo_mix)]``, Zipf(``zipf_a``) fairness weight
    (heaviest first, mean 1.0), and seed ``seed + i`` so every tenant's
    arrivals are a distinct draw. Returns a tuple ready for
    ``FleetCell(tenants=...)``; distinct underlying `ScenarioSpec`s
    number ``len(scenarios) * len(demand_levels)`` regardless of n."""
    from repro_torch.fleet.specs import SLO_CLASSES, TenantSpec

    for s in slo_mix:
        if s not in SLO_CLASSES:
            raise ValueError(f"unknown SLO class {s!r} in slo_mix "
                             f"(known: {sorted(SLO_CLASSES)})")
    variants = [
        registry.get(name).with_(
            horizon_s=int(horizon_s),
            mean_demand_workers=float(mean_demand_workers * level))
        for name in scenarios for level in demand_levels]
    weights = zipf_weights(n, zipf_a)
    return tuple(
        TenantSpec(scenario=variants[i % len(variants)],
                   slo=slo_mix[i % len(slo_mix)],
                   weight=float(weights[i]),
                   seed=seed + i)
        for i in range(n))
