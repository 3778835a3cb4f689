"""`repro_torch.workloads` — the workload library (port of
`repro.workloads`).

The `Trace` container, the §5.1 synthetic traces and the Table 7
production stand-ins, scenario specs and their batched synthesis on a
`torch.Generator` (`scenarios`, `generators`), the named scenario library
(`registry`), the shape validators (`stats`), CSV/JSONL replay
(`ingest`) and tenant populations for the fleet layer (`tenants`). The
sweep engines accept `ScenarioSpec`s directly on their cells
(`repro_torch.sim.plan.resolve_scenarios`).
"""

from repro_torch.workloads import generators, ingest, registry, stats
from repro_torch.workloads.scenarios import (ScenarioBatch, ScenarioSpec,
                                             Trace, realize, scenario_traces)
from repro_torch.workloads.tenants import tenant_population, zipf_weights

__all__ = [
    "ScenarioBatch", "ScenarioSpec", "Trace", "generators", "ingest",
    "realize", "registry", "scenario_traces", "stats", "tenant_population",
    "zipf_weights",
]
