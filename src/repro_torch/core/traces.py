"""Workload traces: compatibility façade over `repro_torch.workloads`,
mirroring `repro.core.traces`."""

from __future__ import annotations

from repro_torch.workloads.scenarios import (BUCKETS_S, SOURCE_BIAS,  # noqa: F401
                                             TABLE7, Trace,
                                             alibaba_like_apps,
                                             azure_like_apps,
                                             production_like_apps,
                                             synthetic_trace)

__all__ = [
    "BUCKETS_S", "SOURCE_BIAS", "TABLE7", "Trace", "alibaba_like_apps",
    "azure_like_apps", "production_like_apps", "synthetic_trace",
]
