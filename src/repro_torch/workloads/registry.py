"""Named scenario library: the workload axis of the sweep grids.

Transliterated from `repro.workloads.registry`: the same names, params,
expected ranges and failure profiles. Each entry is a
`repro_torch.workloads.scenarios.ScenarioSpec` — generator
kind + parameters + demand scale + the expected-statistics ranges the
`repro_torch.workloads.stats` validators enforce on every realized
batch. `chip_smoke.py`'s scenario phase runs every registered scenario
against three schedulers; tests assert each scenario passes its own
validator, so the library stays quantitatively honest about what
workload shape each name produces.

Default horizons are fast-mode (1800 s); callers rescale with
``spec.with_(horizon_s=...)`` for full runs. Expected ranges were
calibrated over seeds 0..9 at both 1800 s and 7200 s horizons and hold
per-seed-batch (4+ seeds averaged); they are deliberately wide enough to
absorb seed-to-seed variance but tight enough to flag a generator whose
burstiness or peak structure drifts from the scenario's intent.

Conventions: ``bias_est`` is estimated at the generator's native
resolution (``stats_agg_s`` param, default 60 s); a *scenario* models a
single app's arrival process — the Table 7 multi-app production sets
remain in `repro_torch.workloads.scenarios.production_like_apps`.
"""

from __future__ import annotations

from repro_torch.ft.failures import FailureSpec
from repro_torch.workloads.scenarios import SOURCE_BIAS, ScenarioSpec

SCENARIOS: dict[str, ScenarioSpec] = {}


def register(spec: ScenarioSpec) -> ScenarioSpec:
    if spec.name in SCENARIOS:
        raise ValueError(f"scenario {spec.name!r} already registered")
    SCENARIOS[spec.name] = spec
    return spec


def get(name: str) -> ScenarioSpec:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; known: {', '.join(names())}") from None


def names() -> list[str]:
    return sorted(SCENARIOS)


# ----------------------------------------------------------------- library

register(ScenarioSpec(
    name="steady", kind="diurnal",
    params=(("amp1", 0.0), ("amp2", 0.0), ("noise", 0.05)),
    expect=(("bias_est", 0.49, 0.53), ("peak_to_mean", 1.0, 1.35),
            ("cv", 0.0, 0.12))))

register(ScenarioSpec(
    name="diurnal", kind="diurnal",
    params=(("period_frac", 1.0), ("amp1", 0.6), ("amp2", 0.25),
            ("noise", 0.08)),
    expect=(("peak_to_mean", 1.3, 2.6), ("autocorr_60", 0.8, 1.0),
            ("cv", 0.25, 0.75))))

register(ScenarioSpec(
    name="flash_crowd", kind="flash", mean_demand_workers=50.0,
    params=(("amp", 8.0), ("ramp_s", 30.0), ("decay_s", 300.0),
            ("noise", 0.05)),
    expect=(("peak_to_mean", 2.5, 8.5), ("autocorr_60", 0.5, 1.0))))

register(ScenarioSpec(
    name="bursty_short", kind="bmodel",
    params=(("bias", 0.72),),
    expect=(("bias_est", 0.62, 0.82), ("peak_to_mean", 2.5, 60.0))))

register(ScenarioSpec(
    name="heavy_tail_mix", kind="heavy_tail",
    params=(("bias", 0.6), ("alpha", 1.6), ("x_min_s", 0.020),
            ("cap_s", 2.0)),
    expect=(("bias_est", 0.53, 0.72), ("peak_to_mean", 1.5, 20.0))))

register(ScenarioSpec(
    name="azure_like", kind="bmodel",
    params=(("bias", SOURCE_BIAS["azure"]),),
    expect=(("bias_est", 0.60, 0.76), ("peak_to_mean", 2.0, 40.0))))

register(ScenarioSpec(
    name="alibaba_like", kind="bmodel",
    params=(("bias", SOURCE_BIAS["alibaba"]),),
    expect=(("bias_est", 0.52, 0.65), ("peak_to_mean", 1.2, 12.0))))

register(ScenarioSpec(
    name="csv_replay", kind="replay", mean_demand_workers=80.0,
    params=(("path", "sample_trace.csv"), ("stats_agg_s", 10)),
    expect=(("peak_to_mean", 1.5, 4.0), ("autocorr_60", 0.3, 1.0))))


# ------------------------------------------------------- chaos scenarios
#
# Fault-injection profiles for the resilience suite (the chaos phase of
# chip_smoke.py): each entry pairs a short-horizon workload
# shape with a `repro_torch.ft.failures.FailureSpec` at FULL intensity — the
# suite sweeps ``spec.failures.scaled(intensity)`` per cell, so the
# registered spec is the worst case, not the only case. Kept in a
# separate registry so `names()` (the scenario_suite contract — 8
# entries) is unchanged. Failure rates are STAND-INS chosen to exercise
# every recovery path within a 240 s horizon, not literature-derived.
# Expect ranges are calibrated at 240 s / ``stats_agg_s=10`` like the
# main library.

CHAOS_SCENARIOS: dict[str, ScenarioSpec] = {}


def register_chaos(spec: ScenarioSpec) -> ScenarioSpec:
    if spec.name in CHAOS_SCENARIOS or spec.name in SCENARIOS:
        raise ValueError(f"scenario {spec.name!r} already registered")
    if spec.failures is None:
        raise ValueError(f"chaos scenario {spec.name!r} needs a FailureSpec")
    CHAOS_SCENARIOS[spec.name] = spec
    return spec


def get_chaos(name: str) -> ScenarioSpec:
    try:
        return CHAOS_SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown chaos scenario {name!r}; "
                       f"known: {', '.join(chaos_names())}") from None


def chaos_names() -> list[str]:
    return sorted(CHAOS_SCENARIOS)


register_chaos(ScenarioSpec(
    name="flaky_fpga", kind="diurnal", horizon_s=240,
    request_size_s=1.0, mean_demand_workers=12.0,
    params=(("amp1", 0.0), ("amp2", 0.0), ("noise", 0.05),
            ("stats_agg_s", 10)),
    expect=(("peak_to_mean", 1.0, 1.5), ("cv", 0.0, 0.2)),
    failures=FailureSpec(spinup_fail_p=0.25, max_retries=2,
                         retry_backoff_s=2.0, seed=11)))

register_chaos(ScenarioSpec(
    name="crash_storm", kind="bmodel", horizon_s=240,
    request_size_s=1.0, mean_demand_workers=12.0,
    params=(("bias", 0.68), ("stats_agg_s", 10)),
    expect=(("peak_to_mean", 1.3, 12.0),),
    failures=FailureSpec(crash_p=0.08, max_failover=2, seed=23)))

register_chaos(ScenarioSpec(
    name="straggler_tail", kind="heavy_tail", horizon_s=240,
    request_size_s=1.0, mean_demand_workers=12.0,
    params=(("bias", 0.58), ("alpha", 1.6), ("x_min_s", 0.400),
            ("cap_s", 4.0), ("stats_agg_s", 10)),
    expect=(("peak_to_mean", 1.2, 15.0),),
    failures=FailureSpec(straggler_frac=0.25, straggler_factor=4.0,
                         seed=37)))

register_chaos(ScenarioSpec(
    name="region_evac", kind="diurnal", horizon_s=240,
    request_size_s=1.0, mean_demand_workers=12.0,
    params=(("period_frac", 1.0), ("amp1", 0.4), ("amp2", 0.1),
            ("noise", 0.05), ("stats_agg_s", 10)),
    expect=(("peak_to_mean", 1.1, 2.5),),
    failures=FailureSpec(evac_start_s=80.0, evac_end_s=160.0,
                         evac_frac=0.5, crash_p=0.02, seed=53)))
