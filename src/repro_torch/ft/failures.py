"""Fault model of the discrete-event simulators, and host-level failure
drills (port of `repro.ft.failures`).

`FailureSpec` is threaded through both DES engines
(`repro_torch.sim.events` is the exact oracle, `repro_torch.sim.
events_batched` its batched twin, `kernels/arrival` its CUDA kernel). All
failure draws come from `failure_u01`, a counter-based uint32 hash keyed
on ``(seed, wid, counter, purpose)``: stateless, so the serial heap loop
and the batched engine consume identical randomness without tracking a
stream position.

The hash has three forms that agree bit for bit: numpy (uint32
wrap-around, as in the reference), torch (``xp=torch``: PyTorch has
little uint32 arithmetic, so values are int64 in [0, 2^32) and every
product is split into two 16-bit halves and masked with 0xFFFFFFFF, so
nothing overflows int64), and the kernel's ``uint32_t`` arithmetic. Each
converts the hash to float32 with round-to-nearest and scales it by 2^-32
exactly.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

# draw purposes: the fourth hash key, so one (seed, wid) pair yields
# independent streams per decision kind
DRAW_SPINUP = 1    # counter = attempt index 0..max_retries
DRAW_CRASH = 2     # counter = per-worker assignment index
DRAW_STRAGGLE = 3  # counter = 0 (drawn once, at spin-up)
DRAW_EVAC = 4      # counter = 0 (drawn once, membership in the evacuated set)

_GOLD = 0x9E3779B9
_MIX1 = 0x7FEB352D
_MIX2 = 0x846CA68B
_M32 = 0xFFFFFFFF


def _mul32_torch(x: torch.Tensor, k: int) -> torch.Tensor:
    """(x * k) mod 2^32 for int64 x in [0, 2^32): the product is taken in
    16-bit halves of k so no intermediate leaves int64's range."""
    lo = x * (k & 0xFFFF)
    hi = ((x * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash_torch(seed, wid, counter, purpose) -> torch.Tensor:
    dev = next((a.device for a in (seed, wid, counter, purpose)
                if isinstance(a, torch.Tensor)), None)

    def mix(x):
        x = x ^ (x >> 16)
        x = _mul32_torch(x, _MIX1)
        x = x ^ (x >> 15)
        x = _mul32_torch(x, _MIX2)
        return x ^ (x >> 16)

    def keyed(k):
        # k * GOLD mod 2^32; Python ints are folded on the host
        if isinstance(k, torch.Tensor):
            return _mul32_torch(k.to(torch.int64) & _M32, _GOLD)
        return (int(k) & _M32) * _GOLD & _M32

    h = torch.as_tensor(seed, device=dev).to(torch.int64) & _M32
    for k in (wid, counter, purpose):
        h = mix(h ^ keyed(k))
    return h


def failure_hash(seed, wid, counter, purpose, xp=np):
    """Counter-based uint32 hash (splitmix-style finalizer chain).

    ``xp`` is numpy for the serial oracle (uint32 result) and torch for
    the batched engine (int64 result in [0, 2^32)); any argument may be
    an array or tensor (results broadcast)."""
    if xp is torch:
        return _hash_torch(seed, wid, counter, purpose)
    u32 = np.uint32

    def mix(x):
        x = x ^ (x >> u32(16))
        x = x * u32(_MIX1)
        x = x ^ (x >> u32(15))
        x = x * u32(_MIX2)
        return x ^ (x >> u32(16))

    # uint32 wraparound is the point of the finalizer; silence numpy's
    # 0-d overflow warning
    with np.errstate(over="ignore"):
        h = np.asarray(seed).astype(u32)
        for k in (wid, counter, purpose):
            h = mix(h ^ (np.asarray(k).astype(u32) * u32(_GOLD)))
        return h


def failure_u01(seed, wid, counter, purpose, xp=np):
    """Uniform float32 in [0, 1] from the counter-based hash; compare
    against ``float32(p)`` on every engine for identical decisions."""
    h = failure_hash(seed, wid, counter, purpose, xp=xp)
    if xp is torch:
        return h.to(torch.float32) * 2.0 ** -32
    return h.astype(np.float32) * np.float32(2.0 ** -32)


class FailStatic(NamedTuple):
    """Static part of a `FailureSpec`: selects the engine's code path
    (and the kernel's template instance). ``enabled=False`` runs the
    pristine pre-failure path; retry/failover bounds are loop counts."""

    enabled: bool
    max_retries: int
    max_failover: int


FSTAT_OFF = FailStatic(False, 0, 0)


@dataclass(frozen=True)
class FailureSpec:
    """Fault model for one simulated cell (a static sweep axis on
    `repro_torch.sim.sweep.SweepCell` / `repro_torch.sim.events_batched.
    EventCell`).

    Per-cell knobs: ``spinup_fail_p`` per-attempt spin-up failure
    probability, ``retry_backoff_s`` wait between attempts, ``crash_p``
    per-assignment mid-service crash probability,
    ``straggler_frac``/``straggler_factor`` fraction of workers serving
    ``factor``x slower (drawn once per worker at spin-up), and an optional
    region-evacuation window ``[evac_start_s, evac_end_s)`` during which an
    ``evac_frac`` hash-drawn subset of workers is masked out of dispatch
    and the allocator's live count.

    Static knobs: ``max_retries`` bounds spin-up attempts (an allocation
    whose first ``max_retries + 1`` draws all fail is *stillborn*: its
    energy and cost are wasted and it never joins the fleet),
    ``max_failover`` bounds re-dispatch rounds after a mid-service crash
    (the request re-enters dispatch with its *original* deadline; when the
    rounds are exhausted it is dropped and counted as a deadline miss
    attributable to failures)."""

    spinup_fail_p: float = 0.0
    retry_backoff_s: float = 2.0
    max_retries: int = 2
    crash_p: float = 0.0
    max_failover: int = 2
    straggler_frac: float = 0.0
    straggler_factor: float = 4.0
    evac_start_s: float = 0.0
    evac_end_s: float = 0.0
    evac_frac: float = 0.0
    seed: int = 0

    @property
    def enabled(self) -> bool:
        return (self.spinup_fail_p > 0.0 or self.crash_p > 0.0
                or self.straggler_frac > 0.0
                or (self.evac_frac > 0.0
                    and self.evac_end_s > self.evac_start_s))

    def normalized(self) -> "FailureSpec | None":
        """None when every failure mode is off: all-zero specs must be
        indistinguishable from ``failures=None``."""
        return self if self.enabled else None

    def static_key(self) -> FailStatic:
        if not self.enabled:
            return FSTAT_OFF
        return FailStatic(True, int(self.max_retries), int(self.max_failover))

    def floats(self) -> tuple:
        """The 8 per-cell float parameters, in `EventScalars` order."""
        return (self.spinup_fail_p, self.retry_backoff_s, self.crash_p,
                self.straggler_frac, self.straggler_factor,
                self.evac_start_s, self.evac_end_s, self.evac_frac)

    def scaled(self, intensity: float) -> "FailureSpec":
        """Scale the probabilistic rates by ``intensity`` (clamped to 1);
        deterministic shape knobs (backoff, factor, window) are fixed.
        ``intensity=0`` normalizes to the disabled axis."""
        def s(p):
            return min(float(p) * intensity, 1.0)
        return replace(self, spinup_fail_p=s(self.spinup_fail_p),
                       crash_p=s(self.crash_p),
                       straggler_frac=s(self.straggler_frac),
                       evac_frac=s(self.evac_frac))

    def degrade_fleet(self, fleet):
        """Expected-value fluid degradation for the *rate* simulator (no
        per-worker identity, so no per-worker draws). Applied host-side
        by `repro_torch.sim.plan.plan_sweep` to failure-bearing
        SweepCells:

          * spin-up time grows by the expected number of failed attempts
            (truncated geometric, ignoring the stillborn tail), which also
            inflates spin-up energy via ``spin_up_energy_j``;
          * FPGA speedup shrinks by the mean straggler multiplier;
          * busy power inflates by ``1 + 1.5 * crash_p`` (a crash wastes
            on average half a service plus a full re-serve).

        An approximation: the DES engines are the exact path. Evacuation
        windows are not representable in the fluid model and are ignored."""
        if not self.enabled:
            return fleet
        q = min(float(self.spinup_fail_p), 0.95)
        extra = sum(q ** k for k in range(1, int(self.max_retries) + 1))
        crash_infl = 1.0 + 1.5 * float(self.crash_p)
        mean_slow = ((1.0 - self.straggler_frac)
                     + self.straggler_frac * self.straggler_factor)

        def degrade(spec):
            return spec.replace(
                spin_up_s=spec.spin_up_s
                + extra * (spec.spin_up_s + self.retry_backoff_s),
                busy_w=spec.busy_w * crash_infl)

        fpga = degrade(fleet.fpga).replace(
            speedup=fleet.fpga.speedup / mean_slow)
        return fleet.replace(fpga=fpga, cpu=degrade(fleet.cpu))


def fail_static(failures: "FailureSpec | None") -> FailStatic:
    """Static key for an optional spec (None -> disabled)."""
    return FSTAT_OFF if failures is None else failures.static_key()


class HeartbeatMonitor:
    """Last heartbeat per host; a host is dead once ``timeout_s`` has
    passed since its last beat (strictly)."""

    def __init__(self, hosts, timeout_s: float = 10.0):
        self.timeout = timeout_s
        self.last = {h: 0.0 for h in hosts}

    def beat(self, host, now: float) -> None:
        if host in self.last:
            self.last[host] = now

    def dead(self, now: float) -> list:
        return [h for h, t in self.last.items() if now - t > self.timeout]

    def evict(self, host) -> None:
        self.last.pop(host, None)

    @property
    def alive(self) -> list:
        return sorted(self.last)


@dataclass
class FailureEvent:
    step: int
    host: int
    kind: str            # 'crash' | 'straggle'
    factor: float = 1.0  # slowdown factor for stragglers


class FailureInjector:
    """Deterministic failure schedule for tests and chaos drills."""

    def __init__(self, n_hosts: int, seed: int = 0, crash_rate: float = 0.0,
                 straggle_rate: float = 0.0, horizon_steps: int = 1000):
        rng = np.random.default_rng(seed)
        self.events: list[FailureEvent] = []
        for step in range(horizon_steps):
            if rng.random() < crash_rate:
                self.events.append(FailureEvent(
                    step, int(rng.integers(n_hosts)), "crash"))
            if rng.random() < straggle_rate:
                self.events.append(FailureEvent(
                    step, int(rng.integers(n_hosts)), "straggle",
                    factor=float(rng.uniform(2, 10))))
        self._by_step: dict[int, list[FailureEvent]] = {}
        for e in self.events:
            self._by_step.setdefault(e.step, []).append(e)

    def at(self, step: int) -> list[FailureEvent]:
        return self._by_step.get(step, [])
