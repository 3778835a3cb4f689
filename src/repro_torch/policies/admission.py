"""Admission policies: router-level per-tenant shedding (third registry).

Transliterated from `repro.policies.admission`; `admission_decide` takes
``xp=numpy`` (the serial oracle) or ``xp=torch`` (the batched engine, on
the CPU or the card) and rounds the same in both. The multi-tenant fleet
layer (`repro_torch.fleet`) shares ONE worker fleet
across N tenants; when the fleet saturates, a router-level admission
policy decides per arrival whether the request enters dispatch or is
shed (counted in `repro_torch.core.metrics.TenantTotals.shed` and the
fleet ``breakdown['shed_requests']``). Like the dispatch family
(`repro_torch.policies.des`), one frozen policy object drives both
engines:

  * the serial oracle (`repro_torch.fleet.oracle.FleetSim`) and the
    batched engine (`repro_torch.fleet.engine`) both evaluate the pure
    float32 function `admission_decide` — same operations, same order,
    same dtype, each operation rounded on its own (no fused form that
    could contract to an FMA) — so admit/shed decisions are
    bit-identical across engines and devices;
  * the policy's integer ``code`` is a per-cell tensor in the batched
    engine, so every registered admission policy shares one dispatch
    group (the fleet dispatch-count guards rely on it);
  * `tenant_params(weights)` maps tenant weights to the per-tenant
    float32 knob arrays (rate, burst, quota) the kernel consumes —
    computed once host-side, so both engines read identical values.

Built-ins:

  * ``admit_all``      (code 0) — no shedding; the open-loop baseline.
  * ``token_bucket``   (code 1) — per-tenant token bucket: tokens refill
    at ``rate * weight`` per second up to ``burst * weight`` (weighted
    fair shares); an arrival is admitted iff a full token is available
    and consumes it. The classic rate limiter.
  * ``interval_quota`` (code 2) — at most ``round(quota * weight)``
    admits per scheduling interval; the counter resets at every Spork
    allocator tick, coupling shedding to the allocation cadence.

Register new policies with `repro_torch.policies.register_admission`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.policies.base import PolicyRegistry


@dataclass(frozen=True)
class AdmissionPolicy:
    """Router-level admission rule (frozen: hashable plan group key —
    but the ``code`` itself rides as a per-cell tensor in the batched
    engine so policies share one dispatch group).

    Subclasses override `tenant_params`; the decision itself is the
    shared `admission_decide` kernel, selected by ``code``."""

    name: str = "base"
    code: int = -1           # per-cell select code (registry-unique)

    def tenant_params(self, weights) -> tuple:
        """Per-tenant float32 knob arrays ``(rate, burst, quota)`` for N
        tenants with the given fairness weights. Knobs a policy does not
        consume are zero (numerically inert in `admission_decide`)."""
        z = np.zeros(len(weights), np.float32)
        return z, z.copy(), z.copy()


@dataclass(frozen=True)
class AdmitAll(AdmissionPolicy):
    """No admission control: every offered request enters dispatch."""

    name: str = "admit_all"
    code: int = 0


@dataclass(frozen=True)
class TokenBucket(AdmissionPolicy):
    """Weighted-fair token bucket: tenant i refills at ``rate *
    weight_i`` tokens/s up to ``burst * weight_i`` (floor 1 token so
    every tenant can admit at least occasionally); each admit consumes
    one token."""

    name: str = "token_bucket"
    code: int = 1
    rate: float = 8.0        # tokens per second at weight 1.0
    burst: float = 16.0      # bucket depth at weight 1.0

    def tenant_params(self, weights) -> tuple:
        w = np.asarray(weights, np.float32)
        rate = np.float32(self.rate) * w
        burst = np.maximum(np.float32(self.burst) * w, np.float32(1.0))
        return rate, burst, np.zeros(len(w), np.float32)


@dataclass(frozen=True)
class IntervalQuota(AdmissionPolicy):
    """Per-interval admit quota: tenant i admits at most
    ``max(round(quota * weight_i), 1)`` requests between consecutive
    Spork allocator ticks; the counter resets at every tick."""

    name: str = "interval_quota"
    code: int = 2
    quota: float = 64.0      # admits per interval at weight 1.0

    def tenant_params(self, weights) -> tuple:
        w = np.asarray(weights, np.float32)
        z = np.zeros(len(w), np.float32)
        quota = np.maximum(np.round(np.float32(self.quota) * w),
                           np.float32(1.0)).astype(np.float32)
        return z, z.copy(), quota


def admission_decide(code, t, tok, last, cnt, rate, burst, quota, xp):
    """The shared per-arrival admission function — ONE function for both
    engines (``xp`` is `numpy` in the serial oracle, `torch` in the
    batched engine; all float values are float32 in both, so the
    decision stream is bit-identical).

    State per tenant: ``tok`` (token level, f32), ``last`` (last bucket
    refill time, f32), ``cnt`` (admits this interval, i32). Returns
    ``(admit, tok', last', cnt')``; state for families the ``code`` does
    not select passes through untouched."""
    one = xp.asarray(1.0, dtype=xp.float32)
    tok2 = xp.minimum(burst, tok + (t - last) * rate)
    admit_tb = tok2 >= one
    admit_q = cnt < quota
    is_tb = code == 1
    is_q = code == 2
    admit = xp.where(is_tb, admit_tb, xp.where(is_q, admit_q, True))
    tok_new = xp.where(is_tb, xp.where(admit_tb, tok2 - one, tok2), tok)
    last_new = xp.where(is_tb, t, last)
    cnt_new = xp.where(is_q & admit_q, cnt + 1, cnt)
    return admit, tok_new, last_new, cnt_new


ADMISSION_REGISTRY = PolicyRegistry("admission", AdmissionPolicy)
ADMISSION_REGISTRY.register(AdmitAll())
ADMISSION_REGISTRY.register(TokenBucket())
ADMISSION_REGISTRY.register(IntervalQuota())
