"""repro_torch.policies — the rate family of the policy-as-plugin layer
(port of `repro.policies`; the dispatch and admission families wait for
the discrete-event and fleet slices).

A policy is a frozen dataclass (static structure: plan group key) + a
`RateParams` tuple of per-cell tensors + pure step functions on batched
state. Registries admit new policies without touching the simulator.
"""

from repro_torch.policies.base import (RATE_REGISTRY, RateCtx, RateParams,
                                       RatePolicy)
from repro_torch.policies import rate as _rate  # noqa: F401  (registers rate)

__all__ = [
    "RateCtx", "RateParams", "RatePolicy", "get_rate_policy",
    "rate_policies", "rate_policy_names", "register_rate",
]


def get_rate_policy(policy) -> RatePolicy:
    """Resolve a rate policy by name, or pass an instance through.
    Raises ValueError for unknown names."""
    return RATE_REGISTRY.get(policy)


def rate_policy_names() -> tuple[str, ...]:
    return RATE_REGISTRY.names()


def rate_policies() -> tuple[RatePolicy, ...]:
    return RATE_REGISTRY.all()


def register_rate(policy: RatePolicy) -> RatePolicy:
    """Register a new rate policy object (unique name required). The
    sweep planner and the `ratesim` entry points pick it up immediately."""
    return RATE_REGISTRY.register(policy)
