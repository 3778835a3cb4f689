"""repro_torch.policies — the rate, dispatch and admission families of
the policy-as-plugin layer (port of `repro.policies`).

A policy is a frozen dataclass (static structure: plan group key) + a
`RateParams` tuple of per-cell tensors + pure step functions on batched
state. Registries admit new policies without touching the simulators.
"""

from repro_torch.policies.base import (DISPATCH_REGISTRY, RATE_REGISTRY,
                                       Candidates, DispatchPolicy, RateCtx,
                                       RateParams, RatePolicy)
from repro_torch.policies import des as _des  # noqa: F401  (registers dispatch)
from repro_torch.policies import rate as _rate  # noqa: F401  (registers rate)
from repro_torch.policies.admission import (ADMISSION_REGISTRY,
                                            AdmissionPolicy,
                                            admission_decide)
from repro_torch.policies.des import dispatch_select

__all__ = [
    "AdmissionPolicy", "Candidates", "DispatchPolicy", "RateCtx",
    "RateParams", "RatePolicy", "admission_decide", "admission_policies",
    "admission_policy_names", "dispatch_policies", "dispatch_policy_names",
    "dispatch_select", "get_admission_policy", "get_dispatch_policy",
    "get_rate_policy", "rate_policies", "rate_policy_names",
    "register_admission", "register_dispatch", "register_rate",
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


def get_dispatch_policy(policy) -> DispatchPolicy:
    """Resolve a dispatch policy by name, or pass an instance through."""
    return DISPATCH_REGISTRY.get(policy)


def dispatch_policy_names() -> tuple[str, ...]:
    return DISPATCH_REGISTRY.names()


def dispatch_policies() -> tuple[DispatchPolicy, ...]:
    return DISPATCH_REGISTRY.all()


def register_dispatch(policy: DispatchPolicy) -> DispatchPolicy:
    """Register a new dispatch policy object (unique name AND unique code
    required: the batched engine folds `combine` rules under the code).
    The plain PyTorch engine picks it up at once; the `arrival` kernel
    implements only the built-in three and refuses chunks once another
    policy is registered."""
    for p in DISPATCH_REGISTRY.all():
        if p.code == policy.code:
            raise ValueError(
                f"dispatch code {policy.code} already taken by {p.name!r}")
    return DISPATCH_REGISTRY.register(policy)


def get_admission_policy(policy) -> AdmissionPolicy:
    """Resolve an admission policy by name, or pass an instance through."""
    return ADMISSION_REGISTRY.get(policy)


def admission_policy_names() -> tuple[str, ...]:
    return ADMISSION_REGISTRY.names()


def admission_policies() -> tuple[AdmissionPolicy, ...]:
    return ADMISSION_REGISTRY.all()


def register_admission(policy: AdmissionPolicy) -> AdmissionPolicy:
    """Register a new admission policy object (unique name AND unique code
    required: both fleet engines select the shared `admission_decide`
    function by the code)."""
    for p in ADMISSION_REGISTRY.all():
        if p.code == policy.code:
            raise ValueError(
                f"admission code {policy.code} already taken by {p.name!r}")
    return ADMISSION_REGISTRY.register(policy)
