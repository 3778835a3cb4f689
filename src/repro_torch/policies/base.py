"""Policy-as-plugin base layer (port of `repro.policies.base`; the
admission family waits for the fleet slice).

A policy is a **frozen dataclass** (its static structure: hashable, so
it can key a sweep plan's groups) + a `RateParams` tuple of per-cell
tensors (tunable without touching the policy object) + **pure step
functions** on batched state. Where the reference traces one cell under
``vmap``, every tensor here carries a leading cell axis ``(C, ...)``.

Two families, matching the two simulator levels: `RatePolicy` for the
rate simulator, and `DispatchPolicy`, the per-request rule (paper Alg. 3,
Table 9) of both discrete-event engines.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.device import resolve_device


class RateParams(NamedTuple):
    """Per-cell rate-policy parameters, each a ``(C,)`` tensor.

    Every leaf is consumed by at least one policy and ignored by the
    rest, so one layout serves all policies and parameter values.
    """

    headroom: torch.Tensor      # i32 — fpga_dynamic/predictive spare capacity
    static_level: torch.Tensor  # i32 — fpga_static provisioning level
    gain: torch.Tensor          # f32 — predictive forecast gain

    @staticmethod
    def make(headroom: int = 0, static_level: int = 0, gain: float = 1.0,
             device: str | torch.device | None = None) -> "RateParams":
        """One cell's parameters, each a ``(1,)`` tensor on ``device``
        (None: the card)."""
        dev = resolve_device(device)
        return RateParams(
            torch.tensor([headroom], dtype=torch.int32, device=dev),
            torch.tensor([static_level], dtype=torch.int32, device=dev),
            torch.tensor([gain], dtype=torch.float32, device=dev))


class RateCtx(NamedTuple):
    """Per-invocation context threaded to every `RatePolicy` method: the
    static loop configuration (python ints — they set ring sizes and loop
    lengths) plus the per-cell fleet scalars and objective terms."""

    interval_s: int            # scheduling interval (static)
    spin_up_s: int             # FPGA spin-up seconds (static)
    n_max: int                 # worker-count cap (static)
    fs: Any                    # ratesim.FleetScalars, (C,) leaves
    size_s: Any                # (C,) request service time on a CPU
    coeffs: Any                # Alg. 2 ObjectiveCoeffs, (C,) leaves
    tb: Any                    # (C,) breakeven threshold


@dataclass(frozen=True)
class RatePolicy:
    """Base fluid-level policy: CPU-fallback serving, 1 s CPU linger,
    idle-timeout reclaim, no allocation. Frozen + hashable, so an
    instance is a plan group key.

    Subclasses override the methods below; each takes the `RateCtx` +
    `RateParams` pair and batched state, and must not read tensor values
    on the host (`ratesim` calls them every simulated second).
    """

    name: str = "base"

    #: carries the Alg. 2 per-level lifetime stats + conditional
    #: histogram (O(n_max^2) state); everything else gets placeholders.
    uses_predictor = False
    #: dynamics independent of interval/spin-up latency: the planner
    #: regroups these cells under one canonical static key.
    latency_free = False

    # ---- serving (inside ratesim._second_step) ----
    def dispatch_step(self, ctx: RateCtx, params: RateParams, state,
                      W, arrivals, up):
        """Serve one second of demand ``W`` (CPU-seconds) given ``up``
        spun-up FPGAs. Returns (fpga_work, cpu_work, queue, missed)."""
        cap_f = up.to(torch.float32) * ctx.fs.S
        fpga_work = torch.minimum(W, cap_f)
        cpu_work = W - fpga_work
        return fpga_work, cpu_work, state.queue, torch.zeros_like(W)

    def cpu_keep(self, state, up, arrivals, n_cpu):
        """On-demand CPU pool linger rule. Returns (cpu_alive,
        cpu_prev_next): CPUs drawing power this second, and the value
        carried as ``state.cpu_prev``."""
        return torch.maximum(n_cpu, state.cpu_prev), n_cpu

    # ---- idle reclaim (inside ratesim._second_step) ----
    def reclaim(self, ctx: RateCtx, params: RateParams, used_ring,
                young_ring, up, used_f):
        """FPGAs to deallocate this second (idle-timeout rule)."""
        protected = torch.maximum(used_ring.amax(dim=1),
                                  young_ring.sum(dim=1, dtype=torch.int32))
        protected = self.protect(ctx, params, protected, used_f)
        return torch.clamp(up - protected, min=0)

    def protect(self, ctx: RateCtx, params: RateParams, protected, used_f):
        """Extra reclaim protection floor (autoscaler headroom)."""
        return protected

    # ---- allocation ----
    def init_alloc(self, ctx: RateCtx, params: RateParams, counts):
        """Warm-start allocation before the trace begins. ``counts`` is
        the (C, k, interval_s) reshaped arrival tensor. Returns (init_up,
        init_spinups) — spin-up energy/cost is charged by the caller."""
        cells = counts.shape[0]
        return (torch.zeros(cells, dtype=torch.int32, device=counts.device),
                torch.zeros(cells, dtype=torch.float32, device=counts.device))

    def allocator_tick(self, ctx: RateCtx, params: RateParams, state, xs):
        """Start-of-interval allocation decision (Alg. 1 for Spork).
        ``xs = (next_true_needed, next_W, next2_W)`` are lookahead
        inputs (ideal variants only). Returns the new SimState; MUST
        zero the F_acc/C_acc interval accumulators."""
        raise NotImplementedError(self.name)


class Candidates(NamedTuple):
    """Per-arrival candidate summary the batched DES hands to
    `DispatchPolicy.combine`, computed once and shared by every policy
    (`events_batched._find_candidates`). Flags and availabilities are
    ``(C,)``, one-hots ``(C, W)``."""

    f_found: torch.Tensor     # any feasible FPGA (ready or pending)
    c_found: torch.Tensor     # any feasible CPU
    av_f: torch.Tensor        # winning FPGA availability (busiest-first key)
    av_c: torch.Tensor        # winning CPU availability
    oh_f: torch.Tensor        # (C, W) one-hot: winning FPGA slot
    oh_c: torch.Tensor        # (C, W) one-hot: winning CPU slot
    rr_found: torch.Tensor    # any feasible ring worker
    oh_rr: torch.Tensor       # (C, W) one-hot: winning ring slot


@dataclass(frozen=True)
class DispatchPolicy:
    """Per-request dispatch rule (paper Alg. 3 variants, Table 9).

    One object drives both DES engines: the serial oracle calls
    `find_worker` / `find_worker_f` (which may use the sim's candidate
    helpers and cursor state); the batched engine evaluates every
    registered policy's `combine` on the shared `Candidates` and selects
    per cell by the integer ``code`` (`repro_torch.policies.des.
    dispatch_select`), so one chunk may mix policies."""

    name: str = "base"
    code: int = -1           # select code (stable, registry-unique)

    # ---- serial oracle (repro_torch.sim.events.EventSim) ----
    def find_worker(self, sim):
        """Pick a worker on the pristine path (no failure model)."""
        raise NotImplementedError(self.name)

    def find_worker_f(self, sim):
        """Failure-aware twin: straggler-scaled feasibility, evacuated
        workers skipped."""
        raise NotImplementedError(self.name)

    # ---- batched engine (repro_torch.sim.events_batched) ----
    def combine(self, cand: Candidates):
        """Combine the shared candidate groups into this policy's pick.
        Returns (found ``(C,)``, oh_winner ``(C, W)``)."""
        raise NotImplementedError(self.name)


class PolicyRegistry:
    """Name -> singleton policy objects for one policy family."""

    def __init__(self, family: str, base: type):
        self._family = family
        self._base = base
        self._by_name: dict[str, Any] = {}

    def register(self, policy):
        if not isinstance(policy, self._base):
            raise TypeError(f"{self._family} policy must be a "
                            f"{self._base.__name__}, got {policy!r}")
        if policy.name in self._by_name:
            raise ValueError(
                f"duplicate {self._family} policy name {policy.name!r}")
        self._by_name[policy.name] = policy
        return policy

    def get(self, policy):
        """Resolve a name or pass a policy object through."""
        if isinstance(policy, self._base):
            return policy
        try:
            return self._by_name[policy]
        except (KeyError, TypeError):
            raise ValueError(
                f"unknown policy {policy!r} (registered {self._family} "
                f"policies: {sorted(self._by_name)})") from None

    def names(self) -> tuple[str, ...]:
        return tuple(self._by_name)

    def all(self) -> tuple:
        return tuple(self._by_name.values())


RATE_REGISTRY = PolicyRegistry("rate", RatePolicy)
DISPATCH_REGISTRY = PolicyRegistry("dispatch", DispatchPolicy)
