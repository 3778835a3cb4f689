"""Per-request dispatch policies (paper Alg. 3 / Table 9) shared by both
DES engines (port of `repro.policies.des`).

The serial oracle (`repro_torch.sim.events.EventSim`) calls `find_worker`
/ `find_worker_f` on the sim's candidate helpers (`_try_type` /
`_try_type_f`) and round-robin cursor. The batched engine
(`repro_torch.sim.events_batched`) computes the shared `Candidates`
summary once per arrival and applies `dispatch_select`: every registered
policy's `combine` rule, folded under each cell's integer policy code,
so cells of different policies share one chunk. The codes of the three
built-in policies are frozen (spork 0, index_packing 1, round_robin 2);
the `arrival` CUDA kernel hard-codes their three rules.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.policies.base import (DISPATCH_REGISTRY, Candidates,
                                       DispatchPolicy)


def _pick(flag: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per cell: one-hot ``a`` where ``flag``, else ``b``."""
    return torch.where(flag[:, None], a, b)


@dataclass(frozen=True)
class SporkDispatch(DispatchPolicy):
    """Efficient-first: FPGAs before CPUs; within a type busiest-first,
    then least-idle, then being-allocated-with-most-queued-load."""

    name: str = "spork"
    code: int = 0

    def find_worker(self, sim):
        return sim._try_type("fpga") or sim._try_type("cpu")

    def find_worker_f(self, sim):
        return sim._try_type_f("fpga") or sim._try_type_f("cpu")

    def combine(self, cand: Candidates):
        return (cand.f_found | cand.c_found,
                _pick(cand.f_found, cand.oh_f, cand.oh_c))


@dataclass(frozen=True)
class IndexPacking(DispatchPolicy):
    """AutoScale [27]: busiest-first across ALL workers regardless of
    type (may prefer a busy CPU over an idle FPGA — the inefficiency
    Table 9 quantifies). FPGA wins exact ties."""

    name: str = "index_packing"
    code: int = 1

    def find_worker(self, sim):
        a, b = sim._try_type("fpga"), sim._try_type("cpu")
        if a and b:      # busiest-first regardless of type
            return a if a.available_at >= b.available_at else b
        return a or b

    def find_worker_f(self, sim):
        a, b = sim._try_type_f("fpga"), sim._try_type_f("cpu")
        if a and b:
            return a if a.available_at >= b.available_at else b
        return a or b

    def combine(self, cand: Candidates):
        pick_f = torch.where(cand.f_found & cand.c_found,
                             cand.av_f >= cand.av_c, cand.f_found)
        return (cand.f_found | cand.c_found,
                _pick(pick_f, cand.oh_f, cand.oh_c))


@dataclass(frozen=True)
class RoundRobin(DispatchPolicy):
    """MArk [93]: cycle over the provisioned ring, burst CPUs as
    fallback. The cursor lives on the sim (serial) / carry (batched)."""

    name: str = "round_robin"
    code: int = 2

    def find_worker(self, sim):
        n = len(sim.rr_ring)
        for k in range(n):
            wid = sim.rr_ring[(sim.rr_pos + k) % n]
            w = sim.workers[wid]
            slack = sim.now + sim.deadline - sim._service(w.kind)
            if max(w.available_at, sim.now) <= slack:
                sim.rr_pos = (sim.rr_pos + k + 1) % n
                return w
        return sim._try_type("cpu")

    def find_worker_f(self, sim):
        # Evacuated workers keep their ring *positions* (the cursor
        # cycles over the provisioned ring) but are skipped as
        # infeasible, exactly like the batched engine's feasibility mask.
        n = len(sim.rr_ring)
        for k in range(n):
            wid = sim.rr_ring[(sim.rr_pos + k) % n]
            w = sim.workers[wid]
            if sim._evac_now(w):
                continue
            slack = sim.now + sim.deadline - sim._service_w(w)
            if max(w.available_at, sim.now) <= slack:
                sim.rr_pos = (sim.rr_pos + k + 1) % n
                return w
        return sim._try_type_f("cpu")

    def combine(self, cand: Candidates):
        return (cand.rr_found | cand.c_found,
                _pick(cand.rr_found, cand.oh_rr, cand.oh_c))


SPORK_DISPATCH = DISPATCH_REGISTRY.register(SporkDispatch())
INDEX_PACKING = DISPATCH_REGISTRY.register(IndexPacking())
ROUND_ROBIN = DISPATCH_REGISTRY.register(RoundRobin())
#: The policies whose rules the `arrival` kernel implements.
BUILTIN_CODES = (0, 1, 2)


def dispatch_select(code: torch.Tensor, cand: Candidates):
    """Per-cell select over every registered dispatch policy: evaluate
    each policy's `combine` on the shared candidates and fold them under
    ``code`` ``(C,)``. The highest code is the default and the lowest is
    innermost, as in the reference."""
    policies = sorted(DISPATCH_REGISTRY.all(), key=lambda p: p.code)
    found, oh = policies[-1].combine(cand)
    for p in reversed(policies[:-1]):
        f_p, oh_p = p.combine(cand)
        sel = code == p.code
        found = torch.where(sel, f_p, found)
        oh = _pick(sel, oh_p, oh)
    return found, oh
