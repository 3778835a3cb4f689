"""Batched multi-tenant fleet engine: tenant axis beside the DES state.

Port of `repro.fleet.engine`: the batched twin of
`repro_torch.fleet.oracle.FleetSim`, built ON TOP of the single-tenant
batched DES (`repro_torch.sim.events_batched`) rather than beside it.
Every tensor carries the chunk's cell axis ``(C, ...)`` and a Python loop
walks the entry stream; each arrival slot

  1. gathers each cell's tenant admission state, runs the shared float32
     `repro_torch.policies.admission.admission_decide` under the cell's
     admission code (every admission policy shares one dispatch), and
     writes the state back;
  2. applies the arrival through the UNCHANGED arrival path as a block of
     one, `kernels.arrival.ops.bind`'s step with the tenant's size and SLO
     deadline swapped in for this block: on the card the `arrival` kernel
     (one launch a slot), on the CPU the plain `_arrival_step` /
     `_arrival_fail`. Shed and padded arrivals become ``t = +inf``, an
     exact no-op in both. Admission decisions interleave between
     arrivals, so the fleet path cannot hand the kernel a longer block;
  3. tallies the tenant's counters from the deltas the arrival applied to
     the shared carry — the same delta-observation rule as the serial
     oracle. The outcome flags of an entry's slots are kept on the device
     and added per tenant once per entry, so no slot reads the device
     from the host.

The loop stops each entry at the chunk's last real slot (the plan's host
times say where, with no device read); the slots after it hold +inf in
every cell, no-ops in admission and in both arrival bodies, so the
counts and energies are bitwise those of the full scan. Interval ticks
run the unchanged `_tick_step` on *aggregate* interval load (the
allocator never reads size/deadline) and reset the ``interval_quota``
admission counters.

Equivalence contract (tests/test_torch_fleet.py): on dyadic tenant
streams the engine matches `FleetSim` exactly on offered/admitted/shed/
missed counters and to ~1e-5 on energies and work, and the reference's
engine likewise.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch.policies import admission_decide
from repro_torch.sim.events_batched import (EvCarry, EventScalars, _finish,
                                            _tick_step, init_carry,
                                            init_tick_state)

_FLAGS = ("offered", "admitted", "shed", "missed", "served_f", "served_c")


class FleetTenantAcc(NamedTuple):
    """Per-tenant accumulators, each ``(C, N)``."""

    offered: torch.Tensor    # i64 arrivals seen by the router
    admitted: torch.Tensor   # i64 admitted into dispatch
    shed: torch.Tensor       # i64 rejected by admission
    missed: torch.Tensor     # i64 SLO deadline misses (incl. drops)
    work_f: torch.Tensor     # f64 cpu-seconds served on FPGAs
    work_c: torch.Tensor     # f64 cpu-seconds served on CPUs


class _Admission(NamedTuple):
    """Per-tenant admission state, each ``(C, N)``."""

    tok: torch.Tensor        # f32 token level
    last: torch.Tensor       # f32 last bucket refill time
    cnt: torch.Tensor        # i32 admits this interval


def _fleet_arrival(arrivals, fail_on: bool, w_f: int, acode, adm: _Admission,
                   ar, c: EvCarry, t, tid, knobs, sd) -> tuple:
    """One tenant-tagged arrival slot per cell (``t``, ``tid`` ``(C,)``;
    the tenants' admission ``knobs`` (rate, burst, quota) ``(C,)`` each
    and size/deadline ``sd`` ``(C, 2)``): admission -> (gated) dispatch
    -> outcome flags. Returns the new carry and the ``(6, C)`` flags in
    `_FLAGS` order; ``adm`` is updated in place."""
    real = torch.isfinite(t)
    # padded slots (t = +inf) must not poison the float32 admission
    # arithmetic (inf * 0 = NaN); their state writes are discarded below
    t_k = torch.where(real, t, 0.0)
    idx = (ar, tid)
    tok, last, cnt = adm.tok[idx], adm.last[idx], adm.cnt[idx]
    admit, tok_n, last_n, cnt_n = admission_decide(
        acode, t_k, tok, last, cnt, *knobs, xp=torch)
    admit = admit & real
    adm.tok[idx] = torch.where(real, tok_n, tok)
    adm.last[idx] = torch.where(real, last_n, last)
    adm.cnt[idx] = torch.where(real, cnt_n, cnt)
    t_eff = torch.where(admit, t, torch.inf)
    c2 = arrivals(c, t_eff[:, None], sd)
    if fail_on:
        served_f = c2.fail.work_f > c.fail.work_f
        served_c = c2.fail.work_c > c.fail.work_c
        missed = ((c2.miss_slot != c.miss_slot).any(dim=1)
                  | (c2.fail.dropped > c.fail.dropped))
    else:
        served_f = (c2.serv_slot[:, :w_f] != c.serv_slot[:, :w_f]).any(dim=1)
        served_c = (c2.serv_slot[:, w_f:] != c.serv_slot[:, w_f:]).any(dim=1)
        missed = (c2.miss_slot != c.miss_slot).any(dim=1)
    flags = torch.stack([real, admit, real & ~admit, missed, served_f,
                         served_c])
    return c2, flags


def _simulate_fleet_cells(n_max: int, w_fpga: int, w_cpu: int, fstat,
                          es: EventScalars, codes, acodes, times, tids,
                          tick_t, is_tick, ta_size, ta_dl, adm_rate,
                          adm_burst, adm_quota, slots: Sequence[int]) -> tuple:
    """Cell-batched fleet core: ``times`` / ``tids`` ``(C, E, BLOCK)``
    (+inf / 0 padded), ``tick_t`` / ``is_tick`` ``(C, E)``, the tenant
    tables ``(C, N)``, ``codes`` / ``acodes`` and every `EventScalars`
    leaf ``(C,)``, all on one device; ``slots[e]`` is how many slots of
    entry ``e`` to walk (the chunk's last real slot + 1: `BLOCK` walks
    the full scan). Returns ``(Accum, FailAcc, overflow, FleetTenantAcc)``,
    the first three as `events_batched._simulate_cells` returns them."""
    # imported here: the kernel package imports events_batched
    from repro_torch.kernels.arrival.ops import bind

    cells, n_entries, block = times.shape
    dev = times.device
    W = w_fpga + w_cpu
    is_f = torch.arange(W, device=dev) < w_fpga
    c = init_carry(cells, W, dev)
    ts = init_tick_state(cells, n_max, dev)
    n_ten = ta_size.shape[1]
    ar = torch.arange(cells, device=dev)
    adm = _Admission(tok=adm_burst.clone(),
                     last=torch.zeros_like(adm_burst),
                     cnt=torch.zeros((cells, n_ten), dtype=torch.int32,
                                     device=dev))
    # static per-tenant tables, gathered once per entry: (C, N, 5)
    tables = torch.stack([adm_rate, adm_burst, adm_quota, ta_size, ta_dl],
                         dim=2)
    counts = torch.zeros((len(_FLAGS), cells, n_ten), dtype=torch.int64,
                         device=dev)
    ticks = is_tick.any(dim=0).tolist()            # one host read per chunk
    arrivals = bind(es, fstat, codes, w_fpga)
    for e in range(n_entries):
        if slots[e]:
            flags = torch.zeros((len(_FLAGS), cells, block),
                                dtype=torch.int64, device=dev)
            t_e, tid_e = times[:, e], tids[:, e].long()
            tab_e = tables.gather(1, tid_e[..., None].expand(-1, -1, 5))
            for i in range(slots[e]):
                tab = tab_e[:, i]
                c, flags[:, :, i] = _fleet_arrival(
                    arrivals, fstat.enabled, w_fpga, acodes, adm, ar, c,
                    t_e[:, i], tid_e[:, i], tab[:, :3].unbind(1), tab[:, 3:])
            counts.scatter_add_(2, tid_e.expand(len(_FLAGS), -1, -1), flags)
        if ticks[e]:
            c, ts = _tick_step(es, fstat, w_fpga, is_f, c, ts, tick_t[:, e],
                               is_tick[:, e])
            adm.cnt.masked_fill_(is_tick[:, e, None], 0)
    acc, fl, overflow = _finish(es, fstat, w_fpga, is_f, c, ts)
    size = ta_size.to(torch.float64)
    fa = FleetTenantAcc(offered=counts[0], admitted=counts[1], shed=counts[2],
                        missed=counts[3], work_f=counts[4] * size,
                        work_c=counts[5] * size)
    return acc, fl, overflow, fa
