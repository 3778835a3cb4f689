"""Port batched DES engine (`repro_torch.sim.events_batched`, plan_events,
sweep_events) vs the reference.

On the CPU the port's engine reproduces the ``batched`` section of every
pinned event golden, through `simulate_events_batched` (default tables)
and through `sweep_events` (w_fpga 16, w_cpu 32): counters exactly,
energies within 1e-5. Its planner lays out the reference planner's
arrays; `_settle` and `_tick_step` equal the reference's from a mid-run
state carried across; and the gated allocator tick leaves inactive cells
bit-unchanged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ft.failures import FailStatic as RefFailStatic
from repro.sim import events_batched as ref_eb
from repro.sim.exec import _event_args as ref_event_args
from repro.sim.plan import plan_events as ref_plan_events
from repro.sim.sweep import EventCell as RefCell
from repro_torch import interop
from repro_torch.core.breakeven import objective_setup
from repro_torch.core.predictor import allocator_tick
from repro_torch.core.workers import DEFAULT_FLEET
from repro_torch.ft.failures import FailureSpec
from repro_torch.kernels.arrival.ops import arrival_block
from repro_torch.sim import events_batched as eb
from repro_torch.sim.exec import _event_args
from repro_torch.sim.plan import plan_events
from repro_torch.sim.sweep import EventCell, sweep_events
from test_arrival_kernel import FAIL_SPEC
from test_events_batched import HORIZON, QFLEET as REF_QFLEET, bursty_trace
from test_policy_equivalence import (EVENT_KEYS, FSPEC, GOLDENS,
                                     assert_matches_golden, event_arrivals)

QFLEET = DEFAULT_FLEET.replace(cpu=DEFAULT_FLEET.cpu.replace(spin_up_s=1.0))
N_MAX = 64
CPU = torch.device("cpu")


def port_spec(spec):
    return None if spec is None else FailureSpec(**dataclasses.asdict(spec))


def _golden_cell(key, cls=EventCell, fleet=QFLEET, conv=port_spec):
    disp, _, fail_key = key.partition("@")
    return cls(disp, event_arrivals(), 1.0, fleet, horizon_s=float(HORIZON),
               failures=conv(FSPEC if fail_key == "combined" else None))


@pytest.mark.parametrize("key", EVENT_KEYS)
def test_simulate_events_batched_matches_goldens(key):
    disp, _, fail_key = key.partition("@")
    tot = eb.simulate_events_batched(
        event_arrivals(), 1.0, QFLEET, dispatcher=disp,
        horizon_s=float(HORIZON), n_max=N_MAX,
        failures=port_spec(FSPEC if fail_key == "combined" else None),
        device="cpu")
    assert tot.breakdown["slot_overflow"] == 0
    assert_matches_golden(tot, GOLDENS["event"][key]["batched"],
                          ("batched", key))


def test_sweep_events_matches_goldens():
    cells = [_golden_cell(k) for k in EVENT_KEYS]
    res = sweep_events(cells, n_max=N_MAX, w_fpga=16, w_cpu=32, device="cpu")
    assert (res.backend, res.device, res.n_dispatches) == ("local", "cpu", 2)
    assert len(res) == len(cells) and res.totals(0) is res[0]
    for tot, key in zip(res, EVENT_KEYS):
        assert tot.breakdown["slot_overflow"] == 0
        assert_matches_golden(tot, GOLDENS["event"][key]["batched"],
                              ("event-sweep", key))


def _mixed_cells(cls, fleet, conv):
    rng = np.random.default_rng(11)
    cont = np.sort(rng.uniform(0.0, HORIZON, 400))
    cells = [_golden_cell(k, cls, fleet, conv) for k in EVENT_KEYS]
    cells += [cls("spork", cont, 0.25, fleet, horizon_s=float(HORIZON),
                  energy_weight=0.5, deadline_s=3.0),
              cls("round_robin", bursty_trace(3), 1.0, fleet,
                  allocate_fpgas=False, failures=conv(FAIL_SPEC))]
    return cells


def test_plan_events_matches_reference_plan():
    port = plan_events(_mixed_cells(EventCell, QFLEET, port_spec),
                       n_max=N_MAX, w_fpga=16, w_cpu=32)
    ref = ref_plan_events(_mixed_cells(RefCell, REF_QFLEET, lambda s: s),
                          n_max=N_MAX, w_fpga=16, w_cpu=32)
    assert port.n_dispatches == ref.n_dispatches
    for d, r in zip(port.dispatches, ref.dispatches):
        assert d.static[:3] == r.static[:3]
        assert tuple(d.static[3]) == tuple(r.static[3])
        assert (d.cell_idx, d.chunk) == (r.cell_idx, r.chunk)
        assert d.arrays.keys() == r.arrays.keys()
        for k in d.arrays:
            np.testing.assert_array_equal(d.arrays[k], r.arrays[k], err_msg=k)
    seen = sorted(i for d in port.dispatches for i in d.cell_idx)
    assert seen == list(range(len(port.cells)))
    for d in port.dispatches:
        assert d.chunk in (4, 8, 16, 32)
        for k, a in d.arrays.items():
            for r in range(d.n_real, d.chunk):
                np.testing.assert_array_equal(a[r], a[0], err_msg=k)


def test_planner_rejects_what_is_not_ported(tmp_path):
    # scenario cells are resolved now (tests/test_torch_workloads.py holds
    # them to the reference); unresolved, they still fail fast
    from repro_torch.workloads import registry
    spec = registry.get("steady").with_(horizon_s=60, mean_demand_workers=2.0)
    plan = plan_events([EventCell("spork", scenario=spec)], device="cpu")
    assert plan.cells[0].arrival_times is not None
    with pytest.raises(ValueError, match="sweep_events"):
        plan_events([EventCell("spork", scenario=spec)], resolve=False)
    with pytest.raises(ValueError, match="explicit"):
        plan_events([EventCell("spork")])
    # checkpoint_dir is ported (tests/test_torch_harness.py holds resume)
    cell = _golden_cell(EVENT_KEYS[0])
    res = sweep_events([cell], device="cpu", checkpoint_dir=tmp_path)
    assert res.meta["checkpointed"] and res.meta["executed_chunks"] == 1
    with pytest.raises(ValueError, match="sorted"):
        EventCell("spork", np.array([2.0, 1.0]), 1.0)


def _ref_tree(src, cls):
    """A reference NamedTuple (unbatched jnp leaves) from row 0 of the
    port's nested numpy dict."""
    kw = {}
    for f in cls._fields:
        v = src[f]
        sub = {"ws": ref_eb.WorkerTable, "fail": ref_eb.FailAcc}.get(f)
        kw[f] = _ref_tree(v, sub) if sub is not None else jnp.asarray(v[0])
    return cls(**kw)


def _mid_run(cell, ref_cell, stop_tick: int):
    """Run the port's engine on the CPU up to (not including) the
    ``stop_tick``-th tick of row 0; returns the inputs of that tick for
    both packages."""
    plan = plan_events([cell], n_max=N_MAX, w_fpga=16, w_cpu=32)
    d = plan.dispatches[0]
    es, codes, times, tick_t, is_tick = _event_args(d, CPU)
    fstat = d.static[3]
    W = 48
    is_f = torch.arange(W) < 16
    c, ts = eb.init_carry(d.chunk, W, CPU), eb.init_tick_state(d.chunk,
                                                               N_MAX, CPU)
    ticks = np.nonzero(d.arrays["is_tick"][0])[0]
    stop = int(ticks[stop_tick])
    for e in range(stop + 1):
        c = arrival_block(es, fstat, codes, 16, c, times[:, e])
        if e < stop and bool(is_tick[:, e].any()):
            c, ts = eb._tick_step(es, fstat, 16, is_f, c, ts, tick_t[:, e],
                                  is_tick[:, e])
    rplan = ref_plan_events([ref_cell], n_max=N_MAX, w_fpga=16, w_cpu=32)
    res = jax.tree.map(lambda a: a[0], ref_event_args(rplan.dispatches[0])[0])
    rc = _ref_tree(interop.to_numpy(c), ref_eb.EvCarry)
    rts = _ref_tree(interop.to_numpy(ts), ref_eb.TickState)
    return (es, fstat, is_f, c, ts, tick_t[:, stop], is_tick[:, stop],
            res, rc, rts)


def _assert_same(port_tree, ref_tree, tag, close=()):
    got = interop.to_numpy(port_tree)

    def walk(g, r, path):
        for f in r._fields:
            rv = getattr(r, f)
            if hasattr(rv, "_fields"):
                walk(g[f], rv, f"{path}.{f}")
            elif f in close:
                np.testing.assert_allclose(g[f][0], np.asarray(rv),
                                           rtol=1e-6, err_msg=f"{tag} {f}")
            else:
                np.testing.assert_array_equal(g[f][0], np.asarray(rv),
                                              err_msg=f"{tag} {path}.{f}")

    walk(got, ref_tree, "")


@pytest.mark.parametrize("failures", [None, FAIL_SPEC],
                         ids=["pristine", "failures"])
@pytest.mark.parametrize("disp", ["spork", "round_robin"])
def test_tick_step_and_settle_match_reference(disp, failures):
    cell = EventCell(disp, bursty_trace(5), 1.0, QFLEET,
                     horizon_s=float(HORIZON), failures=port_spec(failures))
    ref_cell = RefCell(disp, bursty_trace(5), 1.0, REF_QFLEET,
                       horizon_s=float(HORIZON), failures=failures)
    (es, fstat, is_f, c, ts, tt, tk, res, rc, rts) = _mid_run(cell, ref_cell,
                                                             stop_tick=6)
    assert bool(c.ws.alive[0].any()) and bool(tk[0])
    # the reference's state carried back into the port is row 0 again
    batched = lambda t: jax.tree.map(lambda a: np.asarray(a)[None], t)  # noqa: E731
    _assert_same(interop.ev_carry(batched(rc), "cpu"), rc, "carry back")
    _assert_same(interop.tick_state(batched(rts), "cpu"), rts, "ticks back")
    _assert_same(interop.event_scalars(batched(res), "cpu"), res,
                 "scalars back")
    rfstat = RefFailStatic(*fstat)
    r_is_f = jnp.arange(48) < 16
    # a settlement a few seconds past the tick, then the tick itself
    t_late = tt + 3.0
    pc, pts = eb._settle(es, is_f, c, ts._replace(H=ts.H.clone()), t_late,
                         True)
    qc, qts = ref_eb._settle(res, r_is_f, rc, rts, jnp.float32(t_late[0]),
                             True)
    _assert_same(pc, qc, "settle carry")
    _assert_same(pts, qts, "settle ticks", close=("energy",))
    pc, pts = eb._tick_step(es, fstat, 16, is_f, c, ts, tt, tk)
    qc, qts = ref_eb._tick_step(res, rfstat, 16, r_is_f, rc, rts,
                                jnp.float32(tt[0]), True)
    _assert_same(pc, qc, "tick carry")
    _assert_same(pts, qts, "tick state", close=("energy",))


def test_gated_allocator_tick_leaves_inactive_cells_unchanged():
    rng = np.random.default_rng(5)
    C, n = 6, 32
    tb, co = objective_setup(DEFAULT_FLEET, 1.0)
    H0 = torch.from_numpy(rng.integers(0, 4, (C, n, n)).astype(np.float32))
    life_sum = torch.from_numpy(rng.uniform(0, 90, (C, n)).astype(np.float32))
    life_cnt = torch.from_numpy(rng.integers(0, 3, (C, n)).astype(np.float32))
    n_lag = torch.from_numpy(rng.integers(0, n, (C, 2)).astype(np.int32))
    lam = torch.from_numpy(rng.uniform(0, 200, C).astype(np.float32))
    n_curr = torch.from_numpy(rng.integers(0, n, C).astype(np.int32))
    gate = torch.tensor([True, False, True, False, False, True])
    T = torch.full((C,), DEFAULT_FLEET.T_s)
    H, lag, target = allocator_tick(H0.clone(), life_sum, life_cnt, n_lag,
                                    lam, n_curr, co, T, tb, gate=gate)
    Hu, lagu, targetu = allocator_tick(H0.clone(), life_sum, life_cnt, n_lag,
                                       lam, n_curr, co, DEFAULT_FLEET.T_s, tb)
    off = ~gate
    assert torch.equal(H[off], H0[off]) and torch.equal(lag[off], n_lag[off])
    assert torch.equal(H[gate], Hu[gate]) and torch.equal(lag[gate],
                                                          lagu[gate])
    assert torch.equal(target[gate], targetu[gate])
