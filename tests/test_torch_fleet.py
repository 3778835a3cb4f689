"""Port fleet layer (`repro_torch.fleet`, `policies.admission`,
`plan_fleet` / `sweep_fleet`) vs the reference `repro.fleet`.

On dyadic (1/8 s) explicit tenant streams, the port's serial `FleetSim`
equals the reference's `FleetSim`; the port's batched engine equals the
port's `FleetSim` and the reference's batched engine; `sweep_fleet`
equals the reference's `sweep_fleet` — counters exactly (offered,
admitted, shed and missed per tenant, every `RunTotals` counter),
energies and work within 1e-5 — under every admission policy and with
failures on. Per-tenant rows conserve to the cell's totals and the
interval quota resets on each tick. `admission_decide` decides bitwise
alike under numpy, torch and the reference on a grid with exact ties;
the engine's per-arrival size/deadline swap equals the reference's
``es._replace`` step bitwise; and walking each entry only to the
chunk's last real slot gives bitwise the full scan.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
except ImportError:                                  # pragma: no cover
    from _hypothesis_shim import given, settings

import strategies as shared

from repro.core.workers import DEFAULT_FLEET as REF_FLEET
from repro.fleet import FleetCell as RefFleetCell
from repro.fleet import TenantSpec as RefTenantSpec
from repro.fleet import resolve_fleet_cell as ref_resolve_fleet_cell
from repro.fleet import simulate_fleet as ref_simulate_fleet
from repro.ft.failures import FailureSpec as RefFailureSpec
from repro.policies import admission as ref_admission
from repro.sim import events_batched as ref_eb
from repro.sim.plan import plan_fleet as ref_plan_fleet
from repro.sim.sweep import sweep_fleet as ref_sweep_fleet
from repro.workloads import tenant_population as ref_tenant_population
from repro_torch import interop
from repro_torch.core.metrics import RunTotals
from repro_torch.core.workers import DEFAULT_FLEET
from repro_torch.fleet import (FleetCell, TenantSpec, resolve_fleet_cell,
                               simulate_fleet)
from repro_torch.fleet import engine
from repro_torch.ft.failures import FailStatic, FailureSpec
from repro_torch.kernels.arrival.ops import bind
from repro_torch.policies import (admission_decide, admission_policy_names,
                                  get_admission_policy, register_admission)
from repro_torch.policies.admission import (AdmissionPolicy, IntervalQuota,
                                            TokenBucket)
from repro_torch.sim.events_batched import BLOCK, init_carry
from repro_torch.sim.exec import _fleet_args
from repro_torch.sim.plan import plan_fleet
from repro_torch.sim.sweep import sweep_fleet
from repro_torch.workloads import tenant_population
from test_arrival_kernel import FAIL_SPEC, _carry0, _cell_block_inputs
from test_events_batched import HORIZON as REF_HORIZON
from test_events_batched import QFLEET as REF_QFLEET, bursty_trace
from test_torch_arrival import _assert_carry_equal, _port_inputs
from test_torch_workloads import reference_realize  # noqa: F401 (fixture)

QFLEET = DEFAULT_FLEET.replace(cpu=DEFAULT_FLEET.cpu.replace(spin_up_s=1.0))
CPU = "cpu"
KW = dict(n_max=64, w_fpga=16, w_cpu=32)
RTOL = 1e-5
EXACT_FIELDS = RunTotals.COUNT_FIELDS + ("work_on_fpga_cpu_s",
                                         "work_on_cpu_cpu_s")
CLOSE_FIELDS = ("energy_j", "cost_usd", "fpga_idle_j", "fpga_busy_j",
                "cpu_busy_j", "spinup_j", "wasted_spinup_j", "work_cpu_s")
ROW_EXACT = ("tenant", "requests", "admitted", "shed", "deadline_misses",
             "work_on_fpga_cpu_s", "work_on_cpu_cpu_s")
ROW_CLOSE = ("weight", "work_cpu_s", "energy_j", "cost_usd")
FSPEC = dict(spinup_fail_p=0.25, max_retries=1, crash_p=0.0625,
             max_failover=2, retry_backoff_s=2.0, seed=11)


def dyadic_tenants(cls, seed: int = 0, n: int = 3, n_arr: int = 120,
                   horizon: float = 60.0) -> tuple:
    """tests/test_fleet.py::dyadic_tenants for either package."""
    rng = np.random.default_rng(seed)
    sizes = (0.125, 0.25, 0.0625)
    slos = ("standard", "tight", "relaxed")
    weights = (1.0, 0.5, 2.0)
    return tuple(
        cls(arrival_times=tuple(np.sort(rng.integers(0, int(horizon) * 8,
                                                     n_arr)) / 8.0),
            request_size_s=sizes[i % 3], slo=slos[i % 3],
            weight=weights[i % 3], seed=seed + i)
        for i in range(n))


def _ref_admission(adm):
    if isinstance(adm, str):
        return adm
    return getattr(ref_admission, type(adm).__name__)(
        **dataclasses.asdict(adm))


def _ref_failures(f):
    return None if f is None else RefFailureSpec(**dataclasses.asdict(f))


def ref_cell(cell: FleetCell) -> RefFleetCell:
    """The reference's twin of a port cell with explicit tenants."""
    tenants = tuple(RefTenantSpec(
        arrival_times=t.arrival_times, request_size_s=t.request_size_s,
        slo=t.slo, weight=t.weight, seed=t.seed,
        failures=_ref_failures(t.failures)) for t in cell.tenants)
    fleet = REF_QFLEET if cell.fleet == QFLEET else REF_FLEET
    assert interop.fleet_params(fleet) == cell.fleet
    return RefFleetCell(tenants=tenants, dispatcher=cell.dispatcher,
                        admission=_ref_admission(cell.admission),
                        fleet=fleet, energy_weight=cell.energy_weight,
                        horizon_s=cell.horizon_s, seed=cell.seed,
                        allocate_fpgas=cell.allocate_fpgas,
                        failures=_ref_failures(cell.failures))


def port_cell(rc: RefFleetCell) -> FleetCell:
    """The port's twin of a reference cell with explicit tenants."""
    def port_f(f):
        return None if f is None else FailureSpec(**dataclasses.asdict(f))

    adm = rc.admission
    if not isinstance(adm, str):
        adm = globals()[type(adm).__name__](**dataclasses.asdict(adm))
    return FleetCell(
        tenants=tuple(TenantSpec(
            arrival_times=t.arrival_times, request_size_s=t.request_size_s,
            slo=t.slo, weight=t.weight, seed=t.seed,
            failures=port_f(t.failures)) for t in rc.tenants),
        dispatcher=rc.dispatcher, admission=adm,
        fleet=interop.fleet_params(rc.fleet),
        energy_weight=rc.energy_weight, horizon_s=rc.horizon_s,
        seed=rc.seed, allocate_fpgas=rc.allocate_fpgas,
        failures=port_f(rc.failures))


def assert_fleet_equal(got, want, tag, exact_work=True):
    """(RunTotals, rows) pairs: counters exact, floats within RTOL."""
    (gt, gr), (wt, wr) = got, want
    exact = EXACT_FIELDS if exact_work else RunTotals.COUNT_FIELDS
    close = CLOSE_FIELDS + (() if exact_work else EXACT_FIELDS[-2:])
    for f in exact:
        assert getattr(gt, f) == getattr(wt, f), (tag, f)
    for f in close:
        np.testing.assert_allclose(getattr(gt, f), getattr(wt, f),
                                   rtol=RTOL, atol=1e-6, err_msg=f"{tag} {f}")
    for k in ("offered_requests", "shed_requests"):
        assert gt.breakdown[k] == wt.breakdown[k], (tag, k)
    assert len(gr) == len(wr)
    for i, (a, b) in enumerate(zip(gr, wr)):
        for f in ROW_EXACT if exact_work else ROW_EXACT[:5]:
            assert getattr(a, f) == getattr(b, f), (tag, i, f)
        for f in ROW_CLOSE + (() if exact_work else ROW_EXACT[5:]):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=RTOL, atol=1e-6,
                                       err_msg=f"{tag} tenant {i} {f}")


def assert_conserves(tot, rows):
    """Per-tenant rows sum to the cell's totals."""
    assert sum(r.admitted for r in rows) == tot.requests
    assert sum(r.shed for r in rows) == tot.breakdown["shed_requests"]
    assert sum(r.requests for r in rows) == tot.breakdown["offered_requests"]
    assert sum(r.deadline_misses for r in rows) == tot.deadline_misses
    for r in rows:
        assert r.requests == r.admitted + r.shed
        assert r.deadline_misses <= r.admitted
    for f in ("work_on_fpga_cpu_s", "work_on_cpu_cpu_s", "energy_j",
              "cost_usd"):
        np.testing.assert_allclose(sum(getattr(r, f) for r in rows),
                                   getattr(tot, f), rtol=1e-9, atol=1e-9)


def run_all(cell: FleetCell, rc: RefFleetCell | None = None, tables=KW):
    """Port oracle, port batched, reference oracle and reference batched
    on one cell (``rc``: the reference's twin; ``tables``: the batched
    engines' sizes), each pair held equal; returns the port's batched
    run."""
    rc = ref_cell(cell) if rc is None else rc
    p_or = simulate_fleet(cell, n_max=64, device=CPU)
    res = sweep_fleet([cell], device=CPU, **tables)
    p_b = (res.totals(0), res.tenants(0))
    r_or = ref_simulate_fleet(rc, n_max=64)
    rres = ref_sweep_fleet([rc], **tables)
    r_b = (rres.totals(0), rres.tenants(0))
    assert p_b[0].breakdown["slot_overflow"] == 0
    assert_fleet_equal(p_or, r_or, "oracle vs reference oracle")
    assert_fleet_equal(p_b, p_or, "batched vs oracle")
    assert_fleet_equal(p_b, r_b, "batched vs reference batched")
    assert_conserves(*p_b)
    assert_conserves(*p_or)
    return p_b


# --------------------------------------------------------------- admission

def _admission_grid():
    """Every code x states around the token and quota thresholds,
    exact ties included: refills that land exactly on one token, on the
    burst cap, and counts equal to the quota."""
    rows = []
    for code in (0, 1, 2):
        for t, last, tok, rate in ((1.0, 0.0, 0.0, 1.0), (0.5, 0.0, 0.5, 1.0),
                                   (2.0, 1.0, 0.75, 0.25),
                                   (3.0, 1.0, 0.5, 0.25),
                                   (1.1, 1.0, 0.9, 1.0),
                                   (0.3, 0.1, 0.99999994, 1e-7),
                                   (7.25, 7.25, 1.0, 8.0),
                                   (10.0, 0.0, 0.0, 16.0),
                                   (0.125, 0.0, 15.0, 8.0)):
            for cnt, quota in ((0, 1.0), (1, 1.0), (63, 64.0), (64, 64.0),
                               (2, 0.0)):
                rows.append((code, t, tok, last, cnt, rate, 16.0, quota))
    rng = np.random.default_rng(0)
    for _ in range(200):
        rows.append((int(rng.integers(0, 3)), float(rng.uniform(0, 60)),
                     float(rng.uniform(0, 3)), float(rng.uniform(0, 60)),
                     int(rng.integers(0, 5)), float(rng.uniform(0, 2)),
                     float(rng.uniform(1, 4)), float(rng.integers(0, 5))))
    cols = list(zip(*rows))
    f32 = [np.asarray(c, np.float32) for c in cols]
    return (np.asarray(cols[0], np.int32), f32[1], f32[2], f32[3],
            np.asarray(cols[4], np.int32), f32[5], f32[6], f32[7])


def test_admission_decide_bitwise_numpy_torch_reference():
    code, t, tok, last, cnt, rate, burst, quota = _admission_grid()
    want = ref_admission.admission_decide(
        *(jnp.asarray(x) for x in (code, t, tok, last, cnt, rate, burst,
                                   quota)), xp=jnp)
    got_t = admission_decide(*(torch.from_numpy(x) for x in
                               (code, t, tok, last, cnt, rate, burst, quota)),
                             xp=torch)
    for i in range(len(code)):
        one = admission_decide(int(code[i]), t[i], tok[i], last[i], cnt[i],
                               rate[i], burst[i], quota[i], xp=np)
        ref_one = ref_admission.admission_decide(
            int(code[i]), t[i], tok[i], last[i], cnt[i], rate[i], burst[i],
            quota[i], xp=np)
        for k, (a, b, c, d) in enumerate(zip(one, ref_one, got_t, want)):
            a = np.asarray(a)
            assert a.dtype == np.asarray(b).dtype, (i, k)
            assert a.tobytes() == np.asarray(b).tobytes(), (i, k)
            assert a.tobytes() == c[i].numpy().tobytes(), (i, k)
            assert a.tobytes() == np.asarray(d)[i].tobytes(), (i, k)
    admit = got_t[0].numpy()
    assert admit[code == 0].all()
    assert 0 < admit[code == 1].mean() < 1 and 0 < admit[code == 2].mean() < 1


def test_admission_registry_equals_reference():
    assert admission_policy_names() == ref_admission.ADMISSION_REGISTRY.names()
    w = np.array([4.0, 1.0, 0.5, 0.125, 2.7])
    for name in admission_policy_names():
        got = get_admission_policy(name).tenant_params(w)
        want = ref_admission.ADMISSION_REGISTRY.get(name).tenant_params(w)
        assert get_admission_policy(name).code == \
            ref_admission.ADMISSION_REGISTRY.get(name).code
        for g, r in zip(got, want):
            np.testing.assert_array_equal(g, r)
    with pytest.raises(ValueError, match="already taken"):
        register_admission(AdmissionPolicy(name="dup", code=1))
    with pytest.raises(ValueError, match="unknown policy"):
        get_admission_policy("nope")


# ------------------------------------------------------ oracle equivalence

@pytest.mark.parametrize("admission", admission_policy_names())
@pytest.mark.parametrize("disp", ["spork", "round_robin"])
def test_equivalence_explicit_streams(admission, disp):
    cell = FleetCell(tenants=dyadic_tenants(TenantSpec, seed=3),
                     admission=admission, dispatcher=disp, fleet=QFLEET,
                     horizon_s=60.0)
    tot, _ = run_all(cell)
    assert tot.requests > 0


@pytest.mark.parametrize("admission", admission_policy_names())
def test_equivalence_with_failures(admission):
    cell = FleetCell(tenants=dyadic_tenants(TenantSpec, seed=5, n_arr=200),
                     admission=admission, fleet=QFLEET, horizon_s=60.0,
                     failures=FailureSpec(**FSPEC))
    tot, _ = run_all(cell)
    assert tot.crashes + tot.failed_spinups > 0


def test_admission_sheds_and_conserves():
    """A starved token bucket sheds; heavier tenants admit at a higher
    rate; every engine agrees."""
    cell = FleetCell(tenants=dyadic_tenants(TenantSpec, seed=7, n_arr=240),
                     admission=TokenBucket(rate=0.5, burst=2.0),
                     fleet=QFLEET, horizon_s=60.0)
    tot, rows = run_all(cell)
    assert tot.breakdown["shed_requests"] > 0
    frac = [r.admitted / r.requests for r in rows]
    assert frac[2] >= frac[1]


def test_interval_quota_resets_each_tick():
    """quota = 2 per allocator interval: admits track the intervals, not
    the offered load, in every engine."""
    arr = tuple(np.arange(400) * 0.125)   # 50 s of 8 req/s
    cell = FleetCell(
        tenants=(TenantSpec(arrival_times=arr, request_size_s=0.125),),
        admission=IntervalQuota(quota=2.0), fleet=QFLEET, horizon_s=60.0)
    tot, rows = run_all(cell)
    # the arrival at t = 0 is admitted before the tick at t = 0 (arrivals
    # first at equal times); then two a 10 s interval of the 50 s stream
    assert rows[0].admitted == 1 + 2 * int(50.0 / cell.fleet.T_s)
    assert rows[0].shed == 400 - rows[0].admitted


@settings(max_examples=6, deadline=None, derandomize=True)
@given(rc=shared.fleet_cells(with_failures=True))
def test_equivalence_property(rc):
    """Drawn cells (derandomized: the same examples every run) on the
    engine's default tables, where the drawn 60 s FPGA spin-ups do not
    overflow a table region."""
    run_all(port_cell(rc), rc, tables=dict(n_max=64))


def test_sweep_fleet_grid_equals_reference():
    """A multi-cell grid (seeds x admission policies, one of them an
    instance) in one plan: the same dispatches and arrays as the
    reference planner, and the same results."""
    cells = [FleetCell(tenants=dyadic_tenants(TenantSpec, seed=s, n=2 + s),
                       admission=a, fleet=QFLEET, horizon_s=60.0, tag=(s, a))
             for s in (0, 1) for a in ("admit_all", TokenBucket(rate=1.0),
                                       "interval_quota")]
    plan = plan_fleet(cells, **KW)
    rplan = ref_plan_fleet([ref_cell(c) for c in cells], **KW)
    assert plan.n_dispatches == rplan.n_dispatches
    for d, r in zip(plan.dispatches, rplan.dispatches):
        assert (d.kind, d.cell_idx, d.chunk) == (r.kind, r.cell_idx, r.chunk)
        assert d.static[:3] == r.static[:3]
        assert tuple(d.static[3]) == tuple(r.static[3])
        assert d.arrays.keys() == r.arrays.keys()
        for k in d.arrays:
            np.testing.assert_array_equal(d.arrays[k], r.arrays[k],
                                          err_msg=k)
    got = sweep_fleet(cells, device=CPU, **KW)
    want = ref_sweep_fleet([ref_cell(c) for c in cells], **KW)
    assert got.n_dispatches == want.n_dispatches
    assert (got.backend, got.device) == ("local", "cpu")
    for i in range(len(cells)):
        assert_fleet_equal((got.totals(i), got.tenants(i)),
                           (want.totals(i), want.tenants(i)), i)
        assert_conserves(got.totals(i), got.tenants(i))


@pytest.mark.parametrize("admission", admission_policy_names())
def test_equivalence_scenario_population(reference_realize, admission):
    """A tenant population over the registry's scenarios, realized by the
    REFERENCE: the same merged stream, and the engines equal."""
    cell = FleetCell(tenants=tenant_population(8, mean_demand_workers=0.2,
                                               horizon_s=60.0),
                     admission=admission, fleet=QFLEET)
    rc = RefFleetCell(tenants=ref_tenant_population(
        8, mean_demand_workers=0.2, horizon_s=60.0),
        admission=admission, fleet=REF_QFLEET)
    rs = resolve_fleet_cell(cell, CPU)
    rrs = ref_resolve_fleet_cell(rc)
    np.testing.assert_array_equal(rs.times, rrs.times)
    np.testing.assert_array_equal(rs.tids, rrs.tids)
    np.testing.assert_array_equal(rs.sizes, rrs.sizes)
    assert rs.horizon_s == rrs.horizon_s
    p_or = simulate_fleet(cell, n_max=64, device=CPU)
    res = sweep_fleet([cell], device=CPU, **KW)
    rres = ref_sweep_fleet([rc], **KW)
    assert_fleet_equal(p_or, ref_simulate_fleet(rc, n_max=64), "oracle",
                       exact_work=False)
    assert_fleet_equal((res.totals(0), res.tenants(0)), p_or, "batched",
                       exact_work=False)
    assert_fleet_equal((res.totals(0), res.tenants(0)),
                       (rres.totals(0), rres.tenants(0)), "reference",
                       exact_work=False)
    assert res.totals(0).requests > 0


# ------------------------------------------------------- engine internals

def test_early_stop_at_last_real_slot_equals_full_scan():
    """Cells of different stream lengths in one chunk: walking each entry
    to the chunk's last real slot gives the full BLOCK scan's outputs
    bitwise."""
    cells = [FleetCell(tenants=dyadic_tenants(TenantSpec, seed=s, n_arr=n),
                       admission=a, fleet=QFLEET, horizon_s=60.0,
                       failures=f)
             for s, n, a, f in ((0, 60, "token_bucket", None),
                                (1, 150, "admit_all", None),
                                (2, 20, "interval_quota", None))]
    for fail in (None, FailureSpec(**FSPEC)):
        cells_f = [dataclasses.replace(c, failures=fail) for c in cells]
        d, = plan_fleet(cells_f, **KW).dispatches
        *args, slots = _fleet_args(d, torch.device(CPU))
        assert max(slots) < BLOCK and sum(slots) > 0
        short = engine._simulate_fleet_cells(*d.static, *args, slots)
        full = engine._simulate_fleet_cells(*d.static, *args,
                                            [BLOCK] * len(slots))
        for a, b in zip(jax.tree_util.tree_leaves(interop.to_numpy(short[0])),
                        jax.tree_util.tree_leaves(interop.to_numpy(full[0]))):
            assert a.tobytes() == b.tobytes()
        for part in (1, 3):
            sa = interop.to_numpy(short[part])
            fa = interop.to_numpy(full[part])
            for k in sa:
                assert sa[k].tobytes() == fa[k].tobytes(), (part, k)
        assert torch.equal(short[2], full[2])


@pytest.mark.parametrize("failures", [None, FAIL_SPEC],
                         ids=["pristine", "failures"])
def test_arrival_block_of_one_swap_equals_reference_replace(failures):
    """The fleet route's step — a block of one arrival with the tenant's
    size and deadline swapped in (`bind`'s ``size_deadline``) — equals the
    reference engine's ``es._replace(size=..., deadline=...)`` step,
    leaf by leaf after every arrival."""
    cell = ref_eb.EventCell("spork", bursty_trace(0), 1.0, REF_QFLEET,
                            horizon_s=REF_HORIZON, failures=failures)
    es, fstat, code, w_f, times = _cell_block_inputs(cell)
    W = 16 + 32
    is_f, idxW = jnp.arange(W) < w_f, jnp.arange(W, dtype=jnp.float32)
    ref_step = jax.jit(ref_eb._arrival_fail if fstat.enabled
                       else ref_eb._arrival_step,
                       static_argnums=(1, 3) if fstat.enabled else (2,))
    pes, pcode, _ = _port_inputs(es, code, times[0])
    step = bind(pes, FailStatic(*fstat), pcode, w_f)
    table = np.array([[0.125, 1.25], [0.5, 2.5], [1.0, 10.0], [0.0625, 0.3]],
                     np.float32)
    cr, cp = _carry0(W), init_carry(1, W, CPU)
    ts = [float(t) for t in np.asarray(times).ravel() if np.isfinite(t)][:48]
    assert len(ts) == 48
    for i, t in enumerate(ts):
        size, dl = table[i % len(table)]
        es_a = es._replace(size=jnp.float32(size), deadline=jnp.float32(dl))
        args = ((es_a, fstat, code, w_f, is_f, idxW) if fstat.enabled
                else (es_a, code, w_f, is_f, idxW))
        cr = ref_step(*args, cr, jnp.float32(t))
        cp = step(cp, torch.tensor([[t]], dtype=torch.float32),
                  torch.from_numpy(table[i % len(table)])[None])
        _assert_carry_equal(cr, cp, f"arrival {i}")


def test_swap_leaves_the_chunk_scalars_alone():
    cell = ref_eb.EventCell("round_robin", bursty_trace(1), 1.0, REF_QFLEET,
                            horizon_s=REF_HORIZON)
    es, fstat, code, w_f, times = _cell_block_inputs(cell)
    pes, pcode, _ = _port_inputs(es, code, times[0])
    step = bind(pes, FailStatic(*fstat), pcode, w_f)
    c = init_carry(1, 48, CPU)
    t = torch.tensor(np.asarray(times[0]))[None]
    a = step(c, t, torch.tensor([[0.25, 2.0]]))
    b = step(c, t)
    assert float(pes.size[0]) == float(np.asarray(es.size))
    want = bind(pes, FailStatic(*fstat), pcode, w_f)(c, t)
    for x, y in zip(jax.tree_util.tree_leaves(interop.to_numpy(b)),
                    jax.tree_util.tree_leaves(interop.to_numpy(want))):
        assert x.tobytes() == y.tobytes()
    assert not np.array_equal(interop.to_numpy(a)["serv_slot"],
                              interop.to_numpy(b)["serv_slot"])


def test_cuda_fleet_route_matches_plain_version():
    """The batched fleet engine on the card (the arrival kernel in blocks
    of one) equals its CPU run, pristine and failure-aware (needs a CUDA
    card and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.arrival import ops
    for f in (None, FailureSpec(**FSPEC)):
        cell = FleetCell(tenants=dyadic_tenants(TenantSpec, seed=3),
                         admission="token_bucket", fleet=QFLEET,
                         horizon_s=60.0, failures=f)
        d, = plan_fleet([cell], **KW).dispatches
        before = ops.arrival_block.launches
        card = sweep_fleet([cell], device="cuda", **KW)
        assert ops.arrival_block.launches - before == sum(
            _fleet_args(d, torch.device(CPU))[-1])
        cpu = sweep_fleet([cell], device=CPU, **KW)
        assert_fleet_equal((card.totals(0), card.tenants(0)),
                           (cpu.totals(0), cpu.tenants(0)), "card")


# ------------------------------------------------------------ spec hygiene

def test_spec_validation():
    with pytest.raises(ValueError):
        TenantSpec()                                     # no demand source
    with pytest.raises(ValueError):
        TenantSpec(arrival_times=(1.0, 2.0))             # no size
    with pytest.raises(ValueError):
        TenantSpec(arrival_times=(2.0, 1.0), request_size_s=0.1)  # unsorted
    with pytest.raises(ValueError):
        TenantSpec(arrival_times=(1.0,), request_size_s=0.1, slo="gold")
    with pytest.raises(ValueError):
        TenantSpec(arrival_times=(1.0,), request_size_s=0.1, weight=0.0)
    with pytest.raises(ValueError):
        FleetCell(tenants=())
    with pytest.raises(ValueError):
        FleetCell(tenants=dyadic_tenants(TenantSpec), admission="nope")
    t = dyadic_tenants(TenantSpec, n=2)
    bad = (TenantSpec(arrival_times=t[0].arrival_times, request_size_s=0.125,
                      failures=FailureSpec(crash_p=0.0625, seed=1)),
           TenantSpec(arrival_times=t[1].arrival_times, request_size_s=0.125,
                      failures=FailureSpec(crash_p=0.125, seed=2)))
    with pytest.raises(ValueError):
        resolve_fleet_cell(FleetCell(tenants=bad, horizon_s=60.0))
    with pytest.raises(TypeError, match="FleetCell"):
        plan_fleet([object()])
    with pytest.raises(NotImplementedError, match="operability"):
        sweep_fleet([FleetCell(tenants=t, horizon_s=60.0)], device=CPU,
                    checkpoint_dir="x")


def test_resolved_stream_is_stable_merge():
    """Equal-time arrivals keep tenant-index order (the cross-engine tie
    rule); explicit streams need no device."""
    t0 = TenantSpec(arrival_times=(1.0, 2.0, 2.0), request_size_s=0.125)
    t1 = TenantSpec(arrival_times=(2.0, 3.0), request_size_s=0.125)
    rs = resolve_fleet_cell(FleetCell(tenants=(t0, t1), horizon_s=10.0))
    np.testing.assert_array_equal(rs.times, [1.0, 2.0, 2.0, 2.0, 3.0])
    np.testing.assert_array_equal(rs.tids, [0, 0, 0, 1, 1])


def test_1024_tenant_grid_plans_within_the_dispatch_budget():
    """The fleet suite's scale: a 1024-tenant population x 3 admission
    policies plans into <= 8 dispatches (realized on the CPU here; the
    card runs it in chip_smoke.py)."""
    tenants = tenant_population(1024)
    cells = [FleetCell(tenants=tenants, admission=a)
             for a in admission_policy_names()]
    plan = plan_fleet(cells, device=CPU)
    assert plan.n_dispatches <= 8, plan.n_dispatches
    assert len(plan.meta["resolved"]) == 3
    d = plan.dispatches[0]
    assert d.arrays["ta_size"].shape[1] == 1024
    assert len(np.unique(d.arrays["acodes"][:d.n_real])) == 3
