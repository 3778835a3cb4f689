"""Port serving layer (`repro_torch.serve`, `repro_torch.launch.serve`) vs
the reference (`repro.serve`) on the CPU.

The engines run `qwen3-0.6b` at smoke width in float32 with the
reference's weights carried across (`repro_torch.interop.model_params`);
token streams must be identical and the caches equal to 1e-5 (float32
sums in another order). The router's request size divides by the card's
memory rate (`repro_torch.launch.mesh.HBM_BW`), so the reference module's
``HBM_BW`` is set to the same value for the comparison (an attribute
patched at run time, no reference file edited); the routers then run the
same arrival times: counters identical, floats within 1e-5. The
multi-tenant `TenantRouter`, submitted request by request, equals the
batch `simulate_fleet` and the reference's `TenantRouter` on the same
stream, and refuses an out-of-order submit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve.router as ref_router
from repro.configs import get_config as ref_config
from repro.core.traces import synthetic_trace
from repro.models import build_model as ref_build
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.launch import mesh
from repro_torch.launch.serve import main
from repro_torch.models import Model
from repro_torch.serve import router
from repro_torch.serve.engine import Request, ServeEngine

KEY = jax.random.PRNGKey(3)
ARCH = "qwen3-0.6b"
PA = np.array([5, 11, 7, 2], np.int32)
PB = np.array([13, 3, 9], np.int32)


@pytest.fixture(scope="module")
def models():
    rm = ref_build(ref_config(ARCH, "smoke").replace(dtype=jnp.float32))
    params = rm.init(KEY)
    cfg = get_config(ARCH, "smoke").replace(dtype=torch.float32)
    m = Model(cfg, "cpu")
    m.load_state_dict(interop.model_params(jax.tree.map(np.asarray, params),
                                           cfg, "cpu"))
    return rm, params, m


def _interleaved(eng, request):
    """tests/test_serve.py's schedule: admit A, decode 2 tokens, admit B
    while A is active, decode both to the end."""
    assert eng.add_request(request(rid=0, prompt=PA, max_new_tokens=6))
    got = {0: [], 1: []}
    for _ in range(2):
        for rid, tok in eng.step():
            got[rid].append(tok)
    assert eng.add_request(request(rid=1, prompt=PB, max_new_tokens=4))
    while eng.n_active:
        for rid, tok in eng.step():
            got[rid].append(tok)
    return got


def _alone(eng, prompt, n_new):
    assert eng.add_request(Request(rid=0, prompt=prompt,
                                   max_new_tokens=n_new))
    toks = []
    while eng.n_active:
        toks.extend(t for _, t in eng.step())
    return toks


def test_engine_streams_and_cache_match_reference(models):
    rm, params, m = models
    ref = RefEngine(rm, params, batch_slots=3, max_len=32)
    want = _interleaved(ref, RefRequest)
    eng = ServeEngine(m, batch_slots=3, max_len=32)
    got = _interleaved(eng, Request)
    assert got == want
    # the cache after every request finished: lanes written only while
    # their slot was active, in both engines
    np.testing.assert_array_equal(eng.cache["length"].numpy(),
                                  np.asarray(ref.cache["length"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(eng.cache["kv"][name].numpy(),
                                   np.asarray(ref.cache["kv"][name]),
                                   rtol=1e-5, atol=1e-5)


def test_interleaved_prefill_does_not_corrupt_active_slots(models):
    """A's and B's streams equal their run-alone streams."""
    m = models[2]
    got = _interleaved(ServeEngine(m, batch_slots=3, max_len=32), Request)
    assert got[0] == _alone(ServeEngine(m, 3, 32), PA, 6)
    assert got[1] == _alone(ServeEngine(m, 3, 32), PB, 4)


def test_slot_reuse_after_completion(models):
    m = models[2]
    ref = _alone(ServeEngine(m, 1, 32), PB, 3)
    eng = ServeEngine(m, batch_slots=1, max_len=32)
    assert eng.add_request(Request(rid=0, prompt=PA, max_new_tokens=2))
    while eng.n_active:
        eng.step()
    assert eng.free_slots() == 1
    assert _alone(eng, PB, 3) == ref


def test_admission_free_and_deadline_bookkeeping(models):
    eng = ServeEngine(models[2], batch_slots=2, max_len=32)
    p = np.array([1, 2], np.int32)
    r0 = Request(rid=10, prompt=p, max_new_tokens=50, deadline_s=5.0)
    r1 = Request(rid=11, prompt=p, max_new_tokens=2, deadline_s=100.0)
    assert eng.add_request(r0) and eng.add_request(r1)
    assert eng.free_slots() == 0
    assert not eng.add_request(Request(rid=12, prompt=p, max_new_tokens=1))
    eng.step()
    eng.step()
    assert r1.done and eng.free_slots() == 1
    assert eng.expire(now_s=6.0) == [10]
    assert not r0.done
    assert eng.free_slots() == 2
    assert eng.expire(now_s=6.0) == []


def test_batch_axes_are_found_structurally(models):
    eng = ServeEngine(models[2], batch_slots=2, max_len=8)
    assert eng._axes == {"length": 0, "kv": {"k": 1, "v": 1}}


@pytest.fixture
def card_bw(monkeypatch):
    monkeypatch.setattr(ref_router, "HBM_BW", mesh.HBM_BW)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen3-32b",
                                  "deepseek-v3-671b"])
def test_service_model_matches_reference_at_the_card_rate(card_bw, arch):
    assert router.analytic_token_latency(arch) == \
        ref_router.analytic_token_latency(arch)
    fleet, size = router.fleet_for_arch(arch, avg_new_tokens=64,
                                        dryrun_dir="/nonexistent")
    rfleet, rsize = ref_router.fleet_for_arch(arch, avg_new_tokens=64,
                                              dryrun_dir="/nonexistent")
    assert size == rsize
    assert dataclasses.asdict(fleet) == dataclasses.asdict(rfleet)


def test_roofline_record_overrides_the_analytic_latency(monkeypatch,
                                                       tmp_path):
    monkeypatch.setattr(ref_router, "HBM_BW", mesh.HBM_BW)
    monkeypatch.setattr(ref_router, "PEAK_FLOPS_BF16", mesh.PEAK_FLOPS_BF16)
    rec = tmp_path / f"{ARCH}__decode_32k__single.json"
    rec.write_text('{"ok": true, "hlo_flops": 3.0e15, "hlo_bytes": 2.0e12}')
    got = router.roofline_token_latency(ARCH, tmp_path)
    assert got == ref_router.roofline_token_latency(ARCH, tmp_path)
    assert got == max(3.0e15 / mesh.PEAK_FLOPS_BF16, 2.0e12 / mesh.HBM_BW) \
        / 128
    assert router.service_model(ARCH, dryrun_dir=tmp_path).token_s_accel \
        == got
    assert router.roofline_token_latency(ARCH, tmp_path / "none") is None


def test_analytic_latency_ordering():
    small = router.analytic_token_latency("qwen3-0.6b")
    big = router.analytic_token_latency("qwen3-32b")
    moe = router.analytic_token_latency("deepseek-v3-671b")
    assert small < moe < 100 * big and small < big


def test_spork_router_matches_reference(card_bw):
    """The same arrival times through both routers, 120 s."""
    horizon = 120
    ref = ref_router.SporkRouter(ARCH, horizon_s=horizon,
                                 dryrun_dir="/nonexistent")
    port = router.SporkRouter(ARCH, horizon_s=horizon,
                              dryrun_dir="/nonexistent", device="cpu")
    assert port.size_s == ref.size_s
    tr = synthetic_trace(seed=2, bias=0.6, horizon_s=horizon,
                         request_size_s=ref.size_s, mean_demand_workers=3.0)
    for t in tr.arrival_times(seed=3):
        ref.submit(float(t))
        port.submit(float(t))
    want, got = ref.finish(), port.finish()
    assert got.totals.requests == want.totals.requests > 1000
    for f in dataclasses.fields(want.totals):
        a, b = getattr(got.totals, f.name), getattr(want.totals, f.name)
        if isinstance(b, int):
            assert a == b, f.name
        else:
            assert a == pytest.approx(b, rel=1e-5, abs=1e-9), f.name
    assert got.energy_efficiency == pytest.approx(want.energy_efficiency,
                                                  rel=1e-5)
    assert got.deadline_miss_rate == want.deadline_miss_rate


def test_serve_main_runs_on_the_cpu(capsys):
    out = main(["--minutes", "0.5", "--rate", "5", "--engine-requests", "2",
                "--new-tokens", "3", "--device", "cpu"])
    assert out["emitted"] == 6 and out["requests"] > 0
    assert 0.0 < out["report"].energy_efficiency <= 1.0
    assert "[engine] decoded 6 tokens" in capsys.readouterr().out


def _tenant_cell(admission):
    """One 3-tenant cell for the port and its reference twin; admission
    ``(name, knobs)`` starved enough to shed."""
    import repro.policies.admission as ref_adm
    import repro_torch.policies.admission as port_adm
    from repro.fleet import FleetCell as RefCell, TenantSpec as RefTenant
    from repro_torch.fleet import FleetCell, TenantSpec
    cls, knobs = admission
    rng = np.random.default_rng(2)
    specs = [(tuple(np.sort(rng.integers(0, 60 * 8, 100)) / 8.0), s, slo, w)
             for s, slo, w in ((0.125, "tight", 2.0), (0.25, "standard", 1.0),
                               (0.125, "relaxed", 0.5))]

    def cell(cell_cls, tenant_cls, module):
        return cell_cls(tenants=tuple(
            tenant_cls(arrival_times=a, request_size_s=s, slo=slo, weight=w)
            for a, s, slo, w in specs),
            admission=getattr(module, cls)(**knobs), horizon_s=60.0)

    return cell(FleetCell, TenantSpec, port_adm), cell(RefCell, RefTenant,
                                                       ref_adm)


@pytest.mark.parametrize("admission", [
    ("TokenBucket", {"rate": 0.5, "burst": 2.0}),
    ("IntervalQuota", {"quota": 4.0})], ids=["token_bucket", "quota"])
def test_tenant_router_online_matches_batch_and_reference(admission):
    """Request-by-request `TenantRouter` submission reproduces the batch
    fleet simulation exactly (admission decisions, totals, per-tenant
    rows), and the reference's router on the same stream."""
    from repro.serve.router import TenantRouter as RefRouter
    from repro_torch.fleet import resolve_fleet_cell, simulate_fleet
    cell, ref_cell = _tenant_cell(admission)
    bt, brows = simulate_fleet(cell, n_max=64, device="cpu")

    tr = router.TenantRouter(cell, n_max=64, device="cpu")
    ref = RefRouter(ref_cell, n_max=64)
    rs = resolve_fleet_cell(cell)
    admitted = 0
    for t, tid in zip(rs.times, rs.tids):
        got = tr.submit(float(t), int(tid))
        assert got == ref.submit(float(t), int(tid))
        admitted += got
    rep, rows = tr.finish()
    ref_rep, ref_rows = ref.finish()
    assert admitted == bt.requests == rep.totals.requests
    assert bt.breakdown["shed_requests"] > 0
    assert rep.totals.deadline_misses == bt.deadline_misses
    assert rep.totals.energy_j == bt.energy_j
    for ra, rb in zip(rows, brows):
        assert ra.row() == rb.row()
    assert rep.row() == ref_rep.row()
    for f in ("requests", "deadline_misses", "fpga_spinups", "cpu_spinups"):
        assert getattr(rep.totals, f) == getattr(ref_rep.totals, f), f
    np.testing.assert_allclose(rep.totals.energy_j, ref_rep.totals.energy_j,
                               rtol=1e-5)
    for ra, rb in zip(rows, ref_rows):
        assert ra.row() == rb.row()


def test_tenant_router_rejects_out_of_order_submit():
    """Submissions arrive in merged time order across tenants; a t behind
    the router clock raises instead of running admission against the
    wrong bucket state."""
    from repro_torch.fleet import FleetCell, TenantSpec
    tenants = (TenantSpec(arrival_times=(1.0, 2.0), request_size_s=0.125),
               TenantSpec(arrival_times=(0.5,), request_size_s=0.125))
    cell = FleetCell(tenants=tenants, admission="token_bucket",
                     horizon_s=60.0)
    tr = router.TenantRouter(cell, device="cpu")
    assert tr.submit(1.0, 0)
    with pytest.raises(ValueError, match="out-of-order"):
        tr.submit(0.5, 1)          # tenant 1's arrival is in the past
    assert tr.submit(2.0, 0)       # clock still consistent afterwards
    tr.advance(30.0)
    rep, rows = tr.finish()
    assert rep.totals.requests == 2 and len(rows) == 2


# ------------------------------------------------------- hybrid family

HYBRID = "recurrentgemma-2b"


@pytest.fixture(scope="module")
def hybrid_models():
    rm = ref_build(ref_config(HYBRID, "smoke").replace(dtype=jnp.float32))
    params = rm.init(KEY)
    cfg = get_config(HYBRID, "smoke").replace(dtype=torch.float32)
    m = Model(cfg, "cpu")
    m.load_state_dict(interop.model_params(jax.tree.map(np.asarray, params),
                                           cfg, "cpu"))
    return rm, params, m


def _lane(cache, axes, slot):
    """One slot's lane of every cache leaf (cloned)."""
    if isinstance(cache, dict):
        return {k: _lane(cache[k], axes[k], slot) for k in cache}
    return cache.narrow(axes, slot, 1).clone()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def test_hybrid_engine_streams_and_cache_match_reference(hybrid_models):
    """recurrentgemma-2b (smoke, window 16) under tests/test_serve.py's
    schedule: the same token streams as the reference engine; the cache
    after both finished (recurrent state, ring, lengths) within 1e-5."""
    rm, params, m = hybrid_models
    ref = RefEngine(rm, params, batch_slots=3, max_len=32)
    want = _interleaved(ref, RefRequest)
    eng = ServeEngine(m, batch_slots=3, max_len=32)
    got = _interleaved(eng, Request)
    assert got == want
    assert eng._axes == {"length": 0, "conv": 2, "h": 2,
                         "kv": {"k": 1, "v": 1}, "tail_conv": 2,
                         "tail_h": 2}
    np.testing.assert_array_equal(eng.cache["length"].numpy(),
                                  np.asarray(ref.cache["length"]))
    ref_leaves = dict(_leaves(ref.cache))
    for name, leaf in _leaves(eng.cache):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(ref_leaves[name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_hybrid_interleaved_admission_equals_alone(hybrid_models):
    """A's and B's streams equal their run-alone streams, and B's prefill
    leaves A's lane (recurrent state, ring, length) and the unused slot's
    lane bitwise as they were."""
    m = hybrid_models[2]
    eng = ServeEngine(m, batch_slots=3, max_len=32)
    assert eng.add_request(Request(rid=0, prompt=PA, max_new_tokens=6))
    got = {0: [], 1: []}
    for _ in range(2):
        for rid, tok in eng.step():
            got[rid].append(tok)
    a_lane, idle = (_lane(eng.cache, eng._axes, s) for s in (0, 2))
    assert eng.add_request(Request(rid=1, prompt=PB, max_new_tokens=4))
    for (name, before), (_, after) in zip(
            _leaves(a_lane), _leaves(_lane(eng.cache, eng._axes, 0))):
        assert torch.equal(before, after), name
    while eng.n_active:
        for rid, tok in eng.step():
            got[rid].append(tok)
    for (name, before), (_, after) in zip(
            _leaves(idle), _leaves(_lane(eng.cache, eng._axes, 2))):
        assert torch.equal(before, after) and not after.any(), name
    assert got[0] == _alone(ServeEngine(m, 3, 32), PA, 6)
    assert got[1] == _alone(ServeEngine(m, 3, 32), PB, 4)


def test_serve_main_runs_the_hybrid_on_the_cpu(capsys):
    out = main(["--arch", HYBRID, "--minutes", "0.5", "--rate", "5",
                "--engine-requests", "2", "--new-tokens", "3",
                "--device", "cpu"])
    assert out["emitted"] == 6 and out["requests"] > 0
    assert "[engine] decoded 6 tokens" in capsys.readouterr().out


# ------------------------------------- encoder-decoder and VLM families

def _family_models(arch):
    rm = ref_build(ref_config(arch, "smoke").replace(dtype=jnp.float32))
    params = rm.init(KEY)
    cfg = get_config(arch, "smoke").replace(dtype=torch.float32)
    m = Model(cfg, "cpu")
    m.load_state_dict(interop.model_params(jax.tree.map(np.asarray, params),
                                           cfg, "cpu"))
    return rm, params, m


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-76b"])
def test_frontend_family_engine_streams_and_cache_match_reference(arch):
    """The engines take no frontend, in both packages: an encdec request
    decodes against the zero memory its slot was reset to (the reference's
    caveat, kept). Under tests/test_serve.py's schedule the streams equal
    the reference engine's and every cache leaf (mem_k/mem_v zero) is
    within 1e-5."""
    rm, params, m = _family_models(arch)
    ref = RefEngine(rm, params, batch_slots=3, max_len=32)
    want = _interleaved(ref, RefRequest)
    eng = ServeEngine(m, batch_slots=3, max_len=32)
    got = _interleaved(eng, Request)
    assert got == want
    ref_leaves = dict(_leaves(jax.tree.map(np.asarray, ref.cache)))
    port_leaves = dict(_leaves(eng.cache))
    assert sorted(port_leaves) == sorted(ref_leaves)
    for name, leaf in port_leaves.items():
        np.testing.assert_allclose(leaf.numpy(), ref_leaves[name],
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    if arch == "whisper-base":
        assert eng._axes["mem_k"] == eng._axes["mem_v"] == 1
        assert not eng.cache["mem_k"].any() and not eng.cache["mem_v"].any()


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-76b"])
def test_serve_main_runs_the_frontend_families_on_the_cpu(arch, capsys):
    out = main(["--arch", arch, "--minutes", "0.5", "--rate", "5",
                "--engine-requests", "2", "--new-tokens", "3",
                "--device", "cpu"])
    assert out["emitted"] == 6 and out["requests"] > 0
    assert "[engine] decoded 6 tokens" in capsys.readouterr().out


# ------------------------------------------------------ MoE family

@pytest.mark.parametrize("arch,slots", [("dbrx-132b", 48),
                                        ("deepseek-v3-671b", 64)])
def test_moe_engine_streams_and_cache_match_reference(arch, slots):
    """dbrx (GQA) and deepseek-v3 (dense layers, then MLA) under
    tests/test_serve.py's schedule in 48 and 64 slots, where a decode
    step's routing rows hold 3 and 2 tokens, idle lanes among them: the
    same token streams as the reference engine, and every cache leaf
    (``moe_kv`` / ``dense_kv``, ``ckv``, ``kpe``, ``length``) within 1e-5
    after both finished."""
    rm, params, m = _family_models(arch)
    ref = RefEngine(rm, params, batch_slots=slots, max_len=16)
    want = _interleaved(ref, RefRequest)
    eng = ServeEngine(m, batch_slots=slots, max_len=16)
    got = _interleaved(eng, Request)
    assert got == want
    ref_leaves = dict(_leaves(jax.tree.map(np.asarray, ref.cache)))
    port_leaves = dict(_leaves(eng.cache))
    assert sorted(port_leaves) == sorted(ref_leaves)
    for name, leaf in port_leaves.items():
        np.testing.assert_allclose(leaf.numpy(), ref_leaves[name],
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    assert all(ax == (0 if name == "length" else 1)
               for name, ax in _leaves(eng._axes))


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v3-671b"])
def test_serve_main_runs_the_moe_family_on_the_cpu(arch, capsys):
    out = main(["--arch", arch, "--minutes", "0.5", "--rate", "5",
                "--engine-requests", "2", "--new-tokens", "3",
                "--device", "cpu"])
    assert out["emitted"] == 6 and out["requests"] > 0
    assert "[engine] decoded 6 tokens" in capsys.readouterr().out


# ------------------------------------------------------------ SSM family

SSM = "mamba2-2.7b"


def test_ssm_engine_streams_and_cache_match_reference():
    """mamba2-2.7b (smoke) under tests/test_serve.py's schedule: the same
    token streams as the reference engine, and every cache leaf (``conv``,
    ``ssm``, ``length``) within 1e-5 after both finished; the recurrent
    leaves' batch axis is 1."""
    rm, params, m = _family_models(SSM)
    ref = RefEngine(rm, params, batch_slots=3, max_len=32)
    want = _interleaved(ref, RefRequest)
    eng = ServeEngine(m, batch_slots=3, max_len=32)
    got = _interleaved(eng, Request)
    assert got == want
    assert eng._axes == {"length": 0, "conv": 1, "ssm": 1}
    ref_leaves = dict(_leaves(jax.tree.map(np.asarray, ref.cache)))
    port_leaves = dict(_leaves(eng.cache))
    assert sorted(port_leaves) == sorted(ref_leaves)
    for name, leaf in port_leaves.items():
        np.testing.assert_allclose(leaf.numpy(), ref_leaves[name],
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_ssm_interleaved_admission_and_slot_reuse():
    """B's prefill leaves A's recurrent lanes bitwise, both streams equal
    their run-alone streams, and a freed slot admits a request with blank
    state (tests/test_serve.py's slot-reuse case, on the ssm family)."""
    m = _family_models(SSM)[2]
    eng = ServeEngine(m, batch_slots=3, max_len=32)
    assert eng.add_request(Request(rid=0, prompt=PA, max_new_tokens=6))
    got = {0: [], 1: []}
    for _ in range(2):
        for rid, tok in eng.step():
            got[rid].append(tok)
    a_lane = _lane(eng.cache, eng._axes, 0)
    assert eng.add_request(Request(rid=1, prompt=PB, max_new_tokens=4))
    for (name, before), (_, after) in zip(
            _leaves(a_lane), _leaves(_lane(eng.cache, eng._axes, 0))):
        assert torch.equal(before, after), name
    while eng.n_active:
        for rid, tok in eng.step():
            got[rid].append(tok)
    assert got[0] == _alone(ServeEngine(m, 3, 32), PA, 6)
    assert got[1] == _alone(ServeEngine(m, 3, 32), PB, 4)
    one = ServeEngine(m, batch_slots=1, max_len=32)
    assert one.add_request(Request(rid=0, prompt=PA, max_new_tokens=2))
    while one.n_active:
        one.step()
    assert _alone(one, PB, 3) == _alone(ServeEngine(m, 1, 32), PB, 3)


def test_serve_main_runs_the_ssm_on_the_cpu(capsys):
    out = main(["--arch", SSM, "--minutes", "0.5", "--rate", "5",
                "--engine-requests", "2", "--new-tokens", "3",
                "--device", "cpu"])
    assert out["emitted"] == 6 and out["requests"] > 0
    assert "[engine] decoded 6 tokens" in capsys.readouterr().out
