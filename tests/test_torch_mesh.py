"""Port `MeshBackend` and the Figs. 5-7 launcher (`repro_torch.launch.
spork_sim`) vs `LocalBackend` and the reference launcher, on the CPU.

A mesh of two or four CPU "devices" splits each dispatch's cell axis into
shards of 16, 8, 4, 2 and 1 cells, one host thread each; every rate,
event and fleet result is bitwise `LocalBackend`'s, because no cell's
answer depends on the size of its batch. The launcher's grid runs
through plan + execute and equals the reference's `run_grid` on the same
counts: counters exactly, eff/cost and energies within 1e-5."""

import numpy as np
import pytest
import torch

from repro.core.workers import DEFAULT_FLEET as REF_FLEET
from repro.launch import spork_sim as ref_spork_sim
from repro.sim.exec import execute as ref_execute
from repro.sim.plan import plan_sweep as ref_plan_sweep
from repro_torch.core.metrics import RunTotals
from repro_torch.core.workers import DEFAULT_FLEET
from repro_torch.fleet import FleetCell, TenantSpec
from repro_torch.ft.failures import FailureSpec
from repro_torch.launch import spork_sim
from repro_torch.launch.mesh import make_cell_mesh
from repro_torch.sim.events_batched import EventCell
from repro_torch.sim.exec import LocalBackend, MeshBackend, get_backend
from repro_torch.sim.plan import ChunkDispatch
from repro_torch.sim.sweep import sweep_events, sweep_fleet
from test_torch_fleet import FSPEC, KW, QFLEET, dyadic_tenants

CPU = "cpu"
RTOL = 1e-5
FIELDS = RunTotals.FLOAT_FIELDS + RunTotals.COUNT_FIELDS
GRID_POINTS = 8
GRID_HORIZON_S = 300


@pytest.fixture(scope="module")
def grid():
    return spork_sim.sweep_grid(GRID_POINTS, seed=0,
                                horizon_s=GRID_HORIZON_S)


@pytest.fixture(scope="module")
def grid_local(grid):
    counts, _, speeds, busy = grid
    return spork_sim.run_sweep(counts, speeds, busy, device=CPU)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_mesh_rate_grid_bitwise_local(grid, grid_local, n_dev):
    counts, _, speeds, busy = grid
    res = spork_sim.run_sweep(counts, speeds, busy,
                              backend=MeshBackend([CPU] * n_dev))
    assert (res.backend, res.device, res.n_devices) == ("mesh", "cpu", n_dev)
    assert res.dispatch_devices == [n_dev] * res.n_dispatches
    assert grid_local.dispatch_devices == [1] * res.n_dispatches
    for f, a, b in zip(grid_local.accum._fields, grid_local.accum, res.accum):
        assert np.array_equal(a, b), f


def _event_cells():
    rng = np.random.default_rng(3)
    return [EventCell(d, np.sort(rng.uniform(0.0, 60.0, 60)), 0.5,
                      DEFAULT_FLEET, horizon_s=60.0, failures=f)
            for d in ("spork", "round_robin", "index_packing")
            for f in (None, FailureSpec(**FSPEC))]


@pytest.mark.parametrize("n_dev", [2, 4])
def test_mesh_event_plan_bitwise_local(n_dev):
    cells = _event_cells()
    kw = dict(n_max=64, w_fpga=16, w_cpu=32)
    want = sweep_events(cells, device=CPU, **kw)
    got = sweep_events(cells, backend=MeshBackend([CPU] * n_dev), **kw)
    assert got.dispatch_devices == [n_dev] * got.n_dispatches
    for i, (a, b) in enumerate(zip(want, got)):
        for f in FIELDS:
            assert getattr(a, f) == getattr(b, f), (i, f)
        assert a.breakdown == b.breakdown


@pytest.mark.parametrize("n_dev", [2, 4])
def test_mesh_fleet_plan_bitwise_local(n_dev):
    cells = [FleetCell(tenants=dyadic_tenants(TenantSpec, seed=s, n=2 + s),
                       admission=a, fleet=QFLEET, horizon_s=60.0)
             for s in (0, 1) for a in ("admit_all", "interval_quota")]
    want = sweep_fleet(cells, device=CPU, **KW)
    got = sweep_fleet(cells, backend=MeshBackend([CPU] * n_dev), **KW)
    assert got.dispatch_devices == [n_dev] * got.n_dispatches
    for i in range(len(cells)):
        for f in FIELDS:
            assert getattr(want[i], f) == getattr(got[i], f), (i, f)
        assert want.tenants(i) == got.tenants(i)


def test_devices_for_is_the_largest_dividing_power_of_two():
    d = ChunkDispatch(kind="rate", static=(), arrays={}, cell_idx=(0,),
                      chunk=32)
    assert [MeshBackend([CPU] * n).devices_for(d) for n in (1, 2, 3, 4, 8)] \
        == [1, 2, 2, 4, 8]
    assert MeshBackend([CPU] * 8).devices_for(
        ChunkDispatch(kind="event", static=(), arrays={}, cell_idx=(0,),
                      chunk=4)) == 4
    assert LocalBackend(CPU).devices_for(d) == 1


def test_cell_mesh_and_backend_names():
    assert make_cell_mesh([CPU, "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        make_cell_mesh([])
    mesh = get_backend("mesh", CPU)
    assert isinstance(mesh, MeshBackend) and mesh.devices == [
        torch.device("cpu")]
    assert isinstance(get_backend(None, CPU), LocalBackend)
    with pytest.raises(ValueError, match="unknown sweep backend"):
        get_backend("pmap", CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_cell_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            get_backend("mesh")


def test_sweep_grid_draws_the_references_points():
    """Biases, speedups and busy powers are the reference's numpy draws;
    the counts come from the port's numpy b-model, which matches the
    reference's only in distribution."""
    counts, biases, speeds, busy = spork_sim.sweep_grid(16, seed=3,
                                                        horizon_s=120)
    r_counts, r_biases, r_speeds, r_busy = ref_spork_sim.sweep_grid(
        16, seed=3, horizon_s=120)
    for a, b in ((biases, r_biases), (speeds, r_speeds), (busy, r_busy)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert counts.shape == r_counts.shape and counts.dtype == np.int32
    assert abs(counts.mean() / r_counts.mean() - 1.0) < 0.25


def test_run_grid_equals_reference_on_the_same_counts():
    counts, _, speeds, busy = ref_spork_sim.sweep_grid(
        GRID_POINTS, seed=0, horizon_s=GRID_HORIZON_S)
    eff, cost = spork_sim.run_grid(counts, speeds, busy, device=CPU)
    r_eff, r_cost = ref_spork_sim.run_grid(counts, speeds, busy)
    np.testing.assert_allclose(eff, r_eff, rtol=RTOL)
    np.testing.assert_allclose(cost, r_cost, rtol=RTOL)
    got = spork_sim.run_sweep(counts, speeds, busy, device=CPU)
    ref_cells = [ref_spork_sim.SweepCell(
        c.policy, c.counts, c.size_s,
        REF_FLEET.replace(fpga=REF_FLEET.fpga.replace(
            speedup=c.fleet.fpga.speedup, busy_w=c.fleet.fpga.busy_w)))
        for c in spork_sim.grid_cells(counts, speeds, busy)]
    want = ref_execute(ref_plan_sweep(ref_cells, n_max=256))
    for i in range(GRID_POINTS):
        a, b = got.totals(i), want.totals(i)
        for f in RunTotals.COUNT_FIELDS:
            assert getattr(a, f) == getattr(b, f), (i, f)
        for f in RunTotals.FLOAT_FIELDS:
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=RTOL, atol=1e-3,
                                       err_msg=f"{i} {f}")


def test_launcher_main_on_the_cpu(capsys):
    eff, cost = spork_sim.main(["--points", "2", "--horizon", "60",
                                "--backend", "mesh", "--device", CPU])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and lines[0].startswith("point 0: bias=")
    assert np.all(np.isfinite(eff)) and np.all(cost > 0)


def test_production_and_host_meshes_equal_reference():
    """`make_production_mesh` (both values of ``multi_pod``) and
    `make_host_mesh`: shapes and axis names equal the reference's, which
    a subprocess builds over 512 fabricated host devices."""
    import json
    import os
    import subprocess
    import sys

    from repro_torch.launch.mesh import (NVLINK_BW, make_host_mesh,
                                         make_production_mesh)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = ("import json\n"
              "from repro.launch.mesh import make_host_mesh, "
              "make_production_mesh\n"
              "ms = [make_production_mesh(), "
              "make_production_mesh(multi_pod=True), make_host_mesh()]\n"
              "print(json.dumps([[list(m.devices.shape), list(m.axis_names)]"
              " for m in ms]))\n")
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=512"}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=env, cwd=root, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    got = [make_production_mesh(), make_production_mesh(multi_pod=True),
           make_host_mesh()]
    assert [[list(m.devices.shape), list(m.axis_names)] for m in got] == want
    assert got[1].shape == {"pod": 2, "data": 16, "model": 16}
    assert NVLINK_BW == 900e9
