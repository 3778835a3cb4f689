"""Port foundations vs the reference: workers, breakeven, metrics, device.

`repro_torch.core.{workers,breakeven,metrics}` are transliterations of
the reference modules; the fleet-to-scalars mapping and the tensor twin
of the breakeven coefficients (`ratesim.coeffs_in_graph`) must give the
reference's float32 values exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import breakeven as rb
from repro.core import metrics as rm
from repro.core import workers as rw
from repro.sim import ratesim as rr
from repro_torch.core import breakeven as pb
from repro_torch.core import metrics as pm
from repro_torch.core import workers as pw
from repro_torch.device import resolve_device
from repro_torch.sim import ratesim as pr


def _fleets(workers):
    d = workers.DEFAULT_FLEET
    return [d,
            d.replace(fpga=d.fpga.replace(spin_up_s=60.0)),
            d.replace(fpga=d.fpga.replace(speedup=4.0, idle_w=30.0)),
            d.replace(cpu=d.cpu.replace(idle_w=50.0), interval_s=5.0)]


def test_table6_defaults_match_reference():
    for name in ("DEFAULT_CPU", "DEFAULT_FPGA"):
        assert (dataclasses.asdict(getattr(pw, name))
                == dataclasses.asdict(getattr(rw, name)))
    for name in ("FPGA_SPIN_UP_VARIANTS_S", "FPGA_SPEEDUP_VARIANTS",
                 "FPGA_BUSY_W_VARIANTS", "FPGA_IDLE_W_VARIANTS",
                 "CPU_IDLE_W_VARIANTS"):
        assert getattr(pw, name) == getattr(rw, name)
    for p, r in zip(_fleets(pw), _fleets(rw)):
        assert (p.T_s, p.S, p.fpga_idle_timeout_s) == (r.T_s, r.S,
                                                       r.fpga_idle_timeout_s)
        assert p.ideal_energy_j(123.5) == r.ideal_energy_j(123.5)
        assert p.ideal_cost_usd(123.5) == r.ideal_cost_usd(123.5)


@pytest.mark.parametrize("w", [0.0, 0.25, 0.5, 1.0])
def test_breakeven_matches_reference(w):
    for p, r in zip(_fleets(pw), _fleets(rw)):
        assert pb.energy_breakeven_s(p) == rb.energy_breakeven_s(r)
        assert pb.cost_breakeven_s(p) == rb.cost_breakeven_s(r)
        assert pb.weighted_breakeven_s(p, w) == rb.weighted_breakeven_s(r, w)
        tb_p, co_p = pb.objective_setup(p, w)
        tb_r, co_r = rb.objective_setup(r, w)
        assert tb_p == tb_r and tuple(co_p) == tuple(co_r)


def test_fleet_scalars_match_reference():
    for p, r in zip(_fleets(pw), _fleets(rw)):
        want = np.array([float(x) for x in rr.FleetScalars.from_fleet(r)],
                        np.float32)
        np.testing.assert_array_equal(pr.fleet_scalars_np(p), want)
        fs = pr.FleetScalars.from_fleet(p, cells=3, device="cpu")
        assert all(leaf.shape == (3,) and leaf.dtype == torch.float32
                   for leaf in fs)


@pytest.mark.parametrize("w", [0.0, 0.3, 0.5, 1.0])
def test_coeffs_in_graph_matches_reference(w):
    """The per-cell tensor coefficients equal the reference's float32
    in-graph coefficients bit for bit."""
    for p, r in zip(_fleets(pw), _fleets(rw)):
        interval = max(int(round(r.T_s)), 1)
        fs_r = rr.FleetScalars.from_fleet(r)
        co_r, tb_r = rr.coeffs_in_graph(fs_r, interval, fs_r.A_f_s, w)
        fs_p = pr.FleetScalars.from_fleet(p, cells=2, device="cpu")
        co_p, tb_p = pr.coeffs_in_graph(fs_p, interval, fs_p.A_f_s,
                                        torch.full((2,), w))
        for a, b in zip(co_p, co_r):
            np.testing.assert_array_equal(a.numpy(),
                                          np.full(2, np.asarray(b)))
        np.testing.assert_array_equal(tb_p.numpy(),
                                      np.full(2, np.asarray(tb_r)))


def _totals(module, rng):
    t = module.RunTotals()
    for f in module.RunTotals.FLOAT_FIELDS:
        setattr(t, f, float(rng.uniform(1.0, 1e5)))
    for f in module.RunTotals.COUNT_FIELDS:
        setattr(t, f, int(rng.integers(0, 1000)))
    return t


def test_run_totals_merge_finite_and_report_match_reference():
    assert pm.RunTotals.FLOAT_FIELDS == rm.RunTotals.FLOAT_FIELDS
    assert pm.RunTotals.COUNT_FIELDS == rm.RunTotals.COUNT_FIELDS
    a_p, b_p = _totals(pm, np.random.default_rng(0)), _totals(
        pm, np.random.default_rng(1))
    a_r, b_r = _totals(rm, np.random.default_rng(0)), _totals(
        rm, np.random.default_rng(1))
    m_p, m_r = a_p.merge(b_p), a_r.merge(b_r)
    for f in pm.RunTotals.FLOAT_FIELDS + pm.RunTotals.COUNT_FIELDS:
        assert getattr(m_p, f) == getattr(m_r, f), f
    assert m_p.is_finite()
    m_p.energy_j = float("nan")
    assert not m_p.is_finite()
    for p, r in zip(_fleets(pw), _fleets(rw)):
        assert (pm.report(a_p, p, reference_fleet=pw.DEFAULT_FLEET).row()
                == rm.report(a_r, r, reference_fleet=rw.DEFAULT_FLEET).row())


def test_resolve_device(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
