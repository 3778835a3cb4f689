"""Port fault model (`repro_torch.ft`) vs the reference (`repro.ft`).

`failure_u01` must be bit-equal across the reference's numpy and jnp forms
and the port's numpy and torch forms, for seeds, wids and counters that
wrap uint32; `FailureSpec` and its helpers must agree field for field;
and a failure-bearing rate cell must run as its degraded-fleet
equivalent, as the reference's planner runs it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ft import failures as ref
from repro.sim.sweep import SweepCell as RefCell
from repro.sim.sweep import sweep as ref_sweep
from repro_torch.core.workers import DEFAULT_FLEET
from repro_torch.ft import failures as port
from repro_torch.ft.elastic import surviving
from repro_torch.interop import fleet_params
from repro_torch.sim.sweep import SweepCell, sweep
from test_failures import FSPECS
from test_torch_policies import (ENERGIES, N_MAX, assert_matches_golden,
                                 golden_trace)


def _keys(seed: int, n: int = 4096):
    """Seeds, wids and counters over the whole uint32 range, plus values
    past it and below zero, which every form must wrap the same way."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.int64)
    w = rng.integers(0, 2 ** 31, n).astype(np.int64)
    c = rng.integers(-2 ** 33, 2 ** 33, n).astype(np.int64)
    s[:4] = [0, 1, 2 ** 32 - 1, 2 ** 31]
    c[:4] = [0, -1, 2 ** 32, 2 ** 32 + 7]
    return s, w, c


@pytest.mark.parametrize("purpose", [port.DRAW_SPINUP, port.DRAW_CRASH,
                                     port.DRAW_STRAGGLE, port.DRAW_EVAC])
@pytest.mark.parametrize("seed", [0, 1])
def test_failure_u01_bit_equal_across_forms(purpose, seed):
    s, w, c = _keys(seed)
    u32 = np.uint32
    cw = (c & 0xFFFFFFFF).astype(u32)
    want = ref.failure_u01(s.astype(u32), w.astype(u32), cw, purpose)
    forms = {
        "ref_jnp": np.asarray(ref.failure_u01(
            jnp.asarray(s.astype(u32)), jnp.asarray(w.astype(u32)),
            jnp.asarray(cw), purpose, xp=jnp)),
        "port_np": port.failure_u01(s.astype(u32), w.astype(u32), cw, purpose),
        "port_torch": port.failure_u01(torch.tensor(s), torch.tensor(w),
                                       torch.tensor(c), purpose,
                                       xp=torch).numpy(),
        "port_torch_int_counter": port.failure_u01(
            torch.tensor(s), torch.tensor(w), int(c[5]), purpose,
            xp=torch).numpy(),
    }
    want_c5 = ref.failure_u01(s.astype(u32), w.astype(u32), cw[5], purpose)
    for name, got in forms.items():
        exp = want_c5 if name.endswith("int_counter") else want
        assert got.dtype == np.float32, name
        np.testing.assert_array_equal(got.view(np.uint32),
                                      exp.view(np.uint32), err_msg=name)
    hashes = port.failure_hash(torch.tensor(s), torch.tensor(w),
                               torch.tensor(c), purpose, xp=torch).numpy()
    np.testing.assert_array_equal(
        hashes, ref.failure_hash(s.astype(u32), w.astype(u32), cw,
                                 purpose).astype(np.int64))


SPECS = {**FSPECS, "off": ref.FailureSpec(),
         "off_window": ref.FailureSpec(evac_frac=0.5, evac_start_s=10.0,
                                       evac_end_s=10.0)}


def _port_spec(spec):
    return port.FailureSpec(**dataclasses.asdict(spec))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_failure_spec_helpers_match(name):
    r = SPECS[name]
    p = _port_spec(r)
    assert p.enabled == r.enabled
    assert (p.normalized() is None) == (r.normalized() is None)
    assert tuple(p.static_key()) == tuple(r.static_key())
    assert tuple(port.fail_static(p)) == tuple(ref.fail_static(r))
    assert p.floats() == r.floats()
    for k in (0.0, 0.5, 3.0):
        assert dataclasses.asdict(p.scaled(k)) == dataclasses.asdict(r.scaled(k))
    from repro.core.workers import DEFAULT_FLEET as REF_FLEET
    assert fleet_params(r.degrade_fleet(REF_FLEET)) == \
        p.degrade_fleet(DEFAULT_FLEET)
    assert tuple(port.fail_static(None)) == tuple(ref.fail_static(None))


def test_surviving_keeps_order():
    assert surviving([5, 3, 8, 1], lambda i: i % 2 == 0) == [5, 3, 1]


def test_rate_sweep_fluidizes_failures():
    """A failure-bearing rate cell runs as its degraded-fleet equivalent,
    bit for bit, and agrees with the reference's sweep of the same cell on
    the golden trace (counters exact, energies within 1e-5)."""
    tr = golden_trace()
    fs = FSPECS["combined"]
    a = sweep([SweepCell("spork", tr.counts, tr.request_size_s,
                         DEFAULT_FLEET, failures=_port_spec(fs))],
              n_max=N_MAX, device="cpu")
    b = sweep([SweepCell("spork", tr.counts, tr.request_size_s,
                         _port_spec(fs).degrade_fleet(DEFAULT_FLEET))],
              n_max=N_MAX, device="cpu")
    for f, x, y in zip(a.accum._fields, a.accum, b.accum):
        assert np.array_equal(np.asarray(x), np.asarray(y)), f
    assert a.cells[0].failures is None
    from repro.core.workers import DEFAULT_FLEET as REF_FLEET
    r = ref_sweep([RefCell("spork", tr.counts, tr.request_size_s, REF_FLEET,
                           failures=fs)], n_max=N_MAX).totals(0)
    row = {f: getattr(r, f) for f in ("requests", "deadline_misses",
                                      "fpga_spinups", "cpu_spinups",
                                      "retries", "failed_spinups", "crashes",
                                      "recovered_requests", "failure_misses")
           + ENERGIES}
    assert_matches_golden(a.totals(0), row, ("fluidized", "combined"))
