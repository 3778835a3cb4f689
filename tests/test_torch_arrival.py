"""Port `arrival` kernel wrapper and plain version vs the reference's
Pallas arrival kernel.

The port's plain version (`kernels/arrival/ref.py::arrival_block_ref`,
the engine's own loop over `_arrival_step` / `_arrival_fail`) is chained
over four arrival blocks from the empty table and must equal the
reference's `arrival_block_pallas` (interpret mode, as the reference's own
tests run it) leaf by leaf after every block: every dispatcher, pristine
and failure-aware, dyadic and continuous streams. The CUDA kernel is held
to the plain version on the card (skipped here without one; `chip_smoke.py`
runs the same check at the main path's shapes).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.kernels.arrival.arrival import arrival_block_pallas
from repro.sim.events import DISPATCHERS
from repro.sim.sweep import EventCell as RefCell
from repro_torch import interop
from repro_torch.ft.failures import FailStatic
from repro_torch.kernels.arrival import ops
from repro_torch.kernels.arrival.ref import arrival_block_ref
from repro_torch.sim.events_batched import FLOAT_FIELDS, init_carry
from test_arrival_kernel import FAIL_SPEC, _carry0, _cell_block_inputs
from test_events_batched import HORIZON, QFLEET, bursty_trace

W_F, W = 16, 48


@functools.cache
def _ref_block():
    """The reference kernel, jitted once per static failure key: the
    dispatch code and the cell's scalars are traced, so every case
    shares one compile."""
    return jax.jit(arrival_block_pallas,
                   static_argnames=("fstat", "w_f", "interpret"))


def _port_inputs(es, code, times):
    """The reference cell's scalars, code and block times as the port's
    batched (C = 1) tensors."""
    es_np = {f: np.asarray(getattr(es, f))[None] for f in es._fields}
    return (interop.event_scalars(es_np, "cpu"),
            torch.tensor([int(code)], dtype=torch.int32),
            torch.tensor(np.asarray(times))[None])


def _assert_carry_equal(ref_c, port_c, tag):
    got = interop.to_numpy(port_c)

    def walk(r, g, path):
        for f in r._fields:
            rv, gv = getattr(r, f), g[f]
            if hasattr(rv, "_fields"):
                walk(rv, gv, f"{path}.{f}")
                continue
            want = np.asarray(rv)
            assert gv.shape[0] == 1, (tag, path, f)
            np.testing.assert_array_equal(gv[0], want,
                                          err_msg=f"{tag} {path}.{f}")
            assert gv.dtype == want.dtype or f in ("f_seed",), (tag, f)

    walk(ref_c, got, "carry")


def assert_blocks_bitmatch(cell, n_blocks=4):
    es, fstat, code, w_f, times = _cell_block_inputs(cell)
    assert (w_f, fstat.enabled) == (W_F, cell.failures is not None)
    pes, pcode, _ = _port_inputs(es, code, times[0])
    pfstat = FailStatic(*fstat)
    cr = _carry0(W)
    cp = init_carry(1, W, "cpu")
    blocks = 0
    for b in range(min(n_blocks, times.shape[0])):
        cr = _ref_block()(es, fstat, code, w_f, cr, times[b], interpret=True)
        cp = arrival_block_ref(pes, pfstat, pcode, w_f, cp,
                               torch.tensor(np.asarray(times[b]))[None])
        _assert_carry_equal(cr, cp, f"block {b}")
        blocks += 1
    assert blocks >= 2


@pytest.mark.parametrize("disp", DISPATCHERS)
@pytest.mark.parametrize("failures", [None, FAIL_SPEC],
                         ids=["pristine", "failures"])
def test_block_bitmatch_dyadic(disp, failures):
    cell = RefCell(disp, bursty_trace(0), 1.0, QFLEET, horizon_s=HORIZON,
                   failures=failures)
    assert_blocks_bitmatch(cell)


@pytest.mark.parametrize("disp", DISPATCHERS)
def test_block_bitmatch_continuous(disp):
    rng = np.random.default_rng(3)
    arr = np.sort(rng.uniform(0.0, HORIZON, 300))
    assert_blocks_bitmatch(RefCell(disp, arr, 0.7310585, QFLEET,
                                   horizon_s=HORIZON))


def test_block_bitmatch_continuous_failures():
    rng = np.random.default_rng(4)
    arr = np.sort(rng.uniform(0.0, HORIZON, 300))
    assert_blocks_bitmatch(RefCell("spork", arr, 0.7310585, QFLEET,
                                   horizon_s=HORIZON, failures=FAIL_SPEC))


def test_cells_of_mixed_policies_batch_like_single_cells():
    """One batched call over three cells of different policies (and a
    padded repeat of cell 0) equals each cell run alone."""
    arr = bursty_trace(2)
    ins = [_cell_block_inputs(RefCell(d, arr, 1.0, QFLEET,
                                      horizon_s=HORIZON))
           for d in DISPATCHERS]
    rows = [_port_inputs(es, code, times[0]) for es, _, code, _, times in ins]
    rows.append(rows[0])
    es = type(rows[0][0])(*(torch.cat([r[0][j] for r in rows])
                            for j in range(len(rows[0][0]))))
    code = torch.cat([r[1] for r in rows])
    fstat = FailStatic(False, 0, 0)
    c = init_carry(len(rows), W, "cpu")
    singles = [init_carry(1, W, "cpu") for _ in rows]
    for b in range(3):
        times = torch.stack([torch.tensor(np.asarray(x[4][b]))
                             for x in ins + ins[:1]])
        c = arrival_block_ref(es, fstat, code, W_F, c, times)
        for k, r in enumerate(rows):
            singles[k] = arrival_block_ref(r[0], fstat, r[1], W_F,
                                           singles[k], times[k:k + 1])
    got = interop.to_numpy(c)
    for k, s in enumerate(singles):
        want = interop.to_numpy(s)
        for f in ("serv_slot", "miss_slot", "next_wid", "rr_pos"):
            np.testing.assert_array_equal(got[f][k], want[f][0], err_msg=f)
        for f, v in want["ws"].items():
            np.testing.assert_array_equal(got["ws"][f][k], v[0], err_msg=f)


def test_pack_unpack_roundtrip_and_cpu_route():
    c = init_carry(3, W, "cpu")
    c = c._replace(next_wid=torch.tensor([5, 0, 9], dtype=torch.int32),
                   ws=c.ws._replace(alive=torch.arange(3 * W).reshape(3, W)
                                    % 3 == 0,
                                    busy=torch.rand(3, W)))
    back = ops.unpack_carry(*ops.pack_carry(c))
    a, b = interop.to_numpy(c), interop.to_numpy(back)
    for f in ("next_wid", "rr_pos", "serv_slot"):
        np.testing.assert_array_equal(a[f], b[f])
    for f in a["ws"]:
        assert a["ws"][f].dtype == b["ws"][f].dtype, f
        np.testing.assert_array_equal(a["ws"][f], b["ws"][f], err_msg=f)
    assert len(FLOAT_FIELDS) == 31          # the kernel's scalar row
    es, fstat, code, w_f, times = _cell_block_inputs(
        RefCell("spork", bursty_trace(0), 1.0, QFLEET, horizon_s=HORIZON))
    pes, pcode, t0 = _port_inputs(es, code, times[0])
    before = ops.arrival_block.launches
    out = ops.arrival_block(pes, FailStatic(False, 0, 0), pcode, w_f,
                            init_carry(1, W, "cpu"), t0)
    assert ops.arrival_block.launches == before     # plain version, no launch
    assert int(out.next_wid[0]) > 0


def test_cuda_kernel_matches_plain_version():
    """The hand-written kernel against its plain version on the card,
    pristine and failure-aware, chained over blocks (needs a CUDA card and
    nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for failures in (None, FAIL_SPEC):
        es, fstat, code, w_f, times = _cell_block_inputs(
            RefCell("round_robin", bursty_trace(0), 1.0, QFLEET,
                    horizon_s=HORIZON, failures=failures))
        pes, pcode, _ = _port_inputs(es, code, times[0])
        fs = FailStatic(*fstat)
        pes_d = type(pes)(*(x.cuda() for x in pes))
        ck = cp = init_carry(1, W, "cuda")
        for b in range(3):
            tb = torch.tensor(np.asarray(times[b]))[None].cuda()
            before = ops.arrival_block.launches
            ck = ops.arrival_block(pes_d, fs, pcode.cuda(), w_f, ck, tb)
            assert ops.arrival_block.launches == before + 1
            cp = arrival_block_ref(pes_d, fs, pcode.cuda(), w_f, cp, tb)
            a, p = interop.to_numpy(ck), interop.to_numpy(cp)
            for f in ("serv_slot", "miss_slot", "next_wid", "rr_pos",
                      "overflow"):
                np.testing.assert_array_equal(a[f], p[f], err_msg=f)
            for group in ("ws", "fail"):
                for f in a[group]:
                    np.testing.assert_array_equal(a[group][f], p[group][f],
                                                  err_msg=f)
