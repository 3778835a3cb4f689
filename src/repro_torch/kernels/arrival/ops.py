"""Wrapper of the hand-written CUDA `arrival` kernel.

Same contract as the reference's `repro.kernels.arrival` kernel (one
block of DES arrivals applied to the engine's carry, bitwise the engine's
own arrival path), batched over a leading cell axis: one launch applies a
block of arrivals to every cell of a chunk.

The device of the chunk's tensors decides the route: on the CPU the plain
PyTorch version (`ref.arrival_block_ref`, the engine's own loop) runs; on
the card the kernel launches, or this raises (also when the carry or the
times lie elsewhere). ``arrival_block.launches`` counts the kernel
launches and nothing else. `bind` packs what one chunk's blocks share
once and returns the per-block step.

The kernel reads the carry as four dtype-grouped tables (`pack_carry`:
``(C, 8, W)`` float32 columns and per-slot accumulators, ``(C, 5, W)``
int32 columns with ``alive`` as 0/1, ``(C, 10)`` int32 and ``(C, 4)``
float32 scalars) and writes new ones, which `unpack_carry` views as an
`EvCarry` again.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.ft.failures import FailStatic
from repro_torch.kernels.build import load_library
from repro_torch.policies.des import BUILTIN_CODES
from repro_torch.sim.events_batched import (FLOAT_FIELDS, EvCarry,
                                            EventScalars, FailAcc,
                                            WorkerTable)

SOURCES = (Path(__file__).resolve().parent / "csrc" / "arrival.cu",)
#: Widest worker table: the kernel runs one warp per cell, 8 slots a lane.
MAX_W = 256

_WF = ("alloc_t", "ready_at", "avail", "busy", "crash_t", "slow")
_WI = ("wid", "level", "n_assign", "nfail")
_SI = ("retries", "failed_spins", "crashes", "recovered", "fail_misses",
       "dropped", "cpu_spins")
_SF = ("wasted_j", "extra_cost", "work_f", "work_c")


@functools.cache
def _launcher():
    fn = load_library("arrival", SOURCES).arrival_launch
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pack_carry(c: EvCarry) -> tuple[torch.Tensor, ...]:
    """`EvCarry` -> the kernel's four contiguous tables (exact)."""
    ws, fl = c.ws, c.fail
    wf32 = torch.stack([getattr(ws, f) for f in _WF]
                       + [c.serv_slot, c.miss_slot], dim=1)
    wi32 = torch.stack([getattr(ws, f) for f in _WI]
                       + [ws.alive.to(torch.int32)], dim=1)
    si32 = torch.stack([c.next_wid, c.rr_pos, c.overflow]
                       + [getattr(fl, f) for f in _SI], dim=1)
    sf32 = torch.stack([getattr(fl, f) for f in _SF], dim=1)
    return wf32, wi32, si32, sf32


def unpack_carry(wf32, wi32, si32, sf32) -> EvCarry:
    """Inverse of `pack_carry`: views into the tables (alive as bool)."""
    ws = WorkerTable(**{f: wf32[:, j] for j, f in enumerate(_WF)},
                     **{f: wi32[:, j] for j, f in enumerate(_WI)},
                     alive=wi32[:, 4] != 0)
    fl = FailAcc(**{f: si32[:, 3 + j] for j, f in enumerate(_SI)},
                 **{f: sf32[:, j] for j, f in enumerate(_SF)})
    return EvCarry(ws=ws, serv_slot=wf32[:, 6], miss_slot=wf32[:, 7],
                   next_wid=si32[:, 0], rr_pos=si32[:, 1],
                   overflow=si32[:, 2], fail=fl)


def pack_cells(es: EventScalars, code) -> tuple[torch.Tensor, ...]:
    """The kernel's per-cell inputs, contiguous, in launch order: the
    ``(C, 31)`` float32 scalar rows, the hash seed's uint32 bits as int32
    and the int32 policy codes."""
    esf = torch.stack([getattr(es, f).to(torch.float32) for f in FLOAT_FIELDS],
                      dim=1)
    seed = es.f_seed.to(torch.int64) & 0xFFFFFFFF
    seed = torch.where(seed >= 2 ** 31, seed - 2 ** 32, seed).to(torch.int32)
    code = torch.as_tensor(code, device=esf.device).to(torch.int32)
    return tuple(x.contiguous() for x in (esf, seed, code.expand(len(esf))))


def bind(es: EventScalars, fstat: FailStatic, code, w_f: int):
    """The arrival-block step of one chunk of cells:
    ``step(c, times, size_deadline=None)`` applies one block of arrivals
    (``times`` ``(C, B)`` float32, +inf padded) to the carry of every
    cell and returns the new carry. ``code`` is the ``(C,)`` dispatch
    policy code. ``size_deadline``, a ``(C, 2)`` float32 tensor, replaces
    each cell's request size and deadline for this block only (the fleet
    engine's per-arrival tenant, as the reference swaps them into its
    scalars with ``es._replace``).

    What is the same for the whole chunk is packed once, here: on the
    card the scalar rows, seed and codes, after one host read that checks
    the codes against the built-in policies the kernel implements; per
    block only the two swapped columns are written, on the device. A
    carry that is the previous block's result is passed on as the
    kernel's own output tables, not packed again."""
    dev = es.size.device
    if dev.type == "cpu":
        from .ref import arrival_block_ref

        def plain(c: EvCarry, times: torch.Tensor,
                  size_deadline: torch.Tensor | None = None) -> EvCarry:
            return arrival_block_ref(_swapped(es, size_deadline), fstat,
                                     code, w_f, c, times)

        return plain
    if dev.type != "cuda":
        raise ValueError(f"arrival: unsupported device {dev}")
    cells_in = pack_cells(es, code)
    extra = sorted(set(cells_in[2].unique().tolist()) - set(BUILTIN_CODES))
    if extra:
        raise NotImplementedError(
            f"arrival kernel: implements the built-in dispatch policies "
            f"{BUILTIN_CODES} only; codes {extra} run on the CPU")
    cells = len(cells_in[0])
    flags = (int(fstat.enabled), int(fstat.max_retries),
             int(fstat.max_failover))
    swap_rows = cells_in[0].clone()     # scalar rows with swapped columns
    last: list = [None, None]           # (carry, its tables) of the last block

    def step(c: EvCarry, times: torch.Tensor,
             size_deadline: torch.Tensor | None = None) -> EvCarry:
        W = c.serv_slot.shape[1]
        if c.serv_slot.shape[0] != cells or times.dim() != 2 \
                or times.shape[0] != cells:
            raise ValueError(f"arrival: carry of {c.serv_slot.shape[0]} and "
                             f"times {tuple(times.shape)} must both have "
                             f"C = {cells} cells")
        if times.dtype != torch.float32:
            raise ValueError("arrival: times must be float32")
        if not 1 <= w_f <= W <= MAX_W:
            raise ValueError(f"arrival: need 1 <= w_f <= W <= {MAX_W}, got "
                             f"w_f={w_f}, W={W}")
        rows = cells_in[0]
        if size_deadline is not None:
            if size_deadline.shape != (cells, 2) \
                    or size_deadline.dtype != torch.float32:
                raise ValueError(f"arrival: size_deadline must be ({cells}, "
                                 f"2) float32")
            rows = swap_rows
            rows[:, :2].copy_(size_deadline)
        tables = last[1] if c is last[0] else pack_carry(c)
        ins = (rows, *cells_in[1:], times.contiguous(), *tables)
        if any(x.device != dev for x in ins):
            raise ValueError("arrival: carry, times and scalars must lie on "
                             "one device")
        outs = tuple(torch.empty_like(x) for x in tables)
        with torch.cuda.device(dev):
            rc = _launcher()(*(x.data_ptr() for x in ins + outs),
                             cells, W, w_f, times.shape[1], *flags,
                             torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"arrival launch failed: CUDA error {rc}")
        arrival_block.launches += 1
        out = unpack_carry(*outs)
        last[:] = [out, outs]
        return out

    return step


def _swapped(es: EventScalars, size_deadline) -> EventScalars:
    """``es`` with the size and deadline of ``size_deadline`` ``(C, 2)``
    (None: unchanged)."""
    if size_deadline is None:
        return es
    return es._replace(size=size_deadline[:, 0], deadline=size_deadline[:, 1])


def arrival_block(es: EventScalars, fstat: FailStatic, code, w_f: int,
                  c: EvCarry, times: torch.Tensor) -> EvCarry:
    """Apply one block of arrivals (``times`` ``(C, B)`` float32, +inf
    padded) to the carry of every cell; ``code`` is the ``(C,)`` dispatch
    policy code. Returns the new carry. A loop over the blocks of one
    chunk calls `bind` once instead."""
    return bind(es, fstat, code, w_f)(c, times)


arrival_block.launches = 0
