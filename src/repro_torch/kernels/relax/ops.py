"""Wrappers of the hand-written CUDA `relax` kernels and the autograd
function that joins them.

`relax_forward(theta, demand, consts)` computes the relaxation's cost and
saves, per interval, n, delta and w; `relax_backward(...)` composes the
adjoint's affine maps over the intervals (a scan) and returns grad_out *
dcost/dtheta.
`relaxed_cost(theta, demand, consts)` is the `torch.autograd.Function`
over the two: one forward launch gives the cost, one backward launch its
gradient. theta (3,) and demand (K,) are float32 or float64, of one type.

The tensor's device decides the route: a CPU tensor goes to the plain
PyTorch version (`ref.relax_loop`, and autograd through it for the
reverse pass); a CUDA tensor launches the kernel, or this raises.
``relax_forward.launches`` and ``relax_backward.launches`` count the
calls that launched, and nothing else.

Sums: the forward kernel adds the interval costs in double, each thread
its intervals and then across the block (warp shuffles, then one pass
over the warps), and rounds once; the reverse composes the adjoint's
affine maps and adds the three gradient sums in double the same way.
The plain version sums the stacked costs with ``torch.sum`` (pairwise) in
the working type. In float32 the two sums of the same 720 costs differ by
a few units in the last place, and the recurrence's own rounding (fused
multiply-adds and, on the chain, the MUFU exp and reciprocal on the card)
by more; the checks hold them to rtol 1e-5 in float32 and 1e-10 in
float64.

``chain_cycles`` times the forward bound's chain alone on the card (one
thread, no memory traffic): the shortest float32 sequence from n to n_new
that meets the contract, fixed in the source apart from the kernel's own.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library

from .ref import relax_grad_ref, relax_loop

SOURCES = (Path(__file__).resolve().parent / "csrc" / "relax.cu",)
_DTYPES = {torch.float32: 0, torch.float64: 1}


@functools.cache
def _library():
    lib = load_library("relax", SOURCES)
    for name, pointers in (("relax_forward_launch", 6),
                           ("relax_backward_launch", 7)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * pointers
                       + [ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_double] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.relax_chain_bench_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_double] * 5
        + [ctypes.c_void_p])
    lib.relax_chain_bench_launch.restype = ctypes.c_int
    return lib


def _check(theta: torch.Tensor, demand: torch.Tensor, *more: torch.Tensor):
    if theta.dtype not in _DTYPES or any(t.dtype != theta.dtype
                                         for t in (demand, *more)):
        raise ValueError(f"relax: theta, demand and the saved buffers must "
                         f"be all float32 or all float64, got {theta.dtype}, "
                         f"{demand.dtype}")
    if theta.shape != (3,) or demand.dim() != 1 or demand.shape[0] < 1:
        raise ValueError(f"relax: need theta (3,) and demand (K,), K >= 1, "
                         f"got {tuple(theta.shape)}, {tuple(demand.shape)}")
    if any(t.device != theta.device for t in (demand, *more)):
        raise ValueError("relax: tensors on different devices")


def _consts(consts) -> list[float]:
    if len(consts) != 7:
        raise ValueError(f"relax: need 7 constants, got {len(consts)}")
    return [float(x) for x in consts]


def relax_forward(theta: torch.Tensor, demand: torch.Tensor, consts):
    """(cost (), n (K,), delta (K,), w (K,)) in theta's type; ``consts``
    is (interval_s, spin_up_s, S, I_f, B_f, miss_weight, sharp)."""
    _check(theta, demand)
    if theta.device.type == "cpu":
        with torch.no_grad():
            return relax_loop(theta, demand, consts)
    if theta.device.type != "cuda":
        raise ValueError(f"relax: unsupported device {theta.device}")
    theta, demand = theta.detach().contiguous(), demand.contiguous()
    k = demand.shape[0]
    cost = torch.empty((), dtype=theta.dtype, device=theta.device)
    saved = torch.empty((3, k), dtype=theta.dtype, device=theta.device)
    with torch.cuda.device(theta.device):
        rc = _library().relax_forward_launch(
            demand.data_ptr(), theta.data_ptr(), cost.data_ptr(),
            *(row.data_ptr() for row in saved), k, _DTYPES[theta.dtype],
            *_consts(consts), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"relax_forward launch failed: CUDA error {rc}")
    relax_forward.launches += 1
    return cost, saved[0], saved[1], saved[2]


def relax_backward(theta: torch.Tensor, demand: torch.Tensor, consts,
                   saved, grad_out: torch.Tensor) -> torch.Tensor:
    """grad_out * dcost/dtheta (3,) from the forward's ``saved`` (n,
    delta, w); on the CPU by autograd through the plain loop."""
    n, delta, w = saved
    _check(theta, demand, n, delta, w)
    if theta.device.type == "cpu":
        return relax_grad_ref(theta, demand, consts, grad_out)
    if theta.device.type != "cuda":
        raise ValueError(f"relax: unsupported device {theta.device}")
    theta, demand = theta.detach().contiguous(), demand.contiguous()
    grad_out = grad_out.to(theta.dtype).reshape(()).contiguous()
    out = torch.empty(3, dtype=theta.dtype, device=theta.device)
    with torch.cuda.device(theta.device):
        rc = _library().relax_backward_launch(
            demand.data_ptr(), theta.data_ptr(),
            *(t.contiguous().data_ptr() for t in (n, delta, w)),
            grad_out.data_ptr(), out.data_ptr(), demand.shape[0],
            _DTYPES[theta.dtype], *_consts(consts),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"relax_backward launch failed: CUDA error {rc}")
    relax_backward.launches += 1
    return out


relax_forward.launches = 0
relax_backward.launches = 0


# the chain microbenchmark's targets: FPGA counts like the fast grid's
_CHAIN_TARGETS = (50.0, 52.0)


def chain_cycles(k: int, consts) -> float:
    """SM cycles (clock64) of one interval of the forward bound's float32
    chain (delta, w = sigmoid(sharp delta), n_new; five dependent
    operations, see `relax_chain_bench_kernel`), walked ``k`` times by one
    thread on the card from registers, the target alternating between two
    values. Not a path's kernel, so no launch is counted."""
    interval_s, spin_up_s, *_, sharp = _consts(consts)
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    sink = torch.empty(1, dtype=torch.float32, device="cuda")
    rc = _library().relax_chain_bench_launch(
        cycles.data_ptr(), sink.data_ptr(), k, *_CHAIN_TARGETS, interval_s,
        spin_up_s, sharp, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"relax chain_cycles launch failed: CUDA error "
                           f"{rc}")
    return int(cycles.item()) / k


class _Relax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, theta, demand, consts):
        cost, n, delta, w = relax_forward(theta, demand, consts)
        ctx.save_for_backward(theta, demand, n, delta, w)
        ctx.consts = consts
        return cost

    @staticmethod
    def backward(ctx, grad):
        theta, demand, n, delta, w = ctx.saved_tensors
        return (relax_backward(theta, demand, ctx.consts, (n, delta, w),
                               grad), None, None)


def relaxed_cost(theta: torch.Tensor, demand: torch.Tensor,
                 consts) -> torch.Tensor:
    """The relaxation's cost as a differentiable 0-dim tensor: forward
    and reverse each one kernel launch on the card."""
    return _Relax.apply(theta, demand, tuple(consts))
