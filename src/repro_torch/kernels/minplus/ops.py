"""Wrappers of the hand-written CUDA min-plus transition kernels.

Same contracts as the reference wrappers `repro.kernels.minplus.ops.
minplus_step` (dense, any y_c) and `minplus_step_structured` (requires
non-increasing y_c, the ``transition="kernel"`` backend of the DP),
batched over a leading row axis: F, yc_prev, yc_cur ``(B, N)`` float32,
coeffs ``(B, 4)`` (af, df, ac, dc) or four scalars / ``(B,)`` tensors.
Each returns ``(values (B, N) float32, first argmins (B, N) int32)``; one
launch covers the whole batch.

The tensor's device decides the route: a CPU tensor goes to the plain
PyTorch version in `repro_torch.core.dp`; a CUDA tensor launches the
kernel, or this raises. ``<wrapper>.launches`` counts the kernel launches
and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"minplus": (_CSRC / "minplus.cu",),
           "minplus_structured": (_CSRC / "minplus_structured.cu",)}
#: Largest level count of the structured kernel (its kMaxN): it keeps 5
#: (N,) rows of one batch row in shared memory, inside the 227 KB a block
#: may use.
MAX_N_STRUCTURED = 11264
#: Rows are the dense kernel's second grid dimension.
MAX_B_DENSE = 65535


#: Pointer and int arguments of each kernel's C launch function, which
#: also takes the stream last.
_ARGS = {"minplus": (6, 2), "minplus_structured": (8, 3)}


@functools.cache
def _launcher(name: str):
    fn = getattr(load_library(name, SOURCES[name]), f"{name}_launch")
    n_ptrs, n_ints = _ARGS[name]
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _prepare(name: str, F, yc_prev, yc_cur, coeffs):
    """Checks and contiguous float32 operands of one launch on the card."""
    if F.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {F.device}")
    if F.dim() != 2 or yc_prev.shape != F.shape or yc_cur.shape != F.shape:
        raise ValueError(f"{name}: F {tuple(F.shape)}, yc_prev "
                         f"{tuple(yc_prev.shape)} and yc_cur "
                         f"{tuple(yc_cur.shape)} must be the same (B, N)")
    if any(x.dtype != torch.float32 for x in (F, yc_prev, yc_cur)):
        raise ValueError(f"{name}: F, yc_prev and yc_cur must be float32")
    if yc_prev.device != F.device or yc_cur.device != F.device:
        raise ValueError(f"{name}: operands on different devices")
    if F.shape[0] < 1 or F.shape[1] < 1:
        raise ValueError(f"{name}: empty batch {tuple(F.shape)}")
    from repro_torch.core.dp import _coeff_cols
    co = torch.cat(_coeff_cols(coeffs, F), dim=1).contiguous()
    return F.contiguous(), yc_prev.contiguous(), yc_cur.contiguous(), co


def minplus_step(F: torch.Tensor, yc_prev: torch.Tensor, yc_cur: torch.Tensor,
                 coeffs):
    """Dense O(N^2) transition: kernel `minplus` on the card."""
    if F.device.type == "cpu":
        from .ref import minplus_step_ref
        return minplus_step_ref(F, yc_prev, yc_cur, coeffs)
    F, ycp, ycc, co = _prepare("minplus", F, yc_prev, yc_cur, coeffs)
    batch, n = F.shape
    if batch > MAX_B_DENSE:
        raise ValueError(f"minplus: at most {MAX_B_DENSE} rows, got {batch}")
    out = torch.empty_like(F)
    arg = torch.empty(F.shape, dtype=torch.int32, device=F.device)
    with torch.cuda.device(F.device):
        rc = _launcher("minplus")(
            F.data_ptr(), ycp.data_ptr(), ycc.data_ptr(), co.data_ptr(),
            out.data_ptr(), arg.data_ptr(), batch, n,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"minplus launch failed: CUDA error {rc}")
    minplus_step.launches += 1
    return out, arg


def minplus_step_structured(F: torch.Tensor, yc_prev: torch.Tensor,
                            yc_cur: torch.Tensor, coeffs):
    """Structured O(N log N) transition for non-increasing y_c rows:
    kernel `minplus_structured` on the card."""
    if F.device.type == "cpu":
        from .ref import minplus_step_structured_ref
        return minplus_step_structured_ref(F, yc_prev, yc_cur, coeffs,
                                           check=False)
    F, ycp, ycc, co = _prepare("minplus_structured", F, yc_prev, yc_cur,
                               coeffs)
    batch, n = F.shape
    if n > MAX_N_STRUCTURED:
        raise ValueError(f"minplus_structured: at most {MAX_N_STRUCTURED} "
                         f"levels, got {n}")
    levels = max(1, n.bit_length())
    out = torch.empty_like(F)
    arg = torch.empty(F.shape, dtype=torch.int32, device=F.device)
    tab_v = torch.empty((batch, levels, 2, n), dtype=torch.float32,
                        device=F.device)
    tab_i = torch.empty((batch, levels, 2, n), dtype=torch.int32,
                        device=F.device)
    with torch.cuda.device(F.device):
        rc = _launcher("minplus_structured")(
            F.data_ptr(), ycp.data_ptr(), ycc.data_ptr(), co.data_ptr(),
            out.data_ptr(), arg.data_ptr(), tab_v.data_ptr(),
            tab_i.data_ptr(), batch, n, levels,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"minplus_structured launch failed: CUDA error {rc}")
    minplus_step_structured.launches += 1
    return out, arg


minplus_step.launches = 0
minplus_step_structured.launches = 0
