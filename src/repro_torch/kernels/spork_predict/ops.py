"""Wrapper of the hand-written CUDA `spork_predict` kernel.

Same contract as the reference wrapper `repro.kernels.spork_predict.ops.
expected_objective` (J with +inf outside [min bin, max bin]), batched
over a leading cell axis: one launch evaluates J for a whole chunk.

The tensor's device decides the route: a CPU tensor goes to the plain
PyTorch version (`repro_torch.core.predictor.expected_objective`); a
CUDA tensor launches the kernel, or this raises. ``expected_objective.
launches`` counts the kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.core.breakeven import ObjectiveCoeffs
from repro_torch.kernels.build import load_library

SOURCES = (Path(__file__).resolve().parent / "csrc" / "spork_predict.cu",)
#: Largest histogram width: the kernel keeps two (N,) float rows of one
#: cell in shared memory, inside the default 48 KB per block.
MAX_N = 4096


@functools.cache
def _launcher():
    fn = load_library("spork_predict", SOURCES).spork_predict_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def expected_objective(hist: torch.Tensor, coeffs: ObjectiveCoeffs,
                       amort: torch.Tensor) -> torch.Tensor:
    """J for every cell: hist, amort ``(C, N)`` float32; coeffs leaves
    floats or ``(C,)`` tensors. Returns ``(C, N)`` float32."""
    if hist.device.type == "cpu":
        # imported here: the predictor imports this module
        from .ref import expected_objective_ref
        return expected_objective_ref(hist, coeffs, amort)
    if hist.device.type != "cuda":
        raise ValueError(f"spork_predict: unsupported device {hist.device}")
    if hist.dim() != 2 or amort.shape != hist.shape:
        raise ValueError(f"spork_predict: hist {tuple(hist.shape)} and amort "
                         f"{tuple(amort.shape)} must be the same (C, N)")
    if hist.dtype != torch.float32 or amort.dtype != torch.float32:
        raise ValueError("spork_predict: hist and amort must be float32")
    if amort.device != hist.device:
        raise ValueError("spork_predict: hist and amort on different devices")
    cells, n = hist.shape
    if not 1 <= n <= MAX_N or cells < 1:
        raise ValueError(f"spork_predict: need C >= 1 and 1 <= N <= {MAX_N}, "
                         f"got {tuple(hist.shape)}")
    hist = hist.contiguous()
    amort = amort.contiguous()
    co = torch.stack([torch.as_tensor(x, dtype=torch.float32,
                                      device=hist.device).expand(cells)
                      for x in (coeffs.co_min, coeffs.co_over,
                                coeffs.co_under)], dim=1)
    out = torch.empty_like(hist)
    with torch.cuda.device(hist.device):
        rc = _launcher()(hist.data_ptr(), amort.data_ptr(), co.data_ptr(),
                         out.data_ptr(), cells, n,
                         torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spork_predict launch failed: CUDA error {rc}")
    expected_objective.launches += 1
    return out


expected_objective.launches = 0
