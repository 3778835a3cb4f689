"""Wrapper of the hand-written CUDA `spork_predict` kernel.

Same contract as the reference wrapper `repro.kernels.spork_predict.ops.
expected_objective` (J with +inf outside [min bin, max bin]), batched
over a leading cell axis: one launch evaluates J for a whole chunk.

The tensor's device decides the route: a CPU tensor goes to the plain
PyTorch version (`repro_torch.core.predictor.expected_objective`); a
CUDA tensor launches the kernel, or this raises. ``expected_objective.
launches`` counts the kernel launches and nothing else, and
``expected_objective.shapes`` counts them by ``(C, N)``; reset both
together (`reset_counts`). The counts are kept under a lock: a
`MeshBackend` launches from one host thread per shard.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import threading
from pathlib import Path

import torch

from repro_torch.core.breakeven import ObjectiveCoeffs
from repro_torch.kernels.build import load_library

SOURCES = (Path(__file__).resolve().parent / "csrc" / "spork_predict.cu",)
#: Largest histogram width: the kernel keeps two padded (N,) float rows of
#: one cell in shared memory, inside the default 48 KB per block.
MAX_N = 4096

_COUNT_LOCK = threading.Lock()


@functools.cache
def _launcher():
    fn = load_library("spork_predict", SOURCES).spork_predict_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3
                   + [ctypes.c_float] * 3
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def coeff_args(coeffs: ObjectiveCoeffs, cells: int,
               device: torch.device) -> list:
    """The kernel's arguments for (co_min, co_over, co_under): three
    device pointers, three per-cell strides in elements, three values.

    A float goes by value (null pointer); a float32 tensor on ``device``
    by pointer, with its stride for a ``(C,)`` tensor and 0 for one value
    (0-dim or ``(1,)``, which the plain version broadcasts). Nothing is
    copied; any other tensor raises ValueError."""
    args = [None, None, None, 0, 0, 0, 0.0, 0.0, 0.0]
    for i in range(3):
        x = coeffs[i]
        if not isinstance(x, torch.Tensor):
            args[6 + i] = float(x)
            continue
        if x.dtype is not torch.float32 or x.device != device:
            raise ValueError(f"spork_predict: {ObjectiveCoeffs._fields[i]} "
                             f"must be a float or a float32 tensor on "
                             f"{device}, got {x.dtype} on {x.device}")
        if x.dim() == 1 and x.shape[0] == cells:
            args[3 + i] = x.stride(0)
        elif x.dim() > 1 or x.numel() != 1:
            raise ValueError(f"spork_predict: {ObjectiveCoeffs._fields[i]} "
                             f"has shape {tuple(x.shape)}, need () or "
                             f"({cells},)")
        args[i] = x.data_ptr()
    return args


def expected_objective(hist: torch.Tensor, coeffs: ObjectiveCoeffs,
                       amort: torch.Tensor) -> torch.Tensor:
    """J for every cell: hist, amort ``(C, N)`` float32; coeffs leaves
    floats or ``(C,)`` tensors. Returns ``(C, N)`` float32."""
    if not hist.is_cuda:
        if hist.device.type == "cpu":
            # imported here: the predictor imports this module
            from .ref import expected_objective_ref
            return expected_objective_ref(hist, coeffs, amort)
        raise ValueError(f"spork_predict: unsupported device {hist.device}")
    device = hist.device
    if hist.dim() != 2 or amort.shape != hist.shape:
        raise ValueError(f"spork_predict: hist {tuple(hist.shape)} and amort "
                         f"{tuple(amort.shape)} must be the same (C, N)")
    if hist.dtype != torch.float32 or amort.dtype != torch.float32:
        raise ValueError("spork_predict: hist and amort must be float32")
    if amort.device != device:
        raise ValueError("spork_predict: hist and amort on different devices")
    cells, n = hist.shape
    if not 1 <= n <= MAX_N or cells < 1:
        raise ValueError(f"spork_predict: need C >= 1 and 1 <= N <= {MAX_N}, "
                         f"got {tuple(hist.shape)}")
    if not hist.is_contiguous():
        hist = hist.contiguous()
    if not amort.is_contiguous():
        amort = amort.contiguous()
    co = coeff_args(coeffs, cells, device)
    out = torch.empty_like(hist)
    if device.index == torch.cuda.current_device():
        rc = _launcher()(hist.data_ptr(), amort.data_ptr(), out.data_ptr(),
                         *co, cells, n,
                         torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            rc = _launcher()(hist.data_ptr(), amort.data_ptr(),
                             out.data_ptr(), *co, cells, n,
                             torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spork_predict launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        expected_objective.launches += 1
        expected_objective.shapes[(cells, n)] += 1
    return out


def reset_counts() -> None:
    """Zero ``expected_objective.launches`` and its per-shape tally."""
    expected_objective.launches = 0
    expected_objective.shapes = collections.Counter()


reset_counts()
