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

The dense kernel splits the source axis as `dense_split` says, a function
of (B, N) alone; the structured one has two variants, chosen by N alone
(`structured_variant`): everything in shared memory up to
`MAX_N_SHARED` levels, a range-min table in device memory above.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"minplus": (_CSRC / "minplus.cu",),
           "minplus_structured": (_CSRC / "minplus_structured.cu",)}
#: Largest level count of the structured kernel (its kMaxN): the global-
#: table variant keeps 5 (N,) rows of one batch row in shared memory,
#: inside the 227 KB a block may use.
MAX_N_STRUCTURED = 11264
#: Largest level count of the on-chip structured variant (its
#: kMaxNShared): 7N + 4 L ceil(N/16) words of shared memory a row.
MAX_N_SHARED = 6272
#: Rows are the dense kernel's second grid dimension.
MAX_B_DENSE = 65535

#: The card's SMs, and the warps `dense_split` puts on each at least.
SMS = 132
WARPS_PER_SM = 8
_GROUP = 8                  # sources a warp takes per step (kGroup)
#: Cost of a split in ms, beyond a constant: per instruction issued on
#: the busiest scheduler, per instruction of one warp's own stream, per
#: warp on the busiest SM (set-up and combine) and per block of a cluster
#: (its barriers and distributed-memory reads). The weighted least-squares
#: fit of `tools/kernel_variants.py split_sweep` over every candidate split
#: at every (B, N) of the Fig. 2 dense run on an NVIDIA H100 80GB HBM3 at
#: 700 W.
DENSE_COST = (7.584e-07, 8.334e-07, 6.807e-05, 2.914e-04)


@dataclass(frozen=True)
class DenseSplit:
    """How the dense kernel cuts one (B, N) launch: ``dests`` consecutive
    destinations a lane (a warp covers 32 x dests), ``warps`` source
    slices a block (one warp each), ``cluster`` blocks a thread block
    cluster, and ``slice_len`` sources a slice, a multiple of 8."""

    dests: int
    warps: int
    cluster: int
    slice_len: int

    @property
    def chunks(self) -> int:
        """Source slices a destination tile is cut into."""
        return self.warps * self.cluster

    def slices(self, n: int) -> list[tuple[int, int]]:
        """The ``[start, stop)`` of every slice, in source order (the last
        ones may be empty)."""
        return [(min(k * self.slice_len, n), min((k + 1) * self.slice_len, n))
                for k in range(self.chunks)]

    def warps_used(self, batch: int, n: int) -> int:
        """Warps with a non-empty slice in a launch of (batch, n)."""
        tiles = batch * math.ceil(n / (32 * self.dests))
        return tiles * min(self.chunks, math.ceil(n / self.slice_len))


def dense_candidates(batch: int, n: int) -> list[DenseSplit]:
    """Every split the kernel takes: 1, 2 or 4 destinations a lane, 1 to
    32 warps a block, 1 to 8 blocks a cluster, the slice length the
    smallest multiple of 8 that covers N; no block with a warp and
    nothing to scan."""
    out = []
    for dests in (1, 2, 4):
        for warps in (1, 2, 4, 8, 16, 32):
            for cluster in (1, 2, 4, 8):
                slice_len = _GROUP * math.ceil(n / (_GROUP * warps * cluster))
                if warps > 1 and math.ceil(n / slice_len) <= (
                        warps - 1) * cluster:
                    continue
                out.append(DenseSplit(dests, warps, cluster, slice_len))
    return out


def dense_cost_terms(batch: int, n: int, sp: DenseSplit) -> tuple:
    """The terms `DENSE_COST` weighs: instructions on the busiest
    scheduler, instructions of one warp (about 40 a destination and 30 a
    group of 8 sources), warps on the busiest SM, blocks a cluster."""
    tiles = batch * math.ceil(n / (32 * sp.dests))
    blocks_per_sm = math.ceil(tiles * sp.cluster / SMS)
    per_warp = sp.slice_len / _GROUP * (40 * sp.dests + 30)
    return (math.ceil(blocks_per_sm * sp.warps / 4) * per_warp, per_warp,
            blocks_per_sm * sp.warps, sp.cluster)


@functools.cache
def dense_split(batch: int, n: int) -> DenseSplit:
    """The dense kernel's split for B = ``batch`` rows of N = ``n``
    levels, a function of (B, N) alone: of the candidates that put
    ``WARPS_PER_SM`` warps on each of the card's ``SMS`` SMs (all of them
    where none does, as at N = 1), the one of least `DENSE_COST`."""
    if batch < 1 or n < 1:
        raise ValueError(f"dense_split: empty batch ({batch}, {n})")
    cands = dense_candidates(batch, n)
    full = [sp for sp in cands
            if sp.warps_used(batch, n) >= WARPS_PER_SM * SMS]

    def cost(sp):
        terms = dense_cost_terms(batch, n, sp)
        return (sum(c * t for c, t in zip(DENSE_COST, terms)),
                sp.dests, sp.warps, sp.cluster)
    return min(full or cands, key=cost)


def structured_variant(n: int) -> str:
    """The structured kernel that a launch of ``n`` levels runs:
    "shared" (everything in shared memory) up to `MAX_N_SHARED`, "global"
    (the doubling table in device memory) up to `MAX_N_STRUCTURED`;
    raises ValueError above."""
    if n < 1 or n > MAX_N_STRUCTURED:
        raise ValueError(f"minplus_structured: 1 to {MAX_N_STRUCTURED} "
                         f"levels, got {n}")
    return "shared" if n <= MAX_N_SHARED else "global"


#: Library, C launch function, pointer and int arguments; each also takes
#: the stream last.
_ENTRIES = {"minplus": ("minplus", "minplus_launch", 6, 6),
            "shared": ("minplus_structured", "minplus_structured_launch",
                       6, 2),
            "global": ("minplus_structured",
                       "minplus_structured_global_launch", 8, 3)}


@functools.cache
def _launcher(entry: str):
    lib, name, n_ptrs, n_ints = _ENTRIES[entry]
    fn = getattr(load_library(lib, SOURCES[lib]), name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _prepare(name: str, F, yc_prev, yc_cur, coeffs):
    """Checks and contiguous float32 operands of one launch on the card.
    A contiguous (B, 4) float32 ``coeffs`` on F's device goes to the kernel
    as it is; other forms are packed into one."""
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
    if (isinstance(coeffs, torch.Tensor) and coeffs.dtype == torch.float32
            and coeffs.device == F.device and coeffs.is_contiguous()
            and coeffs.dim() == 2):
        co = coeffs
    else:
        from repro_torch.core.dp import _coeff_cols
        co = torch.cat(_coeff_cols(coeffs, F), dim=1)
    if co.shape != (F.shape[0], 4):
        raise ValueError(f"{name}: coeffs {tuple(co.shape)} for "
                         f"{F.shape[0]} rows")
    return F.contiguous(), yc_prev.contiguous(), yc_cur.contiguous(), co


def _check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


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
    sp = dense_split(batch, n)
    out = torch.empty_like(F)
    arg = torch.empty(F.shape, dtype=torch.int32, device=F.device)
    with torch.cuda.device(F.device):
        _check("minplus", _launcher("minplus")(
            F.data_ptr(), ycp.data_ptr(), ycc.data_ptr(), co.data_ptr(),
            out.data_ptr(), arg.data_ptr(), batch, n, sp.dests, sp.warps,
            sp.cluster, sp.slice_len, torch.cuda.current_stream().cuda_stream))
    minplus_step.launches += 1
    return out, arg


def minplus_step_structured(F: torch.Tensor, yc_prev: torch.Tensor,
                            yc_cur: torch.Tensor, coeffs):
    """Structured O(N log N) transition for non-increasing y_c rows:
    kernel `minplus_structured` on the card, the variant that
    `structured_variant` names for N."""
    if F.device.type == "cpu":
        from .ref import minplus_step_structured_ref
        return minplus_step_structured_ref(F, yc_prev, yc_cur, coeffs,
                                           check=False)
    F, ycp, ycc, co = _prepare("minplus_structured", F, yc_prev, yc_cur,
                               coeffs)
    batch, n = F.shape
    variant = structured_variant(n)
    out = torch.empty_like(F)
    arg = torch.empty(F.shape, dtype=torch.int32, device=F.device)
    args = [F.data_ptr(), ycp.data_ptr(), ycc.data_ptr(), co.data_ptr(),
            out.data_ptr(), arg.data_ptr()]
    if variant == "shared":
        args += [batch, n]
    else:
        levels = max(1, n.bit_length())
        tab_v = torch.empty((batch, levels, 2, n), dtype=torch.float32,
                            device=F.device)
        tab_i = torch.empty((batch, levels, 2, n), dtype=torch.int32,
                            device=F.device)
        args += [tab_v.data_ptr(), tab_i.data_ptr(), batch, n, levels]
    with torch.cuda.device(F.device):
        _check("minplus_structured", _launcher(variant)(
            *args, torch.cuda.current_stream().cuda_stream))
    minplus_step_structured.launches += 1
    return out, arg


minplus_step.launches = 0
minplus_step_structured.launches = 0
