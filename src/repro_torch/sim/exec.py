"""Sweep execution: run a rate `SweepPlan` and scatter rows back.

Port of the rate half of `repro.sim.exec`. `LocalBackend` runs every
`ChunkDispatch` of a plan through `ratesim._simulate_cells` on one
device (the card unless the caller asks for the CPU) and `execute`
scatters each chunk's rows back into cell order.

Not ported yet (slice 6 of ROADMAP.md): the checkpoint/resume and retry
harness (`repro.sim.harness.ResilientRunner`), the default-on invariant
guards, and `MeshBackend`, which shards the cell axis over several
devices. The event and fleet plan kinds wait for their own slices.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.policies import RateParams
from repro_torch.sim import ratesim
from repro_torch.sim.plan import ChunkDispatch, SweepPlan, SweepResult


def _rate_args(d: ChunkDispatch, dev: torch.device) -> tuple:
    """Tensor arguments for `ratesim._simulate_cells`, in order."""
    a = d.arrays
    t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=dev)  # noqa: E731
    scal = t(a["scalars"], torch.float32)
    fs = ratesim.FleetScalars(*(scal[:, j].contiguous()
                                for j in range(scal.shape[1])))
    params = RateParams(t(a["headroom"], torch.int32),
                        t(a["levels"], torch.int32),
                        t(a["gain"], torch.float32))
    return (t(a["counts"], torch.int32), t(a["sizes"], torch.float32), fs,
            t(a["energy_weight"], torch.float32), params)


class Backend:
    """One way of running a plan's dispatches. Subclasses implement
    `run(dispatch)`, returning an `Accum` of ``(chunk,)`` tensors."""

    name = "abstract"

    def run(self, d: ChunkDispatch) -> ratesim.Accum:
        raise NotImplementedError


class LocalBackend(Backend):
    """Every dispatch on one device, one batched simulator call each."""

    name = "local"

    def __init__(self, device: str | torch.device | None = None):
        self.device = resolve_device(device)

    def run(self, d: ChunkDispatch) -> ratesim.Accum:
        if d.kind != "rate":
            raise NotImplementedError(
                f"{d.kind!r} dispatches are not ported yet")
        return ratesim._simulate_cells(*d.static, *_rate_args(d, self.device))


def get_backend(backend: str | Backend | None = None,
                device: str | torch.device | None = None) -> Backend:
    """Resolve a backend: an instance passes through (``device`` is then
    ignored); ``None`` or ``"local"`` builds a `LocalBackend` on
    ``device``."""
    if isinstance(backend, Backend):
        return backend
    if backend not in (None, "local"):
        raise ValueError(f"unknown sweep backend {backend!r} (expected "
                         f"'local'; the mesh backend is not ported yet)")
    return LocalBackend(device)


def execute(plan: SweepPlan, backend: str | Backend | None = None,
            device: str | torch.device | None = None) -> SweepResult:
    """Run every dispatch of a rate plan and scatter the rows back into
    cell order. Each dispatch's accumulators come to the host in one
    transfer after its simulator call."""
    backend = get_backend(backend, device)
    if plan.kind != "rate":
        raise NotImplementedError(f"{plan.kind!r} plans are not ported yet")
    n = len(plan.cells)
    leaves = np.zeros((len(ratesim.Accum._fields), n), np.float64)
    for d in plan.dispatches:
        acc = ratesim.accum_numpy(backend.run(d))
        leaves[:, list(d.cell_idx)] = np.stack(acc)[:, :d.n_real]
    return SweepResult(plan.cells, ratesim.Accum(*leaves), plan.work,
                       plan.requests, n_dispatches=plan.n_dispatches,
                       backend=backend.name,
                       device=str(getattr(backend, "device", "")))
