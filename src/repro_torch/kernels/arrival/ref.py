"""Plain PyTorch version of the `arrival` kernel.

The semantic ground truth of the kernel is the batched engine's own
arrival path: `repro_torch.sim.events_batched._arrival_step` (pristine)
and `_arrival_fail` (failure-aware), applied in order over one block.
`arrival_block_ref` is that loop, so the CPU engine path and the kernel's
oracle are the same code.
"""

from __future__ import annotations

import torch

from repro_torch.ft.failures import FailStatic
from repro_torch.sim.events_batched import (EvCarry, EventScalars,
                                            _arrival_fail, _arrival_step)


def arrival_block_ref(es: EventScalars, fstat: FailStatic, code, w_f: int,
                      c: EvCarry, times: torch.Tensor) -> EvCarry:
    """Apply every arrival of one block (``times`` ``(C, B)`` float32,
    padded with +inf no-ops) to the carry of every cell, in order.
    ``code`` is the ``(C,)`` dispatch policy code; ``fstat`` the static
    failure axis. Arrivals past the last finite time of every cell are
    no-ops and are skipped (one host read of the block)."""
    W = c.serv_slot.shape[-1]
    dev = c.serv_slot.device
    is_f = torch.arange(W, device=dev) < w_f
    idxW = torch.arange(W, dtype=torch.float32, device=dev)
    pos = torch.arange(1, times.shape[-1] + 1, device=times.device)
    n = int((torch.isfinite(times) * pos).amax()) if times.numel() else 0
    for i in range(n):
        t = times[:, i]
        if fstat.enabled:
            c = _arrival_fail(es, fstat, code, w_f, is_f, idxW, c, t)
        else:
            c = _arrival_step(es, code, w_f, is_f, idxW, c, t)
    return c
