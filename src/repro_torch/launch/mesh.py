"""Cell mesh for sharded sweeps, and the card's roofline constants.

`make_cell_mesh` names the devices a `repro_torch.sim.exec.MeshBackend`
splits the cell axis of a sweep chunk over. The reference's
(data, model) production meshes wait for the distributed layer.

The constants are spec-sheet figures of one NVIDIA H100 SXM (NVIDIA's
data sheet, dense rates, at the full 700 W power limit)."""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.device import resolve_device

PEAK_FLOPS_BF16 = 989e12         # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12                 # bytes/s, device memory


def make_cell_mesh(devices: Sequence | None = None) -> list[torch.device]:
    """The devices of a 1-D cell mesh, in shard order: ``devices``
    resolved (a device may repeat: two shards on one card), or every
    visible CUDA device. Raises RuntimeError when CUDA is asked for and
    there is no card, ValueError for an empty list."""
    if devices is None:
        resolve_device(None)                 # raises without a card
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("make_cell_mesh: no devices")
    return devs
