"""Production meshes, the cell mesh for sharded sweeps, and the card's
roofline constants.

`make_production_mesh` and `make_host_mesh` describe the reference's
(data, model) meshes as `MeshSpec`s (no devices needed);
`repro_torch.distributed.sharding.device_mesh` turns one into a
`DeviceMesh` once a process group spans its ranks. `make_cell_mesh`
names the devices a `repro_torch.sim.exec.MeshBackend` splits the cell
axis of a sweep chunk over.

The constants are spec-sheet figures of one NVIDIA H100 SXM (NVIDIA's
data sheet, dense rates, at the full 700 W power limit)."""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.mesh import MeshSpec

PEAK_FLOPS_BF16 = 989e12         # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12                 # bytes/s, device memory
NVLINK_BW = 900e9                # bytes/s, NVLink 4 per GPU (18 links,
                                 # both directions together)


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """The reference's production mesh: (16, 16) over ('data', 'model'),
    or with ``multi_pod`` (2, 16, 16) with a leading 'pod' axis (outer
    data parallelism, or the pipeline's stages)."""
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


def make_host_mesh() -> MeshSpec:
    """A (1, 1) ('data', 'model') mesh for one-device runs of the
    mesh-aware paths."""
    return MeshSpec(("data", "model"), (1, 1))


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
