"""`MeshSpec`: a mesh's axis names and sizes without a process group (the
port's counterpart of the reference's `AbstractMesh` / `Mesh`). It needs
only numpy, so the elastic layer and the launchers describe meshes
without loading the sharding rules or the models."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class MeshSpec:
    """A mesh without a process group: ``axis_names``, ``sizes`` and
    optionally the device ids laid over it in row-major order (any
    objects: ints in tests, ``"cuda:i"`` on the card)."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    device_ids: tuple | None = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError("MeshSpec: one size per axis name")
        if self.device_ids is not None and \
                len(self.device_ids) != int(np.prod(self.sizes)):
            raise ValueError("MeshSpec: device_ids do not fill the mesh")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def devices(self) -> np.ndarray:
        ids = self.device_ids if self.device_ids is not None else \
            range(int(np.prod(self.sizes)))
        arr = np.empty(len(ids), dtype=object)
        arr[:] = list(ids)
        return arr.reshape(self.sizes)
