"""Elastic layer (port of `repro.ft.elastic`): mesh shrinking, the
survivor filter the serial DES allocator uses, and straggler flagging.

Recovery: a step raises, `shrink_mesh` rebuilds the largest well-formed
(data, model) mesh from the surviving devices, and the driver restores
the latest checkpoint (full logical tensors) and places it on the new
mesh (`repro_torch.launch.train`). `StragglerPolicy` tracks per-host step
times and flags hosts slower than ``threshold`` x the fleet's median; a
driver can evict them like failed hosts.
"""

from __future__ import annotations

import numpy as np

from repro_torch.distributed.mesh import MeshSpec


def shrink_mesh(devices, model_width: int) -> tuple[MeshSpec, int]:
    """Largest (data, model) mesh over ``devices`` (any ids: ints, or
    ``"cuda:i"``), keeping ``model_width`` if possible; with fewer
    survivors than ``model_width`` it falls back to the widest
    power-of-two model axis that fits (down to 1 for a single survivor).
    Returns (mesh, the count of devices left out).

    Raises ValueError when ``devices`` is empty or ``model_width < 1``:
    there is no well-formed mesh to shrink to."""
    devices = list(devices)
    n = len(devices)
    if n == 0:
        raise ValueError("shrink_mesh: no surviving devices")
    if model_width < 1:
        raise ValueError(f"shrink_mesh: model_width={model_width} < 1")
    width = model_width
    while width > 1 and n // width == 0:
        width //= 2
    data = n // width
    used = data * width
    return MeshSpec(("data", "model"), (data, width),
                    tuple(devices[:used])), n - used


def surviving(ids, is_dead) -> list:
    """Keep the order of ``ids``, drop every id ``is_dead`` flags. The
    serial DES allocator (`repro_torch.sim.events.EventSim._live_fpgas`)
    counts the shrunken live fleet with it during failures and
    evacuations, then re-provisions the shortfall."""
    return [i for i in ids if not is_dead(i)]


class StragglerPolicy:
    """Per-host step times over the last ``window`` steps; a host with at
    least three samples whose median exceeds ``threshold`` x the median
    of the hosts' medians is a straggler."""

    def __init__(self, threshold: float = 3.0, window: int = 20):
        self.threshold = threshold
        self.window = window
        self.times: dict[int, list[float]] = {}

    def record(self, host: int, step_time_s: float) -> None:
        self.times.setdefault(host, []).append(step_time_s)
        if len(self.times[host]) > self.window:
            self.times[host] = self.times[host][-self.window:]

    def stragglers(self) -> list[int]:
        if not self.times:
            return []
        meds = {h: float(np.median(t)) for h, t in self.times.items()
                if len(t) >= 3}
        if not meds:
            return []
        fleet_median = float(np.median(list(meds.values())))
        return [h for h, m in meds.items()
                if m > self.threshold * fleet_median]
