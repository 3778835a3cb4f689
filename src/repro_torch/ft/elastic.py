"""Elastic layer (port of `repro.ft.elastic`): the survivor filter the
serial DES allocator uses, and straggler flagging.

`StragglerPolicy` tracks per-host step times and flags hosts slower than
``threshold`` x the fleet's median; a driver can evict them like failed
hosts. `shrink_mesh`, which rebuilds a (data, model) mesh from the
surviving devices, waits for the distributed layer.
"""

from __future__ import annotations

import numpy as np


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
