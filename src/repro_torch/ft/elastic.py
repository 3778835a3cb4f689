"""Survivor filter of the elastic layer (port of `repro.ft.elastic.
surviving`; the mesh-shrinking half waits for the LM slice)."""

from __future__ import annotations


def surviving(ids, is_dead) -> list:
    """Keep the order of ``ids``, drop every id ``is_dead`` flags. The
    serial DES allocator (`repro_torch.sim.events.EventSim._live_fpgas`)
    counts the shrunken live fleet with it during failures and
    evacuations, then re-provisions the shortfall."""
    return [i for i in ids if not is_dead(i)]
