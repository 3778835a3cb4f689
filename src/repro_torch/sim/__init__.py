"""Simulators and the sweep stack (port of `repro.sim`; this slice ports
the rate simulator and the rate half of plan/execute/sweep)."""
