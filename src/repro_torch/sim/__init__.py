"""Simulators and the sweep stack (port of `repro.sim`): the rate
simulator, the exact DES and its batched engine, plan / execute / sweep
over local and mesh backends, and the resilience harness (checkpoint /
resume, retry, invariant guards)."""
