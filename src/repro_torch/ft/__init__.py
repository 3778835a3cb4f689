"""Fault tolerance (port of `repro.ft`): `failures` holds the DES fault
model (the counter-based hash and `FailureSpec`) and the host-level
drills (`HeartbeatMonitor`, `FailureInjector`); `elastic` the survivor
filter the serial oracle's allocator uses and `StragglerPolicy`. Mesh
shrinking waits for the distributed layer."""
