"""Fault model of the discrete-event simulators (port of the serving half
of `repro.ft`): `failures` holds the counter-based hash and `FailureSpec`,
`elastic` the survivor filter the serial oracle's allocator uses. The
training-side pieces (heartbeat monitor, failure injector, mesh shrinking)
wait for the LM slice."""
