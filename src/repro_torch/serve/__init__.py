"""Serving substrate (port of `repro.serve`): `engine.ServeEngine` is one
model replica with deadline-tracked request slots (lane-masked
continuous batching), and `router.SporkRouter` drives the single-app
Spork scheduler online over the exact discrete-event simulator;
`router.TenantRouter` drives the multi-tenant fleet oracle online."""
