"""Distribution substrate (port of `repro.distributed`): sharding rules,
pipeline parallelism, gradient compression, and collective helpers, on
`torch.distributed` process groups, `DeviceMesh` and DTensor."""
