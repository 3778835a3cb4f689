"""Model-level analysis flags (port of `repro.models.flags`).

SCAN_UNROLL: the reference fully unrolls its model scans (layers,
q-blocks, SSD chunks) when this is True, because XLA's cost analysis
counts a while-loop's body once whatever its trip count. The port's
models loop over layers, q-blocks and SSD chunks in Python, so the dry
run (`repro_torch.launch.dryrun`) counts every depth exactly with the
flag off or on. ``--unroll`` sets it, and
`repro_torch.launch.specs.cell_lowerable` then takes one full-width
q-block, as the reference's analysis lowerings do.

The reference's ``uscan`` (a `lax.scan` that honours the flag) has no
twin: the port has no scan to unroll.
"""

SCAN_UNROLL = False
