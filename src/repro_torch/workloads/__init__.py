"""Workload traces (port of `repro.workloads`; this slice ports only the
`Trace` container, the §5.1 synthetic traces and the Table 7 production
stand-ins in `scenarios`)."""
