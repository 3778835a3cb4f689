"""Hardware constants of the card for the roofline analysis.

Spec-sheet figures of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit). Mesh construction, the
reference's other content of this module, waits for the distributed
layer."""

PEAK_FLOPS_BF16 = 989e12         # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12                 # bytes/s, device memory
