"""Hand-written Hopper kernels of the port, one folder each:
``<name>/csrc/*.cu`` (the kernel), ``<name>/ops.py`` (the wrapper with
its launch counter) and ``<name>/ref.py`` (the plain PyTorch version).
`build` compiles and loads them: `spork_predict`, `minplus` (the dense
and the structured min-plus transition), `arrival` (one block of
discrete-event arrivals) and `decode_attn` (GQA flash-decode against a
KV cache), one for every TPU kernel of the reference; and `relax`, the
gradient tuner's relaxation forward and reverse, which the reference
compiles as an XLA scan and has no TPU kernel for."""
