"""Hand-written Hopper kernels of the port, one folder each:
``<name>/csrc/*.cu`` (the kernel), ``<name>/ops.py`` (the wrapper with
its launch counter) and ``<name>/ref.py`` (the plain PyTorch version).
`build` compiles and loads them. Ported so far: `spork_predict`, `minplus`
(the dense and the structured min-plus transition) and `arrival` (one
block of discrete-event arrivals)."""
