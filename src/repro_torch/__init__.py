"""repro_torch — PyTorch/CUDA port of the Spork reproduction (`repro`).

The port mirrors the JAX package's module names so each counterpart is
easy to find (`repro.sim.ratesim` -> `repro_torch.sim.ratesim`, ...). It
imports torch, numpy and the standard library only: never `jax`, never
`repro`. Where the JAX package vmaps over sweep cells, the port carries
an explicit leading cell axis; where it scans over seconds, the port
runs a Python loop; pytrees become NamedTuples of tensors.

Every public entry point takes ``device=None``, which means the CUDA
card (`repro_torch.device.resolve_device`); callers that want the CPU
ask for it. The hand-written kernels live under `repro_torch.kernels`.

What is ported (the rate-simulator main path behind Table 8, the
min-plus DP behind Figs. 2-3, the exact discrete-event simulation
behind Table 9, the LM serving path: configs, the model of every
family, `ServeEngine` and `SporkRouter`; training: the loss, AdamW, the
train step, the token pipeline and int8 gradient compression; the
workload library, the multi-tenant fleet layer, the gradient tuner, and
the operability layer: checkpoints, resumable and guarded sweeps, the
mesh backend, the Figs. 5-7 launcher) and what waits for later slices
is tracked in ROADMAP.md.
"""
