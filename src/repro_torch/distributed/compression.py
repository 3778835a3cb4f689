"""Error-feedback int8 gradient compression (port of
`repro.distributed.compression`).

Quantizing gradients to int8 with one scale per leaf cuts the traffic of
a cross-node gradient reduction 4x (bf16) while error feedback keeps the
bias bounded: the quantization residual is carried into the next step's
gradient.

Usage: residuals = init_error_feedback(params);
       grads, residuals = compress_decompress(grads, residuals)
before the optimizer. Trees are dicts of tensors keyed by parameter
name. The scale is one ``amax`` per leaf of the reference: the tensors
``<stack>.<i>.<name>`` of a stacked layer list share the scale of the
reference's stacked ``<stack>.<name>``
(`repro_torch.models.model.reference_leaf`). ``torch.round`` rounds half
to even, as ``jnp.round`` does.
"""

from __future__ import annotations

import torch

from repro_torch.models.model import reference_leaf


def init_error_feedback(params: dict[str, torch.Tensor]
                        ) -> dict[str, torch.Tensor]:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def _quantize(x: torch.Tensor, amax: torch.Tensor | None = None):
    """(int8 values, scale) of ``x`` with the scale ``(amax + 1e-12) /
    127``; ``amax`` defaults to max |x| (a group of tensors passes its
    own)."""
    if amax is None:
        amax = x.abs().max()
    scale = (amax + 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_decompress(grads: dict[str, torch.Tensor],
                        residuals: dict[str, torch.Tensor]):
    """Simulated compressed all-reduce: quantize (grad + residual) to
    int8, dequantize (in the gradient's type), and keep the new residual
    (float32). Returns (grads, residuals)."""
    groups: dict[str, list[str]] = {}
    for name in grads:
        groups.setdefault(reference_leaf(name)[0], []).append(name)
    out, res = {}, {}
    for names in groups.values():
        g32 = {n: grads[n].float() + residuals[n] for n in names}
        amax = torch.stack([x.abs().max() for x in g32.values()]).max()
        for n, x in g32.items():
            q, scale = _quantize(x, amax)
            deq = q.float() * scale
            out[n], res[n] = deq.to(grads[n].dtype), x - deq
    return {n: out[n] for n in grads}, {n: res[n] for n in grads}
