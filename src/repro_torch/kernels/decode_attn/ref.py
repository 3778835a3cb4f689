"""Plain PyTorch version of the `decode_attn` kernel: single-step GQA
decode attention over a KV cache, the reference's
``decode_attention_ref`` (einsum, length mask, softmax) in torch."""

from __future__ import annotations

import torch


def _masked_softmax(scores: torch.Tensor) -> torch.Tensor:
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)            # all-masked rows
    e = torch.where(torch.isfinite(scores), torch.exp(scores - m), 0.0)
    return e / e.sum(dim=-1, keepdim=True).clamp(min=1e-30)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, *, return_lse: bool = False):
    """q: (B, Hq, D); k, v: (B, S, Hkv, D); lengths: (B,) valid cache length.

    Hq must be a multiple of Hkv (grouped queries). Returns (B, Hq, D) in
    q's dtype; softmax/accumulation in float32. A row of length 0 gives
    zeros; lengths above S count as S. With ``return_lse`` also the
    (B, Hq) float32 log-sum-exp of each row's scaled scores over its valid
    positions (-inf for a row of length 0): the weight of this output
    when partial outputs over pieces of one cache are combined
    (`repro_torch.distributed.tensor_parallel.combine`).
    """
    b, hq, d = q.shape
    _, s, hkv, _ = k.shape
    g = hq // hkv
    qf = q.float().reshape(b, hkv, g, d) * (d ** -0.5)
    kf = k.float().transpose(1, 2)                        # (B, Hkv, S, D)
    vf = v.float().transpose(1, 2)
    scores = qf @ kf.transpose(-1, -2)                    # (B, Hkv, G, S)
    pos = torch.arange(s, device=q.device)
    mask = pos[None, None, None, :] < lengths.to(q.device)[:, None, None, None]
    scores = scores.masked_fill(~mask, float("-inf"))
    out = (_masked_softmax(scores) @ vf).reshape(b, hq, d).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(scores, dim=-1).reshape(b, hq)
