"""Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437), port of
`repro.models.mla`.

Prefill: queries by a low-rank path (d -> q_lora -> heads x
(nope + rope)); keys and values decompressed from a shared latent (d ->
kv_lora + k_rope), through the port's `sdpa_chunked`. Decode uses the
absorbed form, in float32: W_uk folded into the query and W_uv into the
output, so the per-token cache is the (kv_lora + rope) latent alone. Like
the reference's, the decode is plain tensor products, not a kernel: it
launches no `decode_attn`.
"""

from __future__ import annotations

import torch

from repro_torch.models.attention import NEG, sdpa_chunked, write_step
from repro_torch.models.layers import dense_init, rms_norm, rope


class MLA(torch.nn.Module):
    """Weights under the reference's names: ``w_dq`` (d, q_lora),
    ``q_norm`` (q_lora,), ``w_uq`` (q_lora, H (dn + dr)), ``w_dkv`` (d,
    kv_lora + dr), ``kv_norm`` (kv_lora,), ``w_ukv`` (kv_lora, H (dn +
    dv)) and ``wo`` (H dv, d)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        shapes = {"w_dq": (d, qr), "q_norm": (qr,),
                  "w_uq": (qr, h * (dn + dr)), "w_dkv": (d, kvr + dr),
                  "kv_norm": (kvr,), "w_ukv": (kvr, h * (dn + dv)),
                  "wo": (h * dv, d)}
        for name, shape in shapes.items():
            self.register_parameter(name, torch.nn.Parameter(
                torch.zeros(shape, dtype=cfg.dtype, device=device),
                requires_grad=False))

    def init(self, generator: torch.Generator) -> None:
        """Fan-in scaled projections in the reference's order; norm
        scales zero (gain 1)."""
        for name in ("w_dq", "w_uq", "w_dkv", "w_ukv", "wo"):
            w = getattr(self, name)
            w.copy_(dense_init(generator, *w.shape, w.dtype))
        self.q_norm.zero_()
        self.kv_norm.zero_()


def init_mla(generator: torch.Generator, cfg) -> MLA:
    mod = MLA(cfg, device=generator.device)
    mod.init(generator)
    return mod


def _latents(p, x, cfg, positions):
    """The compressed KV latent (normed) and the rotary key shared across
    heads: (B, S, kv_lora), (B, S, dr)."""
    kvr = cfg.kv_lora_rank
    ckv = x @ p.w_dkv
    c_kv, k_pe = ckv[..., :kvr], ckv[..., kvr:]
    c_kv = rms_norm(c_kv, p.kv_norm)
    k_pe = rope(k_pe, positions, cfg.rope_theta, has_head_axis=False)
    return c_kv, k_pe


def _queries(p, x, cfg, positions):
    """q_nope (B, S, H, dn) and the roped q_pe (B, S, H, dr)."""
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    cq = rms_norm(x @ p.w_dq, p.q_norm)
    q = (cq @ p.w_uq).reshape(b, s, h, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = rope(q_pe, positions, cfg.rope_theta, has_head_axis=True)
    return q_nope, q_pe


def mla_block(p, x, cfg):
    """Training/prefill MLA, causal. x: (B, S, d) -> (B, S, d)."""
    b, s, _ = x.shape
    h, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    pos = torch.arange(s, device=x.device)
    q_nope, q_pe = _queries(p, x, cfg, pos)
    c_kv, k_pe = _latents(p, x, cfg, pos)
    kv = (c_kv @ p.w_ukv).reshape(b, s, h, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(b, s, h, dr)], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    out = sdpa_chunked(q, k, v, causal=True, q_block=cfg.q_block)
    return out.reshape(b, s, -1) @ p.wo


def mla_decode_step(p, x, cache_ckv, cache_kpe, length, cfg, lanes=None,
                    every_row: bool = False):
    """Absorbed-matrix decode. x: (B, 1, d); cache_ckv: (B, S, kv_lora);
    cache_kpe: (B, S, dr), each holding ``length`` (scalar or (B,)) tokens.

    This token's latent and rotary key are written at position ``length``
    in place, on the rows of ``lanes`` (B,) bool only when it is given;
    ``every_row`` lets the other rows attend with theirs too before they
    are taken back out (`attention.write_step`). Scores, softmax and both
    absorbed products in float32, scaled by (dn + dr) ** -0.5. Returns the
    output (B, 1, d)."""
    b = x.shape[0]
    h, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    kvr = cfg.kv_lora_rank
    lengths = torch.as_tensor(length, device=x.device).expand(b)
    pos = lengths[:, None]

    q_nope, q_pe = _queries(p, x, cfg, pos)               # (B,1,H,dn/dr)
    c_kv, k_pe = _latents(p, x, cfg, pos)                 # (B,1,kvr),(B,1,dr)

    s = cache_ckv.shape[1]
    restore = write_step(((cache_ckv, c_kv[:, 0]), (cache_kpe, k_pe[:, 0])),
                         lengths, lengths < s, lanes, every_row)
    new_len = lengths + 1

    # absorb W_uk into the query: q_abs (B, H, kvr)
    w = p.w_ukv.reshape(kvr, h, dn + dv).float()
    w_uk, w_uv = w[..., :dn], w[..., dn:]
    ckv = cache_ckv.float()
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), w_uk)
    scale = (dn + dr) ** -0.5
    scores = (torch.einsum("bhr,bsr->bhs", q_abs, ckv)
              + torch.einsum("bhd,bsd->bhs", q_pe[:, 0].float(),
                             cache_kpe.float())) * scale
    mask = torch.arange(s, device=x.device) < new_len[:, None, None]
    scores = torch.where(mask, scores, NEG)
    wts = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", wts, ckv)
    restore()
    out = torch.einsum("bhr,rhd->bhd", ctx, w_uv)
    out = out.reshape(b, 1, h * dv).to(x.dtype)
    return out @ p.wo
