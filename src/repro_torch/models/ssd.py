"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060), port of
`repro.models.ssd`.

The full-sequence path is the chunked block decomposition: a quadratic,
attention-like product inside each chunk of ``cfg.ssd_chunk`` positions
and a linear recurrence of the (H, P, N) state across chunks, which the
reference runs as a `lax.scan` and the port as a Python loop over the
chunks. Both compute it in plain array operations (no Pallas kernel in
the reference, no hand-written kernel here).

Decode keeps the O(1) recurrent state h: (B, H, P, N) in float32,
    h <- h * exp(dt*A) + dt * x (outer) B ;  y = C . h + D*x,
and the last ``ssm_conv - 1`` inputs of the causal convolution, so the
cache does not grow with the sequence.

``a_log``, ``dt_bias`` and ``d_skip`` are float32 whatever the config's
type, ``dt`` goes through softplus in float32 and the scan runs in
float32, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, rms_norm

# leaves the reference keeps in float32 whatever the config's type
F32_LEAVES = ("a_log", "dt_bias", "d_skip")


class SSD(torch.nn.Module):
    """Weights under the reference's names: ``in_proj`` (d, 2 d_inner + 2N
    + H), ``conv_w`` (W, d_inner + 2N), ``conv_b`` (d_inner + 2N,),
    ``a_log``, ``dt_bias``, ``d_skip`` (H,) float32, ``out_norm``
    (d_inner,) and ``out_proj`` (d_inner, d). One B/C group."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, di = cfg.d_model, cfg.d_inner
        n, h = cfg.ssm_state, cfg.ssm_heads
        conv_dim = di + 2 * n
        shapes = {"in_proj": (d, 2 * di + 2 * n + h),
                  "conv_w": (cfg.ssm_conv, conv_dim), "conv_b": (conv_dim,),
                  "a_log": (h,), "dt_bias": (h,), "d_skip": (h,),
                  "out_norm": (di,), "out_proj": (di, d)}
        for name, shape in shapes.items():
            dt = torch.float32 if name in F32_LEAVES else cfg.dtype
            self.register_parameter(name, torch.nn.Parameter(
                torch.zeros(shape, dtype=dt, device=device),
                requires_grad=False))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The reference's init: fan-in scaled projections, a 0.1-scaled
        normal convolution, zero bias, a_log = dt_bias = 0, d_skip = 1,
        out_norm = 0 (gain 1)."""
        self.in_proj.copy_(dense_init(generator, *self.in_proj.shape,
                                      self.in_proj.dtype))
        conv = torch.randn(self.conv_w.shape, generator=generator,
                           dtype=torch.float32, device=generator.device)
        self.conv_w.copy_((conv * 0.1).to(self.conv_w.dtype))
        self.out_proj.copy_(dense_init(generator, *self.out_proj.shape,
                                       self.out_proj.dtype))
        for name in ("conv_b", "a_log", "dt_bias", "out_norm"):
            getattr(self, name).zero_()
        self.d_skip.fill_(1.0)


def init_ssd(generator: torch.Generator, cfg) -> SSD:
    mod = SSD(cfg, device=generator.device)
    mod.init(generator)
    return mod


def _split_proj(p, x: torch.Tensor, cfg):
    """(z, xbc, dt) of the input projection."""
    di, n = cfg.d_inner, cfg.ssm_state
    zxbcdt = x @ p.in_proj
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n],
            zxbcdt[..., 2 * di + 2 * n:])


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width W, then silu in float32.
    xbc: (B, S, C); w: (W, C)."""
    width = w.shape[0]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i][None, None, :]
              for i in range(width))
    return F.silu((out + b).float()).to(xbc.dtype)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{j<k<=i} x[..., k], -inf
    above the diagonal (masked before any exp, so the masked entries'
    gradient is 0, not inf x 0)."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, -torch.inf)


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int):
    """Chunked SSD. xh: (B, S, H, P); dt: (B, S, H); A: (H,) (negative);
    B, C: (B, S, N); S a multiple of ``chunk``. Returns (y, final_state
    (B, H, P, N) float32)."""
    b, s, h, p = xh.shape
    n = B.shape[-1]
    nc = s // chunk

    def r(t):
        return t.reshape(b, nc, chunk, *t.shape[2:])

    xc, dtc = r(xh), r(dt)                            # (b,nc,q,h,p), (b,nc,q,h)
    Bc, Cc = r(B), r(C)                               # (b,nc,q,n)

    dA = dtc * A[None, None, None, :]                 # (b,nc,q,h)
    dA_cs = torch.cumsum(dA, dim=2)

    # intra-chunk (quadratic in the chunk)
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))    # (b,nc,h,q,q)
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)  # (b,nc,q,q)
    gated = scores[:, :, None] * L                    # (b,nc,h,q,k)
    xdt = xc * dtc[..., None]                         # (b,nc,q,h,p)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", gated, xdt)

    # chunk states
    decay_out = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)            # (b,nc,q,h)
    states = torch.einsum("bcqn,bcqh,bcqhp->bchpn", Bc, decay_out, xdt)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])                   # (b,nc,h)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c].float()
    h_prevs = torch.stack(entering, dim=1)                        # (b,nc,h,p,n)

    decay_in = torch.exp(dA_cs)                                   # (b,nc,q,h)
    y_off = torch.einsum("bcqn,bcqh,bchpn->bcqhp", Cc, decay_in,
                         h_prevs.to(Cc.dtype))
    return (y_diag + y_off).reshape(b, s, h, p), state


def ssd_block(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """The mamba2 block for training and the full-sequence forward.
    x: (B, S, d). The sequence is zero-padded to a multiple of
    ``cfg.ssd_chunk`` for the scan and cut back after it."""
    b, s, _ = x.shape
    di, n, h, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    z, xbc, dt = _split_proj(p, x, cfg)
    xbc = _causal_conv(xbc, p.conv_w, p.conv_b)
    xs, B, C = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt.float() + p.dt_bias[None, None, :])
    A = -torch.exp(p.a_log)
    xh = xs.reshape(b, s, h, hp)
    pad = (-s) % cfg.ssd_chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    y, _ = ssd_scan(xh.float(), dt, A, B.float(), C.float(), cfg.ssd_chunk)
    y = y[:, :s] + p.d_skip[None, None, :, None] * xh[:, :s].float()
    y = y.reshape(b, s, di).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p.out_norm)
    return y @ p.out_proj


def ssd_decode_step(p, x: torch.Tensor, conv_state: torch.Tensor,
                    ssm_state: torch.Tensor, cfg):
    """One token. x: (B, 1, d); conv_state: (B, W-1, d_inner + 2N);
    ssm_state: (B, H, P, N) float32. Returns (out (B, 1, d), conv_state,
    ssm_state), new tensors."""
    b = x.shape[0]
    di, n, h, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    z, xbc, dt = _split_proj(p, x, cfg)
    window = torch.cat([conv_state, xbc], dim=1)            # (B, W, C)
    conv_state = window[:, 1:]
    out = (window * p.conv_w[None]).sum(dim=1, keepdim=True) + p.conv_b
    xbc = F.silu(out.float()).to(x.dtype)
    xs, B, C = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt.float() + p.dt_bias[None, None, :])[:, 0]   # (B, H)
    A = -torch.exp(p.a_log)
    xh = xs.reshape(b, h, hp).float()
    Bv = B[:, 0].float()                                    # (B, N)
    Cv = C[:, 0].float()
    decay = torch.exp(dt * A[None, :])                      # (B, H)
    upd = dt[..., None, None] * xh[..., None] * Bv[:, None, None, :]
    ssm_state = ssm_state * decay[..., None, None] + upd    # (B, H, P, N)
    y = torch.einsum("bhpn,bn->bhp", ssm_state, Cv)
    y = y + p.d_skip[None, :, None] * xh
    y = y.reshape(b, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p.out_norm)
    return y @ p.out_proj, conv_state, ssm_state
