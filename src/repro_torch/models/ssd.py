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

In a tensor-parallel step (`repro_torch.distributed.tensor_parallel`)
the decode step runs on the rank's shards: the input projection's
columns (its output gathered), the convolution on the rank's channels
of ``conv`` (its output gathered, since the rank's heads read channels
and B/C that other ranks convolve), the state update on the rank's
heads of ``ssm``, and the output projection's columns. In a prefill step
the block runs on the sequence gathered over 'model' and on the rank's
heads: their columns of ``in_proj`` (z, the channels of xs, and dt) with
B and C whole (one group: every head reads them), brought by one
all-to-all; the convolution on those channels; the scan on the rank's
heads; the gated norm over the whole ``d_inner`` from each position's
sum of squares all-reduced over 'model'; the rank's rows of
``out_proj``, the partial sums reduce-scattered onto the rank's
positions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tp
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
    zxbcdt = tp.matmul(x, p.in_proj)
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


def _scan_heads(xs, B, C, dt, a_log, dt_bias, d_skip, cfg, dtype):
    """y (B, S, C) in ``dtype`` of the heads whose channels are xs (B, S,
    C = heads x headdim), their dt (B, S, heads) before softplus and
    their (heads,) vectors, from the convolved B, C (B, S, N). The
    sequence is zero-padded to a multiple of ``cfg.ssd_chunk`` for the
    scan and cut back after it."""
    b, s, c = xs.shape
    hp = cfg.ssm_headdim
    dt = F.softplus(dt.float() + dt_bias[None, None, :])
    A = -torch.exp(a_log)
    xh = xs.reshape(b, s, c // hp, hp)
    pad = (-s) % cfg.ssd_chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    y, _ = ssd_scan(xh.float(), dt, A, B.float(), C.float(), cfg.ssd_chunk)
    y = y[:, :s] + d_skip[None, None, :, None] * xh[:, :s].float()
    return y.reshape(b, s, c).to(dtype)


def ssd_block(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """The mamba2 block for training and the full-sequence forward.
    x: (B, S, d). In a prefill step (`tensor_parallel.sequence_parallel`)
    ``x`` is the rank's positions (`_ssd_prefill`)."""
    ctx = tp.sequence_parallel()
    if ctx is not None:
        return _ssd_prefill(ctx, p, x, cfg)
    di, n = cfg.d_inner, cfg.ssm_state
    z, xbc, dt = _split_proj(p, x, cfg)
    xbc = _causal_conv(xbc, p.conv_w, p.conv_b)
    xs, B, C = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    y = _scan_heads(xs, B, C, dt, p.a_log, p.dt_bias, p.d_skip, cfg, x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p.out_norm)
    return y @ p.out_proj


def _ssd_prefill(ctx, p, x: torch.Tensor, cfg) -> torch.Tensor:
    """`ssd_block` in a prefill step, on ``x`` the rank's positions (B,
    local, d): the sequence all-gathered over 'model', then the rank's
    block of the heads (channels [c0, c0 + c) of ``d_inner``). The pads
    at the sequence's end never reach a real position: the convolution
    and the scan are causal. The gated norm's variance sums the ranks'
    partial sums of squares (B, S, 1) float32, so its summation order is
    not one process's."""
    x = ctx.seq_gather(x)
    di, n, h, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    h0, hl = ctx.block(h)
    c0, c = h0 * hp, hl * hp
    dt0 = 2 * di + 2 * n

    def spans(r):                   # z, xs, B and C, dt of rank r's heads
        return [(r * c, (r + 1) * c), (di + r * c, di + (r + 1) * c),
                (2 * di, dt0), (dt0 + r * hl, dt0 + (r + 1) * hl)]

    proj = x @ ctx.columns_of(p.in_proj, [spans(r) for r in range(ctx.size)])
    z, xbc, dt = proj.split([c, c + 2 * n, hl], -1)
    conv_w, conv_b = ctx.whole(p.conv_w), ctx.whole(p.conv_b)
    xbc = _causal_conv(xbc, torch.cat([conv_w[:, c0:c0 + c], conv_w[:, di:]],
                                      1),
                       torch.cat([conv_b[c0:c0 + c], conv_b[di:]]))
    xs, B, C = xbc.split([c, n, n], -1)
    y = _scan_heads(xs, B, C, dt, ctx.entries(p.a_log, h0, hl),
                    ctx.entries(p.dt_bias, h0, hl),
                    ctx.entries(p.d_skip, h0, hl), cfg, x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype),
                 ctx.entries(p.out_norm, c0, c), width=di)
    return ctx.seq_scatter(y @ ctx.row_block(p.out_proj))


def ssd_decode_step(p, x: torch.Tensor, conv_state: torch.Tensor,
                    ssm_state: torch.Tensor, cfg):
    """One token. x: (B, 1, d); conv_state: (B, W-1, d_inner + 2N);
    ssm_state: (B, H, P, N) float32. Returns (out (B, 1, d), conv_state,
    ssm_state), new tensors.

    In a tensor-parallel step ``conv_state`` and ``ssm_state`` are the
    rank's channels and heads (`tensor_parallel.state_shard` of ``conv``
    and ``ssm``). The gated y of the rank's heads is all-gathered before
    the norm: ``out_proj`` needs the whole row anyway, and the norm then
    takes its variance over the whole row as one process does (the
    `rms_norm` site scales and gathers the rank's slice), where
    all-reducing partial sums of squares would save that one gather of
    (B, d_inner) but sum the variance in another order."""
    b = x.shape[0]
    di, n, h, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    chans = tp.state_shard("conv", conv_state.shape[-1])
    heads = tp.state_shard("ssm", ssm_state.shape[1])
    z, xbc, dt = _split_proj(p, x, cfg)
    window = torch.cat([conv_state, chans.take(xbc)], dim=1)   # (B, W, C)
    conv_state = window[:, 1:]
    out = (window * chans.take(p.conv_w)[None]).sum(dim=1, keepdim=True) \
        + chans.take(p.conv_b)
    xbc = chans.gather(F.silu(out.float()).to(x.dtype))
    xs, B, C = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(heads.take(dt).float()
                    + heads.take(p.dt_bias)[None, None, :])[:, 0]   # (B, H)
    A = -torch.exp(heads.take(p.a_log))
    xh = heads.take(xs.reshape(b, h, hp), 1).float()
    Bv = B[:, 0].float()                                    # (B, N)
    Cv = C[:, 0].float()
    decay = torch.exp(dt * A[None, :])                      # (B, H)
    upd = dt[..., None, None] * xh[..., None] * Bv[:, None, None, :]
    ssm_state = ssm_state * decay[..., None, None] + upd    # (B, H, P, N)
    y = torch.einsum("bhpn,bn->bhp", ssm_state, Cv)
    y = y + heads.take(p.d_skip)[None, :, None] * xh
    y = heads.gather(y.reshape(b, 1, heads.count * hp).to(x.dtype))
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p.out_norm)
    return tp.matmul(y, p.out_proj), conv_state, ssm_state
