"""RG-LRU recurrent block (RecurrentGemma/Griffin, arXiv:2402.19427),
port of `repro.models.rglru`.

The gated linear recurrence
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = a ^ (c * r_t),  a = sigmoid(lambda)
runs over the sequence as a log-depth doubling scan in plain torch (the
reference's ``jax.lax.associative_scan``, which it too computes outside
any Pallas kernel): at offsets 1, 2, 4, ... every position folds in the
pair ``offset`` before it, with the combine ``(a_l, b_l), (a_r, b_r) ->
(a_l a_r, b_r + a_r b_l)``. The products stay in linear space, so no
cumulative sum of logarithms can overflow. Decode carries the
``lru_width`` hidden state (float32) and the last three inputs of the
width-4 causal convolution.

Block structure per Griffin: (conv1d -> RG-LRU) recurrent branch gated by
a GeLU branch (tanh form, as ``jax.nn.gelu`` defaults to), then a linear
out-projection. ``lam`` stays float32 whatever the config's type.

The recurrence is channel-wise, so in a tensor-parallel step
(`repro_torch.distributed.tensor_parallel`) the decode step runs it on
the rank's channels of its state: the rank's columns of ``w_x``,
``w_gate``, ``w_r`` and ``w_i``, its ``conv_w``, ``conv_b`` and ``lam``
shards; the convolved input that ``w_r`` and ``w_i`` read, and the y
that ``w_out`` reads, are all-gathered. In a prefill step the block runs
on the sequence gathered over 'model' and on the rank's channels alike,
the convolved input gathered over the channels for the gates, then the
scan on the rank's channels and the rank's rows of ``w_out``, the
partial sums reduce-scattered onto the rank's positions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models.layers import dense_init

_C = 8.0


class RGLRU(torch.nn.Module):
    """Weights under the reference's names: ``w_x``, ``w_gate`` (d, W),
    ``conv_w`` (4, W), ``conv_b`` (W,), ``w_r``, ``w_i`` (W, W), ``lam``
    (W,) float32 and ``w_out`` (W, d)."""

    def __init__(self, d: int, width: int, dtype: torch.dtype, device=None):
        super().__init__()
        shapes = {"w_x": (d, width), "w_gate": (d, width),
                  "conv_w": (4, width), "conv_b": (width,),
                  "w_r": (width, width), "w_i": (width, width),
                  "lam": (width,), "w_out": (width, d)}
        for name, shape in shapes.items():
            dt = torch.float32 if name == "lam" else dtype
            self.register_parameter(name, torch.nn.Parameter(
                torch.zeros(shape, dtype=dt, device=device),
                requires_grad=False))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The reference's init in its order: fan-in scaled projections,
        a 0.1-scaled normal convolution, zero bias, lam = 3 (a ~ 0.95)."""
        for name in ("w_x", "w_gate"):
            w = getattr(self, name)
            w.copy_(dense_init(generator, *w.shape, w.dtype))
        conv = torch.randn(self.conv_w.shape, generator=generator,
                           dtype=torch.float32, device=generator.device)
        self.conv_w.copy_((conv * 0.1).to(self.conv_w.dtype))
        for name in ("w_r", "w_i", "w_out"):
            w = getattr(self, name)
            w.copy_(dense_init(generator, *w.shape, w.dtype))
        self.conv_b.zero_()
        self.lam.fill_(3.0)


def init_rglru(generator: torch.Generator, cfg) -> RGLRU:
    mod = RGLRU(cfg.d_model, cfg.lru_width or cfg.d_model, cfg.dtype,
                device=generator.device)
    mod.init(generator)
    return mod


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise convolution over the sequence. x: (B, S, W)."""
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(width))
    return out + b


def _gates(p, xw: torch.Tensor, chans: tp.StateShard | None = None):
    """(a, b_in) of the recurrence, float32, from the convolved input
    ``xw`` (every channel), on the channels of ``chans`` (every channel
    when None)."""
    if chans is None:
        chans = tp.StateShard(0, xw.shape[-1], ())
    r = torch.sigmoid(chans.columns(xw, p.w_r).float())
    i = torch.sigmoid(chans.columns(xw, p.w_i).float())
    log_a_base = F.logsigmoid(chans.take(p.lam))            # log a
    log_a = _C * r * log_a_base[None, None, :]              # (B,S,W)
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))
    return a, beta * i * chans.take(xw).float()


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along axis 1, by doubling:
    ceil(log2 S) rounds of whole-tensor products (Hillis-Steele)."""
    s = a.shape[1]
    off = 1
    while off < s:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        b = torch.cat([b[:, :off], b[:, off:] + a[:, off:] * b_prev], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a_prev], dim=1)
        off *= 2
    return b


def rglru_block(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """Training/prefill. x: (B, S, d). In a prefill step
    (`tensor_parallel.sequence_parallel`) ``x`` is the rank's positions:
    all-gathered over the sequence, the recurrence run on the rank's
    block of the channels (`tensor_parallel.StateShard`: its columns of
    ``w_gate``, ``w_x``, ``w_r`` and ``w_i``, its ``conv_w``, ``conv_b``
    and ``lam``), the convolved input all-gathered over the channels for
    the gates, and the rank's rows of ``w_out`` reduce-scattered back
    onto the rank's positions. The pads at the sequence's end never
    reach a real position: the convolution and the scan are causal."""
    ctx = tp.sequence_parallel()
    width = cfg.lru_width or cfg.d_model
    if ctx is None:
        chans = tp.StateShard(0, width, ())
    else:
        x = ctx.seq_gather(x)
        chans = tp.StateShard(*ctx.block(width), ctx.groups)
    gate = F.gelu(chans.columns(x, p.w_gate).float(), approximate="tanh")
    xw = _conv(chans.columns(x, p.w_x), chans.take(p.conv_w),
               chans.take(p.conv_b))
    a, b_in = _gates(p, chans.gather(xw), chans)
    y = (_linear_scan(a, b_in) * gate).to(x.dtype)
    if ctx is None:
        return y @ p.w_out
    return ctx.seq_scatter(y @ ctx.row_block(p.w_out))


def rglru_decode_step(p, x: torch.Tensor, conv_state: torch.Tensor,
                      h_state: torch.Tensor, cfg, state: str = "h"):
    """One token. x: (B, 1, d); conv_state: (B, 3, W); h_state: (B, W)
    float32. Returns (out (B, 1, d), conv_state, h_state), new tensors.
    In a tensor-parallel step both states are the rank's channels of the
    leaf ``state`` (``h`` or ``tail_h``; ``conv`` and ``tail_conv`` lie
    alike)."""
    chans = tp.state_shard(state, h_state.shape[-1])
    gate = F.gelu(chans.columns(x, p.w_gate).float(), approximate="tanh")
    window = torch.cat([conv_state, chans.columns(x, p.w_x)], dim=1)
    conv_state = window[:, 1:]                              # (B, 3, W)
    xw = (window * chans.take(p.conv_w)[None]).sum(dim=1, keepdim=True) \
        + chans.take(p.conv_b)
    a, b_in = _gates(p, chans.gather(xw), chans)
    h_state = a[:, 0] * h_state + b_in[:, 0]
    y = (h_state[:, None, :] * gate).to(x.dtype)
    return tp.matmul(chans.gather(y), p.w_out), conv_state, h_state
