"""GQA attention: chunked (FlashAttention-style) training/prefill path and
single-token decode against a KV cache.

The prefill path tiles the query axis in a Python loop, so the scores of
one block, not of the whole sequence, exist at a time. The decode path
sends every step's attention through `repro_torch.kernels.decode_attn`:
the hand-written CUDA kernel for a cache on the card, its plain PyTorch
version for a cache on the CPU.

Supports grouped/multi-query heads, qk RMSNorm (qwen3), non-causal masks
and sliding windows (recurrentgemma's local attention: a window mask in
prefill, a ring-buffer cache in decode), non-causal encoders and
cross-attention against an encoder memory (whisper). The reference's
decode-time cross-attention calls its plain `decode_attention_ref`
directly; the port's goes through `decode_attention` like every other
decode call, so on the card the memory is read by the kernel.

The projections, `attention_block`, `decode_attention_step` and
`cross_attention_decode` consult the tensor-parallel context
(`repro_torch.distributed.tensor_parallel`): inside the sharded serve
step the products run on the rank's weight shards and the decode attends
over the rank's shard of the cache or of the encoder memory (its KV
heads, or its positions, combined across ranks by log-sum-exp); inside
the sharded prefill step the block gathers the rank's positions over
the sequence, attends on the rank's q heads and the whole KV heads they
read, and reduce-scatters its partial output product onto the positions
(the heads rule, where 'model' divides the q heads); where it does not
(recurrentgemma's 10 heads, whisper's 8, on 16 ranks) the rank keeps its
own query positions, attends with every head over the K/V of every real
position, gathered along the sequence, and multiplies by the whole
``wo`` (the context rule, the reference's fallback layout).
"""

from __future__ import annotations

import torch

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.decode_attn import decode_attention
from repro_torch.models.layers import dense_init, rms_norm, rope

NEG = -1.0e30


class Attention(torch.nn.Module):
    """Projection weights under the reference's names: ``wq`` (d, Hq*D),
    ``wk``/``wv`` (d, Hkv*D), ``wo`` (Hq*D, d), and with qk-norm the
    per-head scales ``q_norm``/``k_norm`` (D,)."""

    def __init__(self, d: int, n_heads: int, n_kv_heads: int, d_head: int,
                 dtype: torch.dtype, qk_norm: bool = False, device=None):
        super().__init__()
        shapes = {"wq": (d, n_heads * d_head), "wk": (d, n_kv_heads * d_head),
                  "wv": (d, n_kv_heads * d_head), "wo": (n_heads * d_head, d)}
        if qk_norm:
            shapes.update(q_norm=(d_head,), k_norm=(d_head,))
        for name, shape in shapes.items():
            self.register_parameter(name, torch.nn.Parameter(
                torch.zeros(shape, dtype=dtype, device=device),
                requires_grad=False))

    def init(self, generator: torch.Generator) -> None:
        """Fan-in scaled projections; norm scales zero (gain 1)."""
        for name in ("wq", "wk", "wv", "wo"):
            w = getattr(self, name)
            w.copy_(dense_init(generator, w.shape[0], w.shape[1], w.dtype))
        for name in ("q_norm", "k_norm"):
            if hasattr(self, name):
                getattr(self, name).zero_()


def init_attention(generator: torch.Generator, d: int, n_heads: int,
                   n_kv_heads: int, d_head: int, dtype: torch.dtype,
                   qk_norm: bool = False) -> Attention:
    att = Attention(d, n_heads, n_kv_heads, d_head, dtype, qk_norm,
                    device=generator.device)
    att.init(generator)
    return att


def _project_qkv(p, x, n_heads, n_kv_heads, d_head, positions, rope_theta,
                 qk_norm, xkv=None):
    """Returns q (B,S,Hq,D), k,v (B,Skv,Hkv,D), K/V projected from ``xkv``
    (B, Skv, d) when it is given (an encoder memory) and from ``x``
    otherwise; qk-norm before rope, and no rope when ``positions`` is
    None. In a prefill step (`tensor_parallel.sequence_parallel`) whose
    'model' axis divides the q heads, q is the rank's block of the q
    heads and k, v the whole KV heads they read, repeated to one a q
    head where the rank's q heads do not group evenly onto them (the
    reference's repeat-KV rule); where it does not divide them, every
    head from the whole weights (`tensor_parallel.matmul`)."""
    b, s, _ = x.shape
    xkv = x if xkv is None else xkv
    skv = xkv.shape[1]
    ctx = tp.sequence_parallel()
    if ctx is None or n_heads % ctx.size:
        q = tp.matmul(x, p.wq).reshape(b, s, n_heads, d_head)
        k = tp.matmul(xkv, p.wk).reshape(b, skv, n_kv_heads, d_head)
        v = tp.matmul(xkv, p.wv).reshape(b, skv, n_kv_heads, d_head)
    else:
        q = ctx.columns(x, p.wq, d_head).reshape(b, s, -1, d_head)
        ranges = ctx.kv_ranges(n_heads, n_kv_heads, d_head)
        k = (xkv @ ctx.columns_of(p.wk, ranges)).reshape(b, skv, -1, d_head)
        v = (xkv @ ctx.columns_of(p.wv, ranges)).reshape(b, skv, -1, d_head)
        hq, hkv, g = q.shape[2], k.shape[2], n_heads // n_kv_heads
        first = ctx.block(n_heads)[0]
        kv_of = [(first + i) // g - ranges[ctx.rank][0] // d_head
                 for i in range(hq)]
        if hq % hkv or kv_of != [i // (hq // hkv) for i in range(hq)]:
            k, v = k[:, :, kv_of], v[:, :, kv_of]
    if qk_norm:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    if positions is not None:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions[..., :skv] if positions.shape[-1] >= skv
                 else positions, rope_theta)
    return q, k, v


def sdpa_chunked(q, k, v, *, causal=True, window=0, q_block=512,
                 kv_positions=None, q_positions=None):
    """Scaled dot-product attention, tiled over query blocks.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D). Hq % Hkv == 0.
    Masks: causal (q_pos >= kv_pos) when ``causal`` and, when ``window``
    is not 0, the sliding window (q_pos - kv_pos < window), with the
    positions ``q_positions`` (B, Sq) or (Sq,) and ``kv_positions``
    (Skv,), 0.. Sq - 1 and 0.. Skv - 1 where they are None. Scores,
    softmax and the product with v in float32; the output in q's type.
    """
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = d ** -0.5
    kt = k.float().permute(0, 2, 3, 1)                    # (B, Hkv, D, Skv)
    vt = v.float().permute(0, 2, 1, 3)                    # (B, Hkv, Skv, Dv)
    kp = (torch.arange(skv, device=q.device) if kv_positions is None
          else torch.as_tensor(kv_positions, device=q.device))
    qpos = (torch.arange(sq, device=q.device) if q_positions is None
            else torch.as_tensor(q_positions, device=q.device))
    qpos = qpos.reshape(-1, 1, 1, sq, 1)                  # (B or 1, ..., Sq, 1)
    outs = []
    for s0 in range(0, sq, q_block):
        s1 = min(s0 + q_block, sq)
        qblk = q[:, s0:s1].reshape(b, s1 - s0, hkv, g, d).permute(
            0, 2, 3, 1, 4)                                # (B, Hkv, G, q, D)
        scores = (qblk.float() * scale) @ kt[:, :, None]
        qp = qpos[..., s0:s1, :]
        if causal:
            scores = torch.where(qp >= kp, scores, NEG)
        if window:
            scores = torch.where((qp - kp) < window, scores, NEG)
        w = torch.softmax(scores, dim=-1)
        out = (w @ vt[:, :, None]).to(q.dtype)            # (B, Hkv, G, q, Dv)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, s1 - s0, hq, -1))
    return torch.cat(outs, dim=1)


def attention_block(p, x, cfg, memory=None, layer_window=0, causal=None):
    """Full attention sub-block for prefill/forward (projections + sdpa +
    output); ``layer_window`` > 0 masks to a sliding window. ``memory``
    (B, Ssrc, d), an encoder output, makes it cross-attention: K/V from
    the memory and no rope. ``causal`` None means ``cfg.causal`` for
    self-attention and no mask for cross-attention.

    In a prefill step ``x`` is the rank's positions and ``memory``, where
    it is given, every real frame. Where 'model' divides the q heads
    (the heads rule) ``x`` is all-gathered over the sequence, attended on
    the rank's q heads (`_project_qkv`) with rope on the global
    positions, the output multiplied by the rank's rows of ``wo`` and
    the partial sums reduce-scattered back onto the rank's positions.
    Where it does not (the context rule) the rank's positions are
    projected through the whole weights, their K/V all-gathered along
    the sequence, every head's queries attend at their global positions
    (so the causal mask and the window hold) and the output is
    multiplied by the whole ``wo``. Either way K/V hold the real
    positions alone: the pads at the sequence's end are cut, so a
    non-causal attention never sees one."""
    ctx = tp.sequence_parallel()
    heads = ctx is not None and cfg.n_heads % ctx.size == 0
    context = ctx is not None and not heads
    if heads:
        x = ctx.seq_gather(x)
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)
    if context:
        pos = pos + ctx.rank * ctx.seq_block              # global positions
    q, k, v = _project_qkv(p, x, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                           None if memory is not None else pos,
                           cfg.rope_theta, cfg.qk_norm, xkv=memory)
    if causal is None:
        causal = cfg.causal and memory is None
    if ctx is not None and memory is None:
        if context:
            k, v = ctx.seq_whole(torch.cat([k, v], -1)).split(
                [k.shape[-1], v.shape[-1]], -1)
        else:
            k, v = k[:, :ctx.seq_len], v[:, :ctx.seq_len]
    out = sdpa_chunked(q, k, v, causal=causal, window=layer_window,
                       q_block=cfg.q_block,
                       q_positions=pos if context else None).reshape(b, s, -1)
    if ctx is None:
        return out @ p.wo
    if heads:
        return ctx.seq_scatter(out @ ctx.row_block(p.wo))
    return out @ ctx.whole(p.wo)


def _write_slot(cache: torch.Tensor, slot: torch.Tensor, write: torch.Tensor,
                new: torch.Tensor, old: torch.Tensor | None = None
                ) -> torch.Tensor:
    """cache[b, slot[b]] = new[b] where write[b], in place; elsewhere
    ``old[b]`` (the values already there when ``old`` is None). A row whose
    slot lies at or past the cache's end is left as it was, like the
    reference's one-hot write, which matches no position there; so is a
    row whose slot lies before it (a slot held by another rank's shard of
    the sequence). Returns the values the slots held before the write."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    at = slot.clamp(0, cache.shape[1] - 1)
    before = cache[rows, at]
    keep = before if old is None else old
    mask = write.reshape(-1, *([1] * (new.dim() - 1)))
    cache[rows, at] = torch.where(mask, new.to(cache.dtype), keep)
    return before


def write_step(caches, slot: torch.Tensor, in_range: torch.Tensor, lanes,
               every_row: bool):
    """Write this step's entries ``(cache, new)`` at ``slot`` on the rows
    where ``in_range``, in place, and on ``lanes`` only when given. With
    ``every_row`` every row's entry is written for the step's attention
    and the rows outside ``lanes`` get theirs back by the returned
    function, called after it: the reference's step of the full batch,
    whose cache is then merged back on the idle lanes, so that an idle
    lane's hidden state (which a mixture-of-experts layer routes with the
    others of its row) is the reference's too."""
    persist = in_range if lanes is None else in_range & lanes
    if not every_row or lanes is None:
        for cache, new in caches:
            _write_slot(cache, slot, persist, new)
        return lambda: None
    olds = [_write_slot(cache, slot, in_range, new) for cache, new in caches]

    def restore():
        for (cache, new), old in zip(caches, olds):
            _write_slot(cache, slot, persist, new, old)
    return restore


def _attend(q, cache_k, cache_v, lengths, shard):
    """`decode_attention` of q (B, Hq, D) over the cache; in a
    tensor-parallel step (``shard``, a `tensor_parallel.KVShard`) over
    the rank's shard of it, the ranks' outputs combined by their
    log-sum-exps where the sequence is split and gathered over the heads
    (`KVShard.finish`)."""
    if shard is None:
        return decode_attention(q, cache_k, cache_v, lengths)
    if shard.seq_groups:
        return shard.finish(*decode_attention(q, cache_k, cache_v, lengths,
                                              return_lse=True))
    return shard.finish(decode_attention(q, cache_k, cache_v, lengths))


def decode_attention_step(p, x, cache_k, cache_v, length, cfg,
                          ring: bool = False, lanes=None,
                          every_row: bool = False, cache: str = "kv"):
    """One-token decode. x: (B, 1, d); cache_k/v: (B, S, Hkv, D) holding
    `length` previously written tokens (scalar or (B,)).

    ring=True treats the cache as a sliding-window ring buffer (cache size
    = window): the new token is written at position length % S, rope uses
    the absolute position, and validity is clipped at S.

    The new key and value are written into ``cache_k``/``cache_v`` in
    place (the reference returns new arrays; at full width a copy of the
    cache per layer is waste), only on the rows where ``lanes`` (B,) bool
    is true when it is given. ``every_row`` (the moe family) lets the rows
    outside ``lanes`` attend with their new key and value too before they
    are taken back out (`write_step`). Returns the attention output (B, 1,
    d).

    In a tensor-parallel step (`tensor_parallel.kv_shard` of the cache
    ``cache``, the name of ``cache_k``'s group in the model's cache) the
    caches are the rank's shard: its KV heads take the q heads that share
    them; a ring's slot and valid length are taken modulo the whole
    window (`KVShard.seq_len`, not the shard's positions); the new key
    and value are written only where the shard holds the slot (the slot
    less the shard's offset); the kernel attends over the shard's valid
    positions, the valid length less the offset, clipped to [0,
    S_local], and `KVShard.finish` combines the ranks' outputs by their
    log-sum-exps and gathers the heads."""
    b = x.shape[0]
    lengths = torch.as_tensor(length, device=x.device).expand(b)
    pos = lengths[:, None]                                  # absolute (B, 1)
    q, k_new, v_new = _project_qkv(p, x, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.d_head, None, cfg.rope_theta,
                                   cfg.qk_norm)
    q = rope(q, pos, cfg.rope_theta)
    k_new = rope(k_new, pos, cfg.rope_theta)
    s = cache_k.shape[1]
    shard = tp.kv_shard(cache)
    window = s if shard is None else shard.seq_len
    slot = lengths % window if ring else lengths
    new_len = (lengths + 1).clamp(max=window) if ring else lengths + 1
    if shard is not None:
        q, k_new, v_new = shard.local_heads(q, k_new, v_new)
        slot, new_len = shard.positions(slot, new_len, s)
    restore = write_step(((cache_k, k_new[:, 0]), (cache_v, v_new[:, 0])),
                         slot, (slot >= 0) & (slot < s), lanes, every_row)
    out = _attend(q[:, 0], cache_k, cache_v, new_len, shard)
    restore()
    return tp.matmul(out.reshape(b, 1, -1), p.wo)


def cross_attention_decode(p, x, mem_k, mem_v, cfg):
    """Decode-time cross-attention against the encoder's K/V. x: (B, 1,
    d); mem_k/v: (B, Ssrc, Hkv, D), projected once at prefill. Every row
    attends to all Ssrc positions. Writes nothing. Returns (B, 1, d).
    In a tensor-parallel step mem_k/v are the rank's shard
    (`tensor_parallel.kv_shard` of ``mem_k``): every local position is
    valid, and the ranks' outputs are combined as in
    `decode_attention_step`."""
    b = x.shape[0]
    q = tp.matmul(x, p.wq).reshape(b, 1, cfg.n_heads, cfg.d_head)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm)
    shard = tp.kv_shard("mem_k")
    if shard is not None:
        q = shard.local_q(q, cfg.n_kv_heads)
    lengths = torch.full((b,), mem_k.shape[1], dtype=torch.int32,
                         device=x.device)
    out = _attend(q[:, 0], mem_k, mem_v, lengths, shard)
    return tp.matmul(out.reshape(b, 1, -1), p.wo)


def project_memory_kv(p, memory, cfg):
    """The encoder memory's K/V for cross-attention (cached at prefill):
    (B, Ssrc, Hkv, D) each, qk-norm on k and no rope."""
    b, s, _ = memory.shape
    k = (memory @ p.wk).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = (memory @ p.wv).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        k = rms_norm(k, p.k_norm)
    return k, v
