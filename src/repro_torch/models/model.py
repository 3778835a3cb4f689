"""The six architecture families: dense, mixture-of-experts, SSM, hybrid,
encoder-decoder and VLM (port of `repro.models.model`).

    build_model(cfg, seed, device)        -> Model, weights drawn from a seed
    Model.loss(batch)                     -> (total, metrics)    [train]
    Model.forward(tokens, frontend=None)  -> (logits, aux)       [eval]
    Model.init_cache(batch, max_len)      -> cache dict          [serving]
    Model.prefill(batch, cache)           -> last_logits  (cache in place)
    Model.decode_step(tokens, cache)      -> logits       (cache in place)

The weights live in the module, under the reference's names with the
layer axis unstacked (`repro_torch.interop.model_params` carries the
reference's pytree across). Dense and VLM: ``embed``, ``final_norm``,
``layers.<i>.ln1``, ``layers.<i>.attn.wq``, ..., ``layers.<i>.mlp.w_down``.
Hybrid (recurrentgemma): super-blocks ``super.<i>.b<j>_<kind>`` over
``cfg.block_pattern`` (``kind`` "rglru" or "attn", each with ``ln1``,
``ln2``, ``mlp`` and its ``rglru`` or ``attn``), and a tail
``tail.0.b<j>_<kind>`` of the ``n_layers % len(pattern)`` layers left
(`decode_step` refuses a tail that holds an attention layer, as the
reference's tail decode does).
Encoder-decoder (whisper): ``encoder.<i>`` layers like the dense ones
(non-causal, no final norm) and ``decoder.<i>`` with ``ln1``,
``self_attn``, ``ln_x``, ``cross_attn``, ``ln2`` and ``mlp``. MoE
(dbrx, deepseek-v3): ``dense_layers.<i>`` like the dense ones (the first
``n_dense_layers``), then ``moe_layers.<i>`` with ``ln1``, ``attn`` (GQA,
or with ``cfg.use_mla`` multi-head latent attention: ``w_dq``, ...,
``wo``), ``ln2`` and ``moe`` (``router`` (d, E) float32, ``experts.w_*``
(E, fan-in, fan-out), ``shared.w_*``); with ``cfg.mtp`` also the
multi-token-prediction weights ``mtp.proj``, ``mtp.block.0.*`` and
``mtp.ln``, which only `loss` reads. SSM (mamba2): ``layers.<i>`` with
``ln`` and ``ssd`` (``in_proj``, ``conv_w``, ``conv_b``, ``a_log``,
``dt_bias``, ``d_skip``, ``out_norm``, ``out_proj``; the three (H,)
vectors float32). The reference's scans over stacked layers are Python
loops.

The weights are built with ``requires_grad=False``, so serving records
no graph; `repro_torch.train.loop.init_train_state` turns their
gradients on. `init` writes under `torch.no_grad`, and `prefill` and
`decode_step` run under it.

The stubbed frontends enter as ``frontend`` (``batch["frontend"]`` in
`prefill`): encdec, frame embeddings (B, src_len, d) that the encoder
turns into the memory whose K/V every decoder layer caches at prefill;
vlm, patch embeddings (B, n_patches, d) prepended to the tokens
(`forward` drops their logits; `prefill` feeds them one by one through
``decode_step(embeds=)``).

The cache keeps the reference's layout: ``length`` (B,) int32; dense and
vlm ``kv`` with ``k``/``v`` leaves (L, B, S, Hkv, D); hybrid ``conv``
(n_super, n_rec, B, 3, W) in ``cfg.dtype``, ``h`` (n_super, n_rec, B, W)
float32, ``kv`` with a ring of ``min(window, max_len)`` positions a
super-block attention layer, and ``tail_conv`` / ``tail_h`` for the
tail's recurrent layers; encdec ``kv`` and
``mem_k``/``mem_v`` (L, B, src_len, Hkv, D); moe ``dense_kv`` for the
dense layers, then ``moe_kv`` or, with MLA, ``ckv`` (L, B, S, kv_lora)
and ``kpe`` (L, B, S, rope_dim); ssm ``conv`` (L, B, W-1, d_inner + 2N)
in ``cfg.dtype`` and ``ssm`` (L, B, H, P, N) float32, whose size does
not depend on ``max_len``. Decode writes it in place, where the
reference returns a new cache.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, cross_entropy, dense_init, embed, \
    init_embed, init_rms, mlp, rms_norm, unembed

# the module lists whose layers the reference stacks on a leading axis
STACKS = ("layers", "super", "tail", "encoder", "decoder", "dense_layers",
          "moe_layers", "mtp.block")


def stacked_leaf(name: str) -> tuple[str, int, str] | None:
    """(stack, layer index, rest) of a parameter name ``<stack>.<i>.<rest>``
    that is the layer i slice of the reference's stacked ``<stack>.<rest>``
    (which has one more axis than the port's tensor); None for any other
    name."""
    for stack in STACKS:
        if name.startswith(stack + "."):
            index, _, rest = name[len(stack) + 1:].partition(".")
            if index.isdigit() and rest:
                return stack, int(index), rest
    return None


def reference_leaf(name: str) -> tuple[str, bool]:
    """The reference's leaf of a parameter name, and whether it is
    stacked (`stacked_leaf`); an unstacked name is its own leaf."""
    leaf = stacked_leaf(name)
    if leaf is None:
        return name, False
    return f"{leaf[0]}.{leaf[2]}", True


def _keep(old: torch.Tensor, new: torch.Tensor, lanes) -> None:
    """old <- new on the active lanes (batch axis 0 of both), in place."""
    if lanes is None:
        old.copy_(new)
    else:
        m = lanes.reshape(-1, *([1] * (new.dim() - 1)))
        old.copy_(torch.where(m, new, old))


class Block(torch.nn.Module):
    """One pre-norm attention + MLP layer."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype
        self.ln1 = init_rms(d, dt, device)
        self.attn = attn.Attention(d, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                                   dt, cfg.qk_norm, device=device)
        self.ln2 = init_rms(d, dt, device)
        self.mlp = MLP(d, cfg.d_ff, cfg.mlp_type, dt, device=device)

    def init(self, generator: torch.Generator) -> None:
        self.ln1.zero_()
        self.ln2.zero_()
        self.attn.init(generator)
        self.mlp.init(generator)


class DecoderBlock(torch.nn.Module):
    """One pre-norm decoder layer of the encoder-decoder family: causal
    self-attention, cross-attention to the encoder memory, then the MLP."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype

        def attention():
            return attn.Attention(d, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                                  dt, cfg.qk_norm, device=device)

        self.ln1 = init_rms(d, dt, device)
        self.self_attn = attention()
        self.ln_x = init_rms(d, dt, device)
        self.cross_attn = attention()
        self.ln2 = init_rms(d, dt, device)
        self.mlp = MLP(d, cfg.d_ff, cfg.mlp_type, dt, device=device)

    def init(self, generator: torch.Generator) -> None:
        for ln in (self.ln1, self.ln_x, self.ln2):
            ln.zero_()
        self.self_attn.init(generator)
        self.cross_attn.init(generator)
        self.mlp.init(generator)


class HybridLayer(torch.nn.Module):
    """One pre-norm layer of a hybrid super-block: an RG-LRU recurrent
    block (``kind`` "rglru") or a local attention (any other kind), then
    the MLP."""

    def __init__(self, cfg: ModelConfig, kind: str, device=None):
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype
        self.kind = kind
        self.ln1 = init_rms(d, dt, device)
        self.ln2 = init_rms(d, dt, device)
        self.mlp = MLP(d, cfg.d_ff, cfg.mlp_type, dt, device=device)
        if kind == "attn":
            self.attn = attn.Attention(d, cfg.n_heads, cfg.n_kv_heads,
                                       cfg.d_head, dt, cfg.qk_norm,
                                       device=device)
        else:
            self.rglru = rglru_mod.RGLRU(d, cfg.lru_width or d, dt,
                                         device=device)

    def init(self, generator: torch.Generator) -> None:
        self.ln1.zero_()
        self.ln2.zero_()
        (self.attn if self.kind == "attn" else self.rglru).init(generator)
        self.mlp.init(generator)


class SuperBlock(torch.nn.ModuleDict):
    """The layers of one pass over a block pattern, keyed ``b<j>_<kind>``
    as in the reference's pytree."""

    def __init__(self, cfg: ModelConfig, pattern, device=None):
        super().__init__({f"b{j}_{kind}": HybridLayer(cfg, kind, device)
                          for j, kind in enumerate(pattern)})


class MoEBlock(torch.nn.Module):
    """One pre-norm layer of the moe family: attention (GQA, or MLA with
    ``cfg.use_mla``), then the mixture of experts."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype
        self.ln1 = init_rms(d, dt, device)
        self.attn = mla_mod.MLA(cfg, device) if cfg.use_mla else \
            attn.Attention(d, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, dt,
                           cfg.qk_norm, device=device)
        self.ln2 = init_rms(d, dt, device)
        self.moe = moe_mod.MoE(cfg, device)

    def init(self, generator: torch.Generator) -> None:
        self.ln1.zero_()
        self.ln2.zero_()
        self.attn.init(generator)
        self.moe.init(generator)


class MTP(torch.nn.Module):
    """DeepSeek-V3's multi-token-prediction depth: ``proj`` (2d, d), one
    dense layer ``block.0`` and the norm ``ln``. Built so the weights
    match the reference's pytree; no serving step reads them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype
        self.proj = torch.nn.Parameter(
            torch.zeros(2 * d, d, dtype=dt, device=device),
            requires_grad=False)
        self.block = torch.nn.ModuleList([Block(cfg, device)])
        self.ln = init_rms(d, dt, device)

    def init(self, generator: torch.Generator) -> None:
        self.proj.copy_(dense_init(generator, *self.proj.shape,
                                   self.proj.dtype))
        self.block[0].init(generator)
        self.ln.zero_()


class SSMBlock(torch.nn.Module):
    """One pre-norm mamba2 layer: ``ln``, then the SSD block ``ssd``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln = init_rms(cfg.d_model, cfg.dtype, device)
        self.ssd = ssd_mod.SSD(cfg, device)

    def init(self, generator: torch.Generator) -> None:
        self.ln.zero_()
        self.ssd.init(generator)


class Model(torch.nn.Module):
    def __init__(self, cfg: ModelConfig,
                 device: str | torch.device | None = None):
        super().__init__()
        if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid",
                              "encdec"):
            raise ValueError(cfg.family)
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = torch.nn.Parameter(
            torch.zeros(cfg.padded_vocab, cfg.d_model, dtype=cfg.dtype,
                        device=dev), requires_grad=False)
        self.final_norm = init_rms(cfg.d_model, cfg.dtype, dev)
        if cfg.family in ("dense", "vlm"):
            self.layers = torch.nn.ModuleList(Block(cfg, dev)
                                              for _ in range(cfg.n_layers))
            return
        if cfg.family == "ssm":
            self.layers = torch.nn.ModuleList(SSMBlock(cfg, dev)
                                              for _ in range(cfg.n_layers))
            return
        if cfg.family == "moe":
            self.dense_layers = torch.nn.ModuleList(
                Block(cfg, dev) for _ in range(cfg.n_dense_layers))
            self.moe_layers = torch.nn.ModuleList(
                MoEBlock(cfg, dev)
                for _ in range(cfg.n_layers - cfg.n_dense_layers))
            if cfg.mtp:
                self.mtp = MTP(cfg, dev)
            return
        if cfg.family == "encdec":
            self.encoder = torch.nn.ModuleList(
                Block(cfg, dev) for _ in range(cfg.n_encoder_layers))
            self.decoder = torch.nn.ModuleList(
                DecoderBlock(cfg, dev) for _ in range(cfg.n_layers))
            return
        pat = cfg.block_pattern
        n_super, rem = divmod(cfg.n_layers, len(pat))
        self.super = torch.nn.ModuleList(SuperBlock(cfg, pat, dev)
                                         for _ in range(n_super))
        self.tail = torch.nn.ModuleList(
            [SuperBlock(cfg, pat[:rem], dev)] if rem else [])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def init(self, seed: int = 0) -> "Model":
        """Draw every weight from a `torch.Generator` seeded with ``seed``
        on the model's device, with the reference's init: truncated normals
        scaled by fan-in^-0.5 (the embedding unscaled), zeros for the
        norms. The draws are not the reference's (`jax.random` streams do
        not exist in torch); tests carry the reference's weights across.
        Writes in place without recording a graph, so it also works on a
        model whose gradients are on."""
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        self.embed.copy_(init_embed(g, *self.embed.shape, self.cfg.dtype))
        self.final_norm.zero_()
        if self.cfg.family == "hybrid":
            blocks = [layer for sb in (*self.super, *self.tail)
                      for layer in sb.values()]
        elif self.cfg.family == "encdec":
            blocks = [*self.encoder, *self.decoder]
        elif self.cfg.family == "moe":
            blocks = [*self.dense_layers, *self.moe_layers,
                      *([self.mtp] if self.cfg.mtp else [])]
        else:
            blocks = self.layers
        for block in blocks:
            block.init(g)
        return self

    def _frontend(self, frontend) -> torch.Tensor:
        """The stubbed frontend's embeddings on the model's device, in
        ``cfg.dtype``."""
        return torch.as_tensor(frontend, device=self.device).to(self.cfg.dtype)

    def _attn_mlp(self, blocks, x, causal=None):
        """Pre-norm attention + MLP layers over the full sequence (the
        reference's `_attn_mlp_scan`)."""
        cfg = self.cfg
        for block in blocks:
            x = x + attn.attention_block(block.attn, rms_norm(x, block.ln1),
                                         cfg, causal=causal)
            x = x + mlp(block.mlp, rms_norm(x, block.ln2), cfg.mlp_type)
        return x

    def _encode(self, frontend: torch.Tensor) -> torch.Tensor:
        """The encoder over the frame embeddings (B, src_len, d): non-causal
        self-attention with rope on the frame positions, no final norm."""
        return self._attn_mlp(self.encoder, frontend, causal=False)

    # ------------------------------------------------------- full sequence
    def _hidden(self, tokens, frontend=None):
        """The backbone's hidden states (B, S, d) before the final norm (the
        vlm patches' positions included), and the auxiliary loss (float32:
        the sum of the MoE layers' load-balancing losses, 0 for the other
        families)."""
        cfg = self.cfg
        x = embed(self.embed, torch.as_tensor(tokens, device=self.device))
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        if cfg.family == "vlm":
            x = torch.cat([self._frontend(frontend), x], dim=1)
        if cfg.family == "moe":
            x = self._attn_mlp(self.dense_layers, x)
            for block in self.moe_layers:
                hn = rms_norm(x, block.ln1)
                x = x + (mla_mod.mla_block(block.attn, hn, cfg) if cfg.use_mla
                         else attn.attention_block(block.attn, hn, cfg))
                m, aux_l = moe_mod.moe_block(block.moe,
                                             rms_norm(x, block.ln2), cfg)
                x = x + m
                aux = aux + aux_l
        elif cfg.family == "encdec":
            memory = self._encode(self._frontend(frontend))
            for block in self.decoder:
                x = x + attn.attention_block(block.self_attn,
                                             rms_norm(x, block.ln1), cfg)
                x = x + attn.attention_block(block.cross_attn,
                                             rms_norm(x, block.ln_x), cfg,
                                             memory=memory)
                x = x + mlp(block.mlp, rms_norm(x, block.ln2), cfg.mlp_type)
        elif cfg.family == "hybrid":
            for sb in (*self.super, *self.tail):
                for layer in sb.values():
                    hn = rms_norm(x, layer.ln1)
                    if layer.kind == "attn":
                        x = x + attn.attention_block(layer.attn, hn, cfg,
                                                     layer_window=cfg.window)
                    else:
                        x = x + rglru_mod.rglru_block(layer.rglru, hn, cfg)
                    x = x + mlp(layer.mlp, rms_norm(x, layer.ln2),
                                cfg.mlp_type)
        elif cfg.family == "ssm":
            for block in self.layers:
                x = x + ssd_mod.ssd_block(block.ssd, rms_norm(x, block.ln),
                                          cfg)
        else:
            x = self._attn_mlp(self.layers, x)
        return x, aux

    def _logits(self, h, frontend=None):
        """Final norm and the tied head over hidden states; a vlm's patch
        positions are dropped."""
        x = rms_norm(h, self.final_norm)
        if self.cfg.family == "vlm":
            x = x[:, frontend.shape[1]:]
        return unembed(self.embed, x, self.cfg.vocab_size)

    def forward(self, tokens: torch.Tensor, frontend=None):
        """Logits (B, S, padded vocab) float32 for the full sequence
        (training-style pass), and the auxiliary loss (float32: the sum
        of the MoE layers' load-balancing losses, 0 for the other
        families). ``frontend``: encdec, the frame embeddings the decoder
        cross-attends to (through the encoder); vlm, patch embeddings
        prepended to the tokens, whose logits are dropped."""
        h, aux = self._hidden(tokens, frontend)
        return self._logits(h, frontend), aux

    def loss(self, batch: dict):
        """Next-token loss of ``batch["tokens"]`` (B, S + 1), with
        ``batch["frontend"]`` for encdec and vlm: (total, metrics), where
        total = ce + aux (+ ``cfg.mtp_weight`` x the MTP loss for the moe
        family with ``cfg.mtp``) and metrics holds ``ce``, ``aux`` and
        ``mtp`` (float32 scalars)."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        frontend = batch.get("frontend")
        h, aux = self._hidden(tokens[:, :-1], frontend)
        ce = cross_entropy(self._logits(h, frontend), tokens[:, 1:])
        total = ce + aux
        metrics = {"ce": ce, "aux": aux}
        if cfg.family == "moe" and cfg.mtp:
            mtp_loss = self._mtp_loss(h, tokens)
            total = total + cfg.mtp_weight * mtp_loss
            metrics["mtp"] = mtp_loss
        return total, metrics

    def _mtp_loss(self, h, tokens):
        """DeepSeek-V3's multi-token prediction: one extra depth predicting
        token t+2 from the shared trunk's hidden state at t and the
        embedding of token t+1 (no final norm on its output)."""
        cfg = self.cfg
        nxt = embed(self.embed, tokens[:, 1:-1])
        merged = torch.cat([rms_norm(h[:, :-1], self.mtp.ln), nxt], dim=-1)
        x2 = self._attn_mlp(self.mtp.block, merged @ self.mtp.proj)
        return cross_entropy(unembed(self.embed, x2, cfg.vocab_size),
                             tokens[:, 2:])

    # ------------------------------------------------------------ serving
    def init_cache(self, batch_size: int, max_len: int,
                   device: str | torch.device | None = None) -> dict:
        """Zero-initialized decode cache (dtype = cfg.dtype) on ``device``
        (the model's device when None; ``"meta"`` gives shapes only)."""
        cfg = self.cfg
        dev = self.device if device is None else torch.device(device)

        def zeros(*shape, dtype=cfg.dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def kv(n_layers, s):
            shp = (n_layers, batch_size, s, cfg.n_kv_heads, cfg.d_head)
            return {"k": zeros(*shp), "v": zeros(*shp)}

        cache = {"length": zeros(batch_size, dtype=torch.int32)}
        if cfg.family in ("dense", "vlm"):
            cache["kv"] = kv(cfg.n_layers, max_len)
            return cache
        if cfg.family == "moe":
            n = cfg.n_layers - cfg.n_dense_layers
            if cfg.n_dense_layers:
                cache["dense_kv"] = kv(cfg.n_dense_layers, max_len)
            if cfg.use_mla:
                cache["ckv"] = zeros(n, batch_size, max_len, cfg.kv_lora_rank)
                cache["kpe"] = zeros(n, batch_size, max_len, cfg.qk_rope_dim)
            else:
                cache["moe_kv"] = kv(n, max_len)
            return cache
        if cfg.family == "encdec":
            cache["kv"] = kv(cfg.n_layers, max_len)
            mem = kv(cfg.n_layers, cfg.src_len)
            cache["mem_k"], cache["mem_v"] = mem["k"], mem["v"]
            return cache
        if cfg.family == "ssm":
            cache["conv"] = zeros(cfg.n_layers, batch_size, cfg.ssm_conv - 1,
                                  cfg.d_inner + 2 * cfg.ssm_state)
            cache["ssm"] = zeros(cfg.n_layers, batch_size, cfg.ssm_heads,
                                 cfg.ssm_headdim, cfg.ssm_state,
                                 dtype=torch.float32)
            return cache
        pat = cfg.block_pattern
        n_super, rem = divmod(cfg.n_layers, len(pat))
        w = cfg.lru_width or cfg.d_model
        n_rec = sum(1 for kind in pat if kind != "attn")
        win = min(cfg.window or max_len, max_len)
        cache["conv"] = zeros(n_super, n_rec, batch_size, 3, w)
        cache["h"] = zeros(n_super, n_rec, batch_size, w,
                           dtype=torch.float32)
        cache["kv"] = kv(n_super * (len(pat) - n_rec), win)
        if rem:                     # the tail's recurrent layers; no tail KV
            n_tail = sum(1 for kind in pat[:rem] if kind != "attn")
            cache["tail_conv"] = zeros(1, n_tail, batch_size, 3, w)
            cache["tail_h"] = zeros(1, n_tail, batch_size, w,
                                    dtype=torch.float32)
        return cache

    @torch.no_grad()
    def prefill(self, batch: dict, cache: dict):
        """Sequential prefill: feed tokens (B, S) one at a time through
        `decode_step`, which updates ``cache`` in place. Returns the logits
        of the last token. The stubbed frontend's ``batch["frontend"]`` is
        ingested first: encdec encodes it and writes every decoder layer's
        memory K/V into ``mem_k``/``mem_v`` (every row); vlm feeds its
        patches through ``decode_step(embeds=)``, each advancing
        ``length``."""
        cfg = self.cfg
        if cfg.family == "encdec":
            memory = self._encode(self._frontend(batch["frontend"]))
            for i, block in enumerate(self.decoder):
                k, v = attn.project_memory_kv(block.cross_attn, memory, cfg)
                cache["mem_k"][i].copy_(k)
                cache["mem_v"][i].copy_(v)
        if cfg.family == "vlm" and batch.get("frontend") is not None:
            patches = self._frontend(batch["frontend"])
            for t in range(patches.shape[1]):
                self.decode_step(None, cache, embeds=patches[:, t:t + 1])
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        logits = None
        for t in range(tokens.shape[1]):
            logits = self.decode_step(tokens[:, t:t + 1], cache)
        return logits

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor | None, cache: dict,
                    lanes: torch.Tensor | None = None,
                    embeds: torch.Tensor | None = None):
        """tokens: (B, 1), or None with ``embeds`` (B, 1, d) in
        ``cfg.dtype`` (a frontend prefix fed through the decode path).
        Returns the logits (B, padded vocab) float32.

        The cache is updated in place. ``lanes`` (B,) bool,
        when given, advances only those rows: the others' keys, values,
        recurrent state and lengths stay as they were (their logits are computed and
        meaningless). The reference steps every row and then merges the
        old cache back on the masked rows; writing only the active rows
        gives the same cache without a copy of it per step. An encdec
        step reads ``mem_k``/``mem_v`` and writes neither. In the moe
        family the rows outside ``lanes`` still route: their tokens take
        part in their row's dispatch and capacity as in the reference's
        full-batch step, so they attend with this step's key and value,
        taken back out of their cache after the attention, and their
        logits are the reference's."""
        cfg = self.cfg
        x = embed(self.embed, tokens.to(self.device)) if embeds is None \
            else embeds
        length = cache["length"]
        if cfg.family == "hybrid":
            x = self._decode_hybrid(x, cache, lanes)
        elif cfg.family == "ssm":
            for i, block in enumerate(self.layers):
                y, conv, ssm = ssd_mod.ssd_decode_step(
                    block.ssd, rms_norm(x, block.ln), cache["conv"][i],
                    cache["ssm"][i], cfg)
                _keep(cache["conv"][i], conv, lanes)
                _keep(cache["ssm"][i], ssm, lanes)
                x = x + y
        elif cfg.family == "moe":
            x = self._decode_moe(x, cache, lanes)
        elif cfg.family == "encdec":
            ks, vs = cache["kv"]["k"], cache["kv"]["v"]
            for i, block in enumerate(self.decoder):
                x = x + attn.decode_attention_step(
                    block.self_attn, rms_norm(x, block.ln1), ks[i], vs[i],
                    length, cfg, lanes=lanes)
                x = x + attn.cross_attention_decode(
                    block.cross_attn, rms_norm(x, block.ln_x),
                    cache["mem_k"][i], cache["mem_v"][i], cfg)
                x = x + mlp(block.mlp, rms_norm(x, block.ln2), cfg.mlp_type)
        else:
            ks, vs = cache["kv"]["k"], cache["kv"]["v"]
            for i, block in enumerate(self.layers):
                x = x + attn.decode_attention_step(
                    block.attn, rms_norm(x, block.ln1), ks[i], vs[i], length,
                    cfg, lanes=lanes)
                x = x + mlp(block.mlp, rms_norm(x, block.ln2), cfg.mlp_type)
        x = rms_norm(x, self.final_norm)
        logits = unembed(self.embed, x[:, 0], cfg.vocab_size)
        length += 1 if lanes is None else lanes.to(length.dtype)
        return logits

    def _decode_moe(self, x, cache: dict, lanes):
        """The dense layers (``dense_kv``) and the MoE layers for one
        token: GQA through `decode_attention_step` (the `decode_attn`
        kernel on the card) over ``dense_kv`` / ``moe_kv``, or MLA's
        absorbed decode (plain products) over ``ckv``/``kpe``; every
        row's token goes through `moe_block`."""
        cfg = self.cfg
        length = cache["length"]
        if cfg.n_dense_layers:
            ks, vs = cache["dense_kv"]["k"], cache["dense_kv"]["v"]
            for i, block in enumerate(self.dense_layers):
                x = x + attn.decode_attention_step(
                    block.attn, rms_norm(x, block.ln1), ks[i], vs[i], length,
                    cfg, lanes=lanes, every_row=True)
                x = x + mlp(block.mlp, rms_norm(x, block.ln2), cfg.mlp_type)
        if not cfg.use_mla:
            ks, vs = cache["moe_kv"]["k"], cache["moe_kv"]["v"]
        for i, block in enumerate(self.moe_layers):
            hn = rms_norm(x, block.ln1)
            if cfg.use_mla:
                x = x + mla_mod.mla_decode_step(
                    block.attn, hn, cache["ckv"][i], cache["kpe"][i], length,
                    cfg, lanes=lanes, every_row=True)
            else:
                x = x + attn.decode_attention_step(
                    block.attn, hn, ks[i], vs[i], length, cfg, lanes=lanes,
                    every_row=True)
            m, _ = moe_mod.moe_block(block.moe, rms_norm(x, block.ln2), cfg)
            x = x + m
        return x

    def _decode_hybrid(self, x, cache: dict, lanes):
        """The super-blocks' and the tail's layers for one token. The
        attention layers decode through `decode_attention_step(ring=True)`
        (the `decode_attn` kernel on the card) and write their ring slot
        on ``lanes``; the recurrent layers' ``conv`` and ``h`` state moves
        only on ``lanes`` too (an idle lane's state would otherwise advance
        for good). A tail that holds an attention layer raises
        NotImplementedError: the cache keeps no KV for it, and the
        reference's tail decode runs recurrent layers only (it raises
        KeyError there)."""
        cfg = self.cfg
        if any(layer.kind == "attn" for sb in self.tail
               for layer in sb.values()):
            raise NotImplementedError(
                "hybrid decode: the tail holds an attention layer, which "
                "has no KV cache (the reference's tail decode runs "
                "recurrent layers only)")
        length = cache["length"]
        ks, vs = cache["kv"]["k"], cache["kv"]["v"]
        ai = 0
        for blocks, conv, hst in ((self.super, cache["conv"], cache["h"]),
                                  (self.tail, cache.get("tail_conv"),
                                   cache.get("tail_h"))):
            for s, sb in enumerate(blocks):
                ri = 0
                for layer in sb.values():
                    hn = rms_norm(x, layer.ln1)
                    if layer.kind == "attn":
                        x = x + attn.decode_attention_step(
                            layer.attn, hn, ks[ai], vs[ai], length, cfg,
                            ring=True, lanes=lanes)
                        ai += 1
                    else:
                        t, nc, nh = rglru_mod.rglru_decode_step(
                            layer.rglru, hn, conv[s, ri], hst[s, ri], cfg)
                        _keep(conv[s, ri], nc, lanes)
                        _keep(hst[s, ri], nh, lanes)
                        x = x + t
                        ri += 1
                    x = x + mlp(layer.mlp, rms_norm(x, layer.ln2),
                                cfg.mlp_type)
        return x


def build_model(cfg: ModelConfig, seed: int = 0,
                device: str | torch.device | None = None) -> Model:
    """A `Model` on ``device`` (None: the card) with weights drawn from
    ``seed``."""
    return Model(cfg, device).init(seed)
