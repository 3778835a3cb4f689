"""The dense-family LM (port of `repro.models.model`).

    build_model(cfg, seed, device)    -> Model, weights drawn from a seed
    Model.forward(tokens)             -> (logits, aux)       [eval]
    Model.init_cache(batch, max_len)  -> cache dict          [serving]
    Model.prefill(batch, cache)       -> last_logits  (cache in place)
    Model.decode_step(tokens, cache)  -> logits       (cache in place)

The weights live in the module, under the reference's names with the
layer axis unstacked: ``embed``, ``final_norm``, ``layers.<i>.ln1``,
``layers.<i>.attn.wq``, ..., ``layers.<i>.mlp.w_down``
(`repro_torch.interop.model_params` carries the reference's pytree
across). The reference's scan over stacked layers is a Python loop over
`layers`. The cache keeps the reference's layout: ``length`` (B,) int32
and ``kv`` with ``k``/``v`` leaves (L, B, S, Hkv, D). Decode writes it in
place, where the reference returns a new cache.

Only the dense family is ported; the others raise NotImplementedError.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, embed, init_embed, mlp, rms_norm, \
    unembed

_NOT_PORTED = ("the {family!r} family is not ported yet: it waits for the "
               "slice that brings the other model families (ROADMAP.md)")


class Block(torch.nn.Module):
    """One pre-norm attention + MLP layer."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype
        self.ln1 = torch.nn.Parameter(torch.zeros(d, dtype=dt, device=device),
                                      requires_grad=False)
        self.attn = attn.Attention(d, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                                   dt, cfg.qk_norm, device=device)
        self.ln2 = torch.nn.Parameter(torch.zeros(d, dtype=dt, device=device),
                                      requires_grad=False)
        self.mlp = MLP(d, cfg.d_ff, cfg.mlp_type, dt, device=device)

    def init(self, generator: torch.Generator) -> None:
        self.ln1.zero_()
        self.ln2.zero_()
        self.attn.init(generator)
        self.mlp.init(generator)


class Model(torch.nn.Module):
    def __init__(self, cfg: ModelConfig,
                 device: str | torch.device | None = None):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(_NOT_PORTED.format(family=cfg.family))
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = torch.nn.Parameter(
            torch.zeros(cfg.padded_vocab, cfg.d_model, dtype=cfg.dtype,
                        device=dev), requires_grad=False)
        self.final_norm = torch.nn.Parameter(
            torch.zeros(cfg.d_model, dtype=cfg.dtype, device=dev),
            requires_grad=False)
        self.layers = torch.nn.ModuleList(Block(cfg, dev)
                                          for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def init(self, seed: int = 0) -> "Model":
        """Draw every weight from a `torch.Generator` seeded with ``seed``
        on the model's device, with the reference's init: truncated normals
        scaled by fan-in^-0.5 (the embedding unscaled), zeros for the
        norms. The draws are not the reference's (`jax.random` streams do
        not exist in torch); tests carry the reference's weights across."""
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        self.embed.copy_(init_embed(g, *self.embed.shape, self.cfg.dtype))
        self.final_norm.zero_()
        for block in self.layers:
            block.init(g)
        return self

    # ------------------------------------------------------- full sequence
    def forward(self, tokens: torch.Tensor):
        """Logits (B, S, padded vocab) float32 for the full sequence
        (training-style pass), and the auxiliary loss (0 for dense)."""
        cfg = self.cfg
        x = embed(self.embed, tokens.to(self.device))
        for block in self.layers:
            x = x + attn.attention_block(block.attn, rms_norm(x, block.ln1),
                                         cfg)
            x = x + mlp(block.mlp, rms_norm(x, block.ln2), cfg.mlp_type)
        x = rms_norm(x, self.final_norm)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        return unembed(self.embed, x, cfg.vocab_size), aux

    # ------------------------------------------------------------ serving
    def init_cache(self, batch_size: int, max_len: int,
                   device: str | torch.device | None = None) -> dict:
        """Zero-initialized decode cache (dtype = cfg.dtype) on ``device``
        (the model's device when None; ``"meta"`` gives shapes only)."""
        cfg = self.cfg
        dev = self.device if device is None else torch.device(device)
        shp = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.d_head)
        return {"length": torch.zeros(batch_size, dtype=torch.int32,
                                      device=dev),
                "kv": {"k": torch.zeros(shp, dtype=cfg.dtype, device=dev),
                       "v": torch.zeros(shp, dtype=cfg.dtype, device=dev)}}

    def prefill(self, batch: dict, cache: dict):
        """Sequential prefill: feed tokens (B, S) one at a time through
        `decode_step`, which updates ``cache`` in place. Returns the logits
        of the last token."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        logits = None
        for t in range(tokens.shape[1]):
            logits = self.decode_step(tokens[:, t:t + 1], cache)
        return logits

    def decode_step(self, tokens: torch.Tensor, cache: dict,
                    lanes: torch.Tensor | None = None):
        """tokens: (B, 1). Returns the logits (B, padded vocab) float32.

        The cache is updated in place. ``lanes`` (B,) bool,
        when given, advances only those rows: the others' keys, values
        and lengths stay as they were (their logits are computed and
        meaningless). The reference steps every row and then merges the
        old cache back on the masked rows; writing only the active rows
        gives the same cache without a copy of it per step."""
        cfg = self.cfg
        x = embed(self.embed, tokens.to(self.device))
        length = cache["length"]
        ks, vs = cache["kv"]["k"], cache["kv"]["v"]
        for i, block in enumerate(self.layers):
            x = x + attn.decode_attention_step(
                block.attn, rms_norm(x, block.ln1), ks[i], vs[i], length, cfg,
                lanes=lanes)
            x = x + mlp(block.mlp, rms_norm(x, block.ln2), cfg.mlp_type)
        x = rms_norm(x, self.final_norm)
        logits = unembed(self.embed, x[:, 0], cfg.vocab_size)
        length += 1 if lanes is None else lanes.to(length.dtype)
        return logits


def build_model(cfg: ModelConfig, seed: int = 0,
                device: str | torch.device | None = None) -> Model:
    """A `Model` on ``device`` (None: the card) with weights drawn from
    ``seed``."""
    return Model(cfg, device).init(seed)
