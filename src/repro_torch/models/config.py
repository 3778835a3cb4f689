"""Unified architecture configuration for the assigned-model zoo.

A transliteration of the reference's `ModelConfig`: the same fields,
defaults and analytic `param_count` for every family (the router sizes
requests of any architecture from it); ``dtype`` is a torch dtype."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0              # 0 -> d_model // n_heads
    vocab_pad_to: int = 512

    # attention
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    window: int = 0              # sliding-window size (0 = full attention)
    causal: bool = True

    # mlp
    mlp_type: str = "swiglu"     # swiglu | gelu | relu2

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_dense_layers: int = 0      # leading dense layers (deepseek-v3: 3)
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-3

    # MLA (deepseek-v3)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # multi-token prediction (deepseek-v3 MTP)
    mtp: bool = False
    mtp_weight: float = 0.3

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssd_chunk: int = 128

    # hybrid (recurrentgemma): repeating block pattern + remainder
    block_pattern: tuple = ()    # e.g. ("rglru", "rglru", "attn")
    lru_width: int = 0

    # encoder-decoder (whisper)
    n_encoder_layers: int = 0
    src_len: int = 1536          # frontend-stub sequence length (padded)

    # VLM (internvl2): prepended patch embeddings from the stub frontend
    n_patches: int = 0

    dtype: torch.dtype = torch.bfloat16
    # attention q-block for chunked (FlashAttention-style) computation
    q_block: int = 512
    # FSDP parameter storage for training (fan-in over data axes); only
    # for configs whose params exceed tensor-parallel-only device memory.
    # Read by the distributed layer, which the port does not have yet.
    fsdp_train: bool = False

    def __post_init__(self):
        if self.d_head == 0 and self.n_heads:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab_size + p - 1) // p) * p

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (for roofline MODEL_FLOPS = 6*N*D) ----
    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count; active_only counts top-k routed experts
        only (MoE activated parameters)."""
        d, V = self.d_model, self.padded_vocab
        n = V * d  # embedding
        n += d     # final norm

        def attn_params():
            if self.use_mla:
                qr, kvr = self.q_lora_rank, self.kv_lora_rank
                dn, dr, dv = self.qk_nope_dim, self.qk_rope_dim, self.v_head_dim
                H = self.n_heads
                return (d * qr + qr * H * (dn + dr) + d * (kvr + dr)
                        + kvr * H * (dn + dv) + H * dv * d + qr + kvr)
            dh = self.d_head
            return d * dh * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * dh * d \
                + (2 * dh if self.qk_norm else 0)

        def mlp_params(ff):
            mult = 3 if self.mlp_type == "swiglu" else 2
            return mult * d * ff

        def moe_params(active):
            e = self.top_k if active else self.n_experts
            p = d * self.n_experts  # router (always resident)
            p += e * mlp_params(self.d_ff_expert) / 1  # routed
            p += self.n_shared_experts * mlp_params(self.d_ff_expert)
            return int(p)

        def ssd_params():
            di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
            G = 1
            proj_in = d * (2 * di + 2 * G * N + H)
            conv = self.ssm_conv * (di + 2 * G * N)
            return proj_in + conv + 3 * H + di + di * d

        def rglru_params():
            w = self.lru_width or d
            return 2 * d * w + 3 * w * w // 1 + w * d + 2 * w  # approx

        per_layer_norms = 2 * d
        total = 0
        if self.family in ("dense", "vlm"):
            total = self.n_layers * (attn_params() + mlp_params(self.d_ff)
                                     + per_layer_norms)
        elif self.family == "moe":
            dense = self.n_dense_layers
            moe_l = self.n_layers - dense
            total = dense * (attn_params() + mlp_params(self.d_ff)
                             + per_layer_norms)
            total += moe_l * (attn_params() + moe_params(active_only)
                              + per_layer_norms)
        elif self.family == "ssm":
            total = self.n_layers * (ssd_params() + d)
        elif self.family == "hybrid":
            n_attn = sum(1 for i in range(self.n_layers)
                         if self.block_pattern[i % len(self.block_pattern)] == "attn")
            n_rec = self.n_layers - n_attn
            total = (n_attn * attn_params() + n_rec * rglru_params()
                     + self.n_layers * (mlp_params(self.d_ff) + per_layer_norms))
        elif self.family == "encdec":
            enc = self.n_encoder_layers * (attn_params() + mlp_params(self.d_ff)
                                           + per_layer_norms)
            dec = self.n_layers * (2 * attn_params() + mlp_params(self.d_ff)
                                   + 3 * d)
            total = enc + dec
        return int(total + n + d)
