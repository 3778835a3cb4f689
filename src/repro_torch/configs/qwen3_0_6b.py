"""qwen3-0.6b [dense]: 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936, per-head qk RMSNorm, head_dim=128 (qwen3 family).
[hf:Qwen/Qwen3-8B; hf]"""

from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b", family="dense", n_layers=28, d_model=1024,
        n_heads=16, n_kv_heads=8, d_head=128, d_ff=3072, vocab_size=151936,
        qk_norm=True, mlp_type="swiglu", rope_theta=1_000_000.0)


def smoke() -> ModelConfig:
    return full().replace(name="qwen3-0.6b-smoke", n_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
                          vocab_size=512, q_block=64)
