"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936, per-head qk RMSNorm, head_dim=128. [hf:Qwen/Qwen3-8B; hf]"""

from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b", family="dense", n_layers=64, d_model=5120,
        n_heads=64, n_kv_heads=8, d_head=128, d_ff=25600, vocab_size=151936,
        qk_norm=True, mlp_type="swiglu", rope_theta=1_000_000.0)


def smoke() -> ModelConfig:
    return full().replace(name="qwen3-32b-smoke", n_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
                          vocab_size=512, q_block=64)
