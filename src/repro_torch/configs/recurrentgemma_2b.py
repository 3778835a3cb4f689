"""recurrentgemma-2b [hybrid]: 26 blocks d_model=2560 10H (MQA kv=1)
d_ff=7680, RG-LRU + local attention (window 2048), pattern
(recurrent, recurrent, attention) = 8 super-blocks + 2 trailing recurrent.
[arXiv:2402.19427; hf]"""

from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid", n_layers=26,
        d_model=2560, n_heads=10, n_kv_heads=1, d_head=256, d_ff=7680,
        vocab_size=256000, mlp_type="swiglu", window=2048,
        block_pattern=("rglru", "rglru", "attn"), lru_width=2560)


def smoke() -> ModelConfig:
    return full().replace(name="recurrentgemma-2b-smoke", n_layers=5,
                          d_model=64, n_heads=4, n_kv_heads=1, d_head=16,
                          d_ff=128, vocab_size=512, window=16,
                          lru_width=64, q_block=64)
