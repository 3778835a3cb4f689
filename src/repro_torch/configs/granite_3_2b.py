"""granite-3-2b [dense]: 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155. [hf:ibm-granite/granite-3.0-2b-base; hf]"""

from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b", family="dense", n_layers=40, d_model=2048,
        n_heads=32, n_kv_heads=8, d_ff=8192, vocab_size=49155,
        mlp_type="swiglu", rope_theta=10_000.0)


def smoke() -> ModelConfig:
    return full().replace(name="granite-3-2b-smoke", n_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
                          q_block=64)
