"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000, squared-ReLU MLP. [arXiv:2402.16819; unverified]"""

from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b", family="dense", n_layers=32, d_model=6144,
        n_heads=48, n_kv_heads=8, d_ff=24576, vocab_size=256000,
        mlp_type="relu2", rope_theta=10_000.0)


def smoke() -> ModelConfig:
    return full().replace(name="nemotron-4-15b-smoke", n_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
                          q_block=64)
