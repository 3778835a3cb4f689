"""internvl2-76b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 LLaMA-3-70B-style backbone; InternViT frontend STUBBED —
input_specs() provides precomputed patch embeddings (256 patches).
[arXiv:2404.16821; unverified]"""

from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b", family="vlm", n_layers=80, d_model=8192,
        n_heads=64, n_kv_heads=8, d_head=128, d_ff=28672,
        vocab_size=128256, mlp_type="swiglu", rope_theta=500_000.0,
        fsdp_train=True,
        n_patches=256)


def smoke() -> ModelConfig:
    return full().replace(name="internvl2-76b-smoke", n_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
                          vocab_size=512, n_patches=8, q_block=64)
