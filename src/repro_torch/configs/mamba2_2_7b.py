"""mamba2-2.7b [ssm]: 64L d_model=2560 (attention-free) vocab=50280,
SSD with ssm_state=128, headdim 64, expand 2 (d_inner=5120, 80 heads).
[arXiv:2405.21060; unverified]"""

from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
        n_heads=0, n_kv_heads=0, d_head=0, d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_expand=2, ssm_headdim=64, ssd_chunk=128)


def smoke() -> ModelConfig:
    return full().replace(name="mamba2-2.7b-smoke", n_layers=2, d_model=64,
                          vocab_size=512, ssm_state=16, ssm_headdim=16,
                          ssd_chunk=32)
