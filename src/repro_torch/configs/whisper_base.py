"""whisper-base [audio enc-dec]: 6L encoder + 6L decoder, d_model=512 8H
d_ff=2048 vocab=51865; conv frontend STUBBED — input_specs() provides
precomputed frame embeddings (1500 frames padded to 1536).
[arXiv:2212.04356; unverified]

Positional scheme: rope replaces whisper's learned/sinusoidal embeddings
(shape-equivalent; noted in DESIGN.md §9)."""

from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="encdec", n_layers=6,
        n_encoder_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
        d_ff=2048, vocab_size=51865, mlp_type="gelu", src_len=1536)


def smoke() -> ModelConfig:
    return full().replace(name="whisper-base-smoke", n_layers=2,
                          n_encoder_layers=2, d_model=64, n_heads=4,
                          n_kv_heads=4, d_ff=128, vocab_size=512,
                          src_len=32, q_block=64)
