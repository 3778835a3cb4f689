"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, 16 experts top-4, fine-grained.
[hf:databricks/dbrx-base; unverified]"""

from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe", n_layers=40, d_model=6144,
        n_heads=48, n_kv_heads=8, d_ff=10752, vocab_size=100352,
        n_experts=16, top_k=4, d_ff_expert=10752, mlp_type="swiglu",
        fsdp_train=True,
        rope_theta=500_000.0)


def smoke() -> ModelConfig:
    return full().replace(
        name="dbrx-132b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, d_ff_expert=128, vocab_size=512,
        n_experts=4, top_k=2, q_block=64)
