"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff=2048(expert)
vocab=129280; MLA (q_lora 1536, kv_lora 512, nope 128, rope 64, v 128);
1 shared + 256 routed experts top-8; first 3 layers dense (d_ff 18432);
MTP. [arXiv:2412.19437; hf]"""

from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe", n_layers=61, d_model=7168,
        n_heads=128, n_kv_heads=128, d_ff=18432, vocab_size=129280,
        n_experts=256, n_shared_experts=1, top_k=8, d_ff_expert=2048,
        n_dense_layers=3, mlp_type="swiglu",
        fsdp_train=True,
        use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        mtp=True, rope_theta=10_000.0)


def smoke() -> ModelConfig:
    return full().replace(
        name="deepseek-v3-671b-smoke", n_layers=3, n_dense_layers=1,
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512,
        n_experts=4, top_k=2, d_ff_expert=32, q_lora_rank=32,
        kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        q_block=64)
