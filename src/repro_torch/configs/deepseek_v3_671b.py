"""deepseek-v3-671b [moe]: MLA, 1 shared + 256 routed experts top-8, MTP
(arXiv:2412.19437 §2: 61 layers, d=7168, the first 3 dense, 128 heads,
q rank 1536, kv rank 512, qk 128 + 64 rope, v 128, vocab 129280)."""

from repro_torch.configs.base import ModelConfig, attn


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        arch_type="moe",
        source="arXiv:2412.19437",
        d_model=7168,
        vocab_size=129280,
        lead=(attn(),) * 3,  # first_k_dense_replace = 3
        pattern=(attn(moe=True),),
        repeats=58,
        n_heads=128,
        use_mla=True,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        d_ff=18432,  # the dense layers' FFN
        n_experts=256,
        experts_per_token=8,
        d_ff_expert=2048,
        n_shared_experts=1,
        capacity_factor=1.25,
        mtp=True,
        rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b-smoke",
        arch_type="moe",
        source="arXiv:2412.19437",
        d_model=128,
        vocab_size=512,
        lead=(attn(),),
        pattern=(attn(moe=True),),
        repeats=2,
        n_heads=4,
        use_mla=True,
        q_lora_rank=48,
        kv_lora_rank=32,
        qk_nope_dim=32,
        qk_rope_dim=16,
        v_head_dim=32,
        d_ff=256,
        n_experts=4,
        experts_per_token=2,
        d_ff_expert=64,
        n_shared_experts=1,
        capacity_factor=2.0,
        mtp=True,
        dtype="float32",
    )
