"""mixtral-8x7b [moe]: 8 experts, top-2, sliding-window attention
(arXiv:2401.04088; window 4096 as in the Mistral-7B base architecture)."""

from repro_torch.configs.base import ModelConfig, attn


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        arch_type="moe",
        source="arXiv:2401.04088",
        d_model=4096,
        vocab_size=32000,
        pattern=(attn(moe=True, window=4096),),
        repeats=32,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        n_experts=8,
        experts_per_token=2,
        d_ff_expert=14336,
        capacity_factor=1.25,
        rope_theta=1e6,
        subquadratic=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b-smoke",
        arch_type="moe",
        source="arXiv:2401.04088",
        d_model=128,
        vocab_size=512,
        pattern=(attn(moe=True, window=16),),
        repeats=2,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        n_experts=4,
        experts_per_token=2,
        d_ff_expert=256,
        capacity_factor=2.0,
        subquadratic=True,
        dtype="float32",
    )
