"""jamba-v0.1-52b [hybrid]: Mamba and attention interleaved 7:1, MoE on every
second layer (arXiv:2403.19887: attention period 8 offset 4; expert period 2
offset 1; 16 experts, top-2). Jamba's Mamba-1 mixer is adapted to the SSD
(Mamba-2) scan, as in the JAX package."""

from repro_torch.configs.base import ModelConfig, attn, mamba

# one period of 8 layers: attention at index 4, MoE on the odd indices
_PERIOD = (
    mamba(),
    mamba(moe=True),
    mamba(),
    mamba(moe=True),
    attn(),
    mamba(moe=True),
    mamba(),
    mamba(moe=True),
)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        arch_type="hybrid",
        source="arXiv:2403.19887",
        d_model=4096,
        vocab_size=65536,
        pattern=_PERIOD,
        repeats=4,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        n_experts=16,
        experts_per_token=2,
        d_ff_expert=14336,
        capacity_factor=1.25,
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_groups=1,
        ssm_conv=4,
        ssm_chunk=256,
        subquadratic=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b-smoke",
        arch_type="hybrid",
        source="arXiv:2403.19887",
        d_model=128,
        vocab_size=512,
        pattern=(mamba(), mamba(moe=True), attn(), mamba(moe=True)),
        repeats=1,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        n_experts=4,
        experts_per_token=2,
        d_ff_expert=256,
        capacity_factor=2.0,
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=32,
        ssm_groups=1,
        ssm_conv=4,
        ssm_chunk=16,
        subquadratic=True,
        dtype="float32",
    )
