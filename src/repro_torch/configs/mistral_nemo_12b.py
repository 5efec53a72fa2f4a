"""mistral-nemo-12b [dense]: 128k context (hf:mistralai/Mistral-Nemo-Base-2407:
40 layers, d=5120, 32/8 heads, head_dim 128 (explicit, != d/H), ffn 14336,
vocab 131072, rope 1e6, full attention)."""

from repro_torch.configs.base import ModelConfig, attn


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b",
        arch_type="dense",
        source="hf:mistralai/Mistral-Nemo-Base-2407",
        d_model=5120,
        vocab_size=131072,
        pattern=(attn(),),
        repeats=40,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b-smoke",
        arch_type="dense",
        source="hf:mistralai/Mistral-Nemo-Base-2407",
        d_model=128,
        vocab_size=512,
        pattern=(attn(),),
        repeats=2,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        rope_theta=1e6,
        dtype="float32",
    )
