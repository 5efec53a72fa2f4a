"""granite-20b [dense]: llama-architecture code model, MQA (arXiv:2405.04324:
granite-20b-code 52 layers, d=6144, 48 heads, MQA kv=1, ffn 24576, vocab
49152)."""

from repro_torch.configs.base import ModelConfig, attn


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b",
        arch_type="dense",
        source="arXiv:2405.04324",
        d_model=6144,
        vocab_size=49152,
        pattern=(attn(),),
        repeats=52,
        n_heads=48,
        n_kv_heads=1,
        head_dim=128,
        d_ff=24576,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b-smoke",
        arch_type="dense",
        source="arXiv:2405.04324",
        d_model=128,
        vocab_size=512,
        pattern=(attn(),),
        repeats=2,
        n_heads=4,
        n_kv_heads=1,
        head_dim=32,
        d_ff=256,
        dtype="float32",
    )
