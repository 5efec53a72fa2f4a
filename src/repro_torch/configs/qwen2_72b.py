"""qwen2-72b [dense]: GQA 64/8, QKV bias (arXiv:2407.10671 Table 1)."""

from repro_torch.configs.base import ModelConfig, attn


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b",
        arch_type="dense",
        source="arXiv:2407.10671",
        d_model=8192,
        vocab_size=152064,
        pattern=(attn(),),
        repeats=80,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        qkv_bias=True,
        d_ff=29568,
        rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b-smoke",
        arch_type="dense",
        source="arXiv:2407.10671",
        d_model=128,
        vocab_size=512,
        pattern=(attn(),),
        repeats=2,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        qkv_bias=True,
        d_ff=256,
        rope_theta=1e6,
        dtype="float32",
    )
