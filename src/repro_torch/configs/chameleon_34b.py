"""chameleon-34b [vlm]: early-fusion VQ image tokens, QK-norm
(arXiv:2405.09818 §2.2: QK-norm steadies mixed-modal training; the unified
65536 vocabulary holds the 8192 VQ codes)."""

from repro_torch.configs.base import ModelConfig, attn


def config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b",
        arch_type="vlm",
        source="arXiv:2405.09818",
        d_model=8192,
        vocab_size=65536,
        pattern=(attn(),),
        repeats=48,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        qk_norm=True,
        d_ff=22016,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b-smoke",
        arch_type="vlm",
        source="arXiv:2405.09818",
        d_model=128,
        vocab_size=512,
        pattern=(attn(),),
        repeats=2,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        qk_norm=True,
        d_ff=256,
        dtype="float32",
    )
