"""musicgen-medium [audio]: decoder-only over EnCodec tokens
(arXiv:2306.05284: 48 layers, d=1536, 24 heads, 4 codebooks x 2048, the
delay pattern; the T5 text conditioning stubbed as a 64-step embedding
prefix). MusicGen's LayerNorm/GELU blocks are realized with this
package's RMSNorm/gated-MLP decoder blocks, as in the JAX package."""

from repro_torch.configs.base import ModelConfig, attn


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        arch_type="audio",
        source="arXiv:2306.05284",
        d_model=1536,
        vocab_size=2048,
        pattern=(attn(),),
        repeats=48,
        n_heads=24,
        n_kv_heads=24,
        head_dim=64,
        d_ff=6144,
        n_codebooks=4,
        cond_len=64,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium-smoke",
        arch_type="audio",
        source="arXiv:2306.05284",
        d_model=128,
        vocab_size=256,
        pattern=(attn(),),
        repeats=2,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,
        d_ff=256,
        n_codebooks=4,
        cond_len=8,
        dtype="float32",
    )
