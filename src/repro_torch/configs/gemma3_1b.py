"""gemma3-1b [dense]: 5:1 local:global SWA (hf:google/gemma-3-1b-pt:
26 layers, d=1152, 4 Q / 1 KV heads, head_dim 256, ffn 6912, vocab 262144,
sliding_window 512, local rope 10k / global rope 1M)."""

from repro_torch.configs.base import ModelConfig, attn

_L = attn(window=512, rope_theta=10_000.0)  # local SWA layer
_G = attn(rope_theta=1_000_000.0)  # global layer


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b",
        arch_type="dense",
        source="hf:google/gemma-3-1b-pt",
        d_model=1152,
        vocab_size=262144,
        pattern=(_L, _L, _L, _L, _L, _G),
        repeats=4,
        tail=(_L, _L),
        n_heads=4,
        n_kv_heads=1,
        head_dim=256,
        d_ff=6912,
        mlp_act="gelu",
        qk_norm=True,
        tie_embeddings=True,
        subquadratic=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b-smoke",
        arch_type="dense",
        source="hf:google/gemma-3-1b-pt",
        d_model=128,
        vocab_size=512,
        pattern=(attn(window=16, rope_theta=1e4), attn(rope_theta=1e6)),
        repeats=1,
        n_heads=4,
        n_kv_heads=1,
        head_dim=32,
        d_ff=256,
        mlp_act="gelu",
        qk_norm=True,
        tie_embeddings=True,
        subquadratic=True,
        dtype="float32",
    )
