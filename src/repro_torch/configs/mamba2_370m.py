"""mamba2-370m [ssm]: SSD, attention-free (arXiv:2405.21060, Table 4:
48 layers, d=1024, d_inner 2048, 32 heads of 64, state 128, 1 group,
conv 4, chunk 256, vocab 50280, tied embeddings)."""

from repro_torch.configs.base import ModelConfig, mamba


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        arch_type="ssm",
        source="arXiv:2405.21060",
        d_model=1024,
        vocab_size=50280,
        pattern=(mamba(),),
        repeats=48,
        d_ff=0,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_groups=1,
        ssm_conv=4,
        ssm_chunk=256,
        tie_embeddings=True,  # mamba2 ties in/out embeddings
        subquadratic=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m-smoke",
        arch_type="ssm",
        source="arXiv:2405.21060",
        d_model=128,
        vocab_size=512,
        pattern=(mamba(),),
        repeats=2,
        d_ff=0,
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=32,
        ssm_groups=1,
        ssm_conv=4,
        ssm_chunk=16,
        tie_embeddings=True,
        subquadratic=True,
        dtype="float32",
    )
