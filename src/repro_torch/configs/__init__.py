"""Config registry of the port.

``get_config("gemma3-1b")`` is the full model, ``smoke=True`` its reduced
variant for CPU tests. The port knows eight of the JAX package's ten
architectures: the dense ones (tied or untied head), the MoE ones and the
Mamba-2 ones. The other two need layers (MLA and the MTP head; the
multi-codebook head and the conditioning stub) that a later slice ports, so
asking for one raises ``NotImplementedError`` naming ROADMAP item 14.
"""

from __future__ import annotations

from repro_torch.configs import (
    chameleon_34b,
    gemma3_1b,
    granite_20b,
    jamba_v01_52b,
    mamba2_370m,
    mistral_nemo_12b,
    mixtral_8x7b,
    qwen2_72b,
)
from repro_torch.configs.base import (
    INPUT_SHAPES,
    InputShape,
    LayerSpec,
    ModelConfig,
    attn,
    mamba,
)

ARCHS = {
    "gemma3-1b": gemma3_1b,
    "mamba2-370m": mamba2_370m,
    "qwen2-72b": qwen2_72b,
    "mistral-nemo-12b": mistral_nemo_12b,
    "granite-20b": granite_20b,
    "chameleon-34b": chameleon_34b,
    "mixtral-8x7b": mixtral_8x7b,
    "jamba-v0.1-52b": jamba_v01_52b,
}

# architectures of the JAX package and the port slice that brings each one
LATER_SLICES = {
    "deepseek-v3-671b": "the LM training-stack slice (MLA, MTP; ROADMAP item 14)",
    "musicgen-medium": (
        "the LM training-stack slice (multi-codebook heads, conditioning; "
        "ROADMAP item 14)"
    ),
}

__all__ = [
    "ARCHS",
    "INPUT_SHAPES",
    "InputShape",
    "LayerSpec",
    "ModelConfig",
    "attn",
    "mamba",
    "get_config",
    "list_archs",
]


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name in LATER_SLICES:
        raise NotImplementedError(
            f"{name!r} is not ported yet; it comes with {LATER_SLICES[name]}"
        )
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(ARCHS)}")
    mod = ARCHS[name]
    cfg = mod.smoke_config() if smoke else mod.config()
    cfg.validate()
    return cfg


def list_archs() -> list[str]:
    return sorted(ARCHS)
