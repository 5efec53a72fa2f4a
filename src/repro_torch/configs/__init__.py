"""Config registry of the port.

``get_config("gemma3-1b")`` is the full model, ``smoke=True`` its reduced
variant for CPU tests. The port knows all ten of the JAX package's
architectures: the dense ones (tied or untied head), the MoE ones, the
Mamba-2 ones, deepseek-v3-671b (MLA, the MTP head) and musicgen-medium
(multi-codebook embeddings and heads, the conditioning prefix).
"""

from __future__ import annotations

from repro_torch.configs import (
    chameleon_34b,
    deepseek_v3_671b,
    gemma3_1b,
    granite_20b,
    jamba_v01_52b,
    mamba2_370m,
    mistral_nemo_12b,
    mixtral_8x7b,
    musicgen_medium,
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
    "deepseek-v3-671b": deepseek_v3_671b,
    "musicgen-medium": musicgen_medium,
}

# archs with a sub-quadratic (or windowed) path run long_500k; the rest skip
# it (full attention), as in the JAX package
LONG_CONTEXT_ARCHS = ("mamba2-370m", "jamba-v0.1-52b", "gemma3-1b", "mixtral-8x7b")

__all__ = [
    "ARCHS",
    "LONG_CONTEXT_ARCHS",
    "INPUT_SHAPES",
    "InputShape",
    "LayerSpec",
    "ModelConfig",
    "attn",
    "mamba",
    "get_config",
    "list_archs",
    "shape_supported",
]


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(ARCHS)}")
    mod = ARCHS[name]
    cfg = mod.smoke_config() if smoke else mod.config()
    cfg.validate()
    return cfg


def list_archs() -> list[str]:
    return sorted(ARCHS)


def shape_supported(arch: str, shape: str) -> bool:
    """long_500k only for sub-quadratic archs (decode is O(window)/O(1))."""
    if shape == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True
