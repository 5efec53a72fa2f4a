"""Config registry of the port.

``get_config("gemma3-1b")`` is the full model, ``smoke=True`` its reduced
variant for CPU tests. The JAX package knows nine more architectures; they
need kernels and layers (Mamba-2/SSD, MLA, MoE) that later slices port, so
asking for one raises ``NotImplementedError`` naming that slice.
"""

from __future__ import annotations

from repro_torch.configs import gemma3_1b
from repro_torch.configs.base import (
    INPUT_SHAPES,
    InputShape,
    LayerSpec,
    ModelConfig,
    attn,
    mamba,
)

ARCHS = {"gemma3-1b": gemma3_1b}

# architectures of the JAX package and the port slice that brings each one
LATER_SLICES = {
    "mamba2-370m": "the SSM slice (ssd_chunk kernel, Mamba-2 layers)",
    "jamba-v0.1-52b": "the SSM slice (Mamba-2 layers) and the MoE layers",
    "deepseek-v3-671b": "the LM training-stack slice (MLA, MoE, MTP)",
    "qwen2-72b": "the LM training-stack slice (model zoo)",
    "mixtral-8x7b": "the LM training-stack slice (MoE layers)",
    "mistral-nemo-12b": "the LM training-stack slice (model zoo)",
    "chameleon-34b": "the LM training-stack slice (multimodal stubs)",
    "musicgen-medium": "the LM training-stack slice (multi-codebook heads)",
    "granite-20b": "the LM training-stack slice (model zoo)",
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
