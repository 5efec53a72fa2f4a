"""Model/shape config dataclasses (a copy of the JAX package's ``configs/base.py``).

A model is described as: optional *lead* layers, a *pattern* of heterogeneous
layers repeated ``repeats`` times (the period, e.g. Gemma-3's LLLLLG), and
optional *tail* layers. The port runs the stack as a Python loop; the
``repeats`` grouping survives only in the cache tree layout, so caches and
byte accounting compare leaf by leaf with the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = ["LayerSpec", "ModelConfig", "InputShape", "INPUT_SHAPES", "attn", "mamba"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer position in the stack."""

    kind: Literal["attn", "mamba"] = "attn"
    moe: bool = False  # MoE MLP instead of dense MLP
    window: int | None = None  # sliding-window size for attn layers
    rope_theta: float | None = None  # per-layer RoPE base override


def attn(
    moe: bool = False, window: int | None = None, rope_theta: float | None = None
) -> LayerSpec:
    return LayerSpec("attn", moe, window, rope_theta)


def mamba(moe: bool = False) -> LayerSpec:
    return LayerSpec("mamba", moe)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
    source: str  # citation: arXiv id / model card
    d_model: int
    vocab_size: int
    # ---- layer stack ----
    pattern: tuple[LayerSpec, ...] = (attn(),)
    repeats: int = 1  # repeats of `pattern`
    lead: tuple[LayerSpec, ...] = ()  # layers before the repeated pattern
    tail: tuple[LayerSpec, ...] = ()  # layers after the repeated pattern
    # ---- attention ----
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    # ---- MLA (DeepSeek) ----
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # ---- MLP ----
    d_ff: int = 0
    mlp_act: str = "silu"  # 'silu' (SwiGLU) | 'gelu' (GeGLU, tanh approximation)
    # ---- MoE ----
    n_experts: int = 0
    experts_per_token: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_impl: str = "global"
    moe_shard_hints: bool = False
    # ---- Mamba-2 / SSD ----
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 64
    # ---- multimodal (stub frontends) ----
    n_codebooks: int = 0
    cond_len: int = 0
    # ---- gradient-compression policy hint ----
    compression_policy: str | None = None
    # ---- extras ----
    mtp: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    subquadratic: bool = False

    # ------------------------------------------------------------- helpers
    @property
    def layers(self) -> tuple[LayerSpec, ...]:
        return self.lead + self.pattern * self.repeats + self.tail

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def validate(self) -> None:
        if self.d_model <= 0 or self.vocab_size <= 0:
            raise ValueError(f"{self.name}: d_model and vocab_size must be > 0")
        for spec in self.layers:
            if spec.kind == "attn" and not self.use_mla:
                if self.n_heads <= 0 or self.head_dim <= 0:
                    raise ValueError(f"{self.name}: attention needs heads")
                if self.n_heads % max(self.n_kv_heads, 1):
                    raise ValueError(f"{self.name}: n_heads % n_kv_heads != 0")
            if spec.kind == "mamba" and (
                self.ssm_state <= 0 or self.d_inner % self.ssm_head_dim
            ):
                raise ValueError(f"{self.name}: bad SSM shape")
            if spec.moe and (self.n_experts <= 1 or self.experts_per_token < 1):
                raise ValueError(f"{self.name}: bad MoE shape")


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: Literal["train", "prefill", "decode"]


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
