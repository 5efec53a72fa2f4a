"""Decoder layers: attention mixer + dense FFN, pre-norm residual.

Mamba-2 mixers, MLA attention and MoE FFNs are not ported yet; asking for
one raises ``NotImplementedError`` naming the slice that brings it.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models.attention import attn_forward, init_attn, init_attn_cache
from repro_torch.models.common import rms_norm
from repro_torch.models.mlp import init_mlp, mlp_forward

__all__ = ["init_layer", "init_layer_cache", "layer_forward", "has_ffn"]

Params = dict[str, Any]


def _check_ported(spec: LayerSpec, cfg: ModelConfig) -> None:
    if spec.kind == "mamba":
        raise NotImplementedError("Mamba-2 layers come with the SSM slice")
    if cfg.use_mla:
        raise NotImplementedError("MLA attention comes with the LM training slice")
    if spec.moe:
        raise NotImplementedError("MoE FFNs come with the LM training slice")


def has_ffn(spec: LayerSpec, cfg: ModelConfig) -> bool:
    return spec.moe or cfg.d_ff > 0


def init_layer(
    gen: torch.Generator, spec: LayerSpec, cfg: ModelConfig, device
) -> Params:
    _check_ported(spec, cfg)
    d = cfg.d_model
    p: Params = {
        "ln1": torch.zeros(d, device=device),
        "mixer": init_attn(gen, cfg, device),
    }
    if has_ffn(spec, cfg):
        p["ln2"] = torch.zeros(d, device=device)
        p["ffn"] = init_mlp(gen, d, cfg.d_ff, device)
    return p


def init_layer_cache(
    spec: LayerSpec,
    cfg: ModelConfig,
    batch: int,
    max_seq: int,
    dtype: torch.dtype,
    device,
) -> Params:
    """A full ``max_seq`` buffer for every attention layer, sliding-window
    ones included: the JAX package does not cap SWA caches at the window,
    and bytes/token are compared with it."""
    _check_ported(spec, cfg)
    return init_attn_cache(cfg, batch, max_seq, dtype, device)


def layer_forward(
    p: Params,
    x: torch.Tensor,
    spec: LayerSpec,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    cache: Params | None = None,
    cache_index: int | torch.Tensor | None = None,
) -> tuple[torch.Tensor, Params | None]:
    """Pre-norm residual block. Returns (x, cache)."""
    _check_ported(spec, cfg)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    mix, cache = attn_forward(
        p["mixer"],
        h,
        spec,
        cfg,
        positions=positions,
        cache=cache,
        cache_index=cache_index,
    )
    x = x + mix
    if has_ffn(spec, cfg):
        x = x + mlp_forward(p["ffn"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg.mlp_act)
    return x, cache
