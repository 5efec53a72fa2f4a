"""Decoder layers: (attention | Mamba-2) mixer + optional (dense | MoE) FFN,
pre-norm residual.

MLA attention is not ported yet; asking for it raises
``NotImplementedError`` naming the slice that brings it.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models.attention import attn_forward, init_attn, init_attn_cache
from repro_torch.models.common import rms_norm
from repro_torch.models.mlp import init_mlp, mlp_forward
from repro_torch.models.moe import init_moe, moe_forward
from repro_torch.models.ssm import init_mamba, init_mamba_cache, mamba_forward

__all__ = ["init_layer", "init_layer_cache", "layer_forward", "has_ffn"]

Params = dict[str, Any]


def _check_ported(spec: LayerSpec, cfg: ModelConfig) -> None:
    if spec.kind == "attn" and cfg.use_mla:
        raise NotImplementedError(
            "MLA attention comes with the rest of the LM training slice "
            "(ROADMAP Queue 1, item 14)"
        )


def has_ffn(spec: LayerSpec, cfg: ModelConfig) -> bool:
    return spec.moe or cfg.d_ff > 0


def init_layer(
    gen: torch.Generator, spec: LayerSpec, cfg: ModelConfig, device
) -> Params:
    _check_ported(spec, cfg)
    d = cfg.d_model
    p: Params = {"ln1": torch.zeros(d, device=device)}
    if spec.kind == "attn":
        p["mixer"] = init_attn(gen, cfg, device)
    else:
        p["mixer"] = init_mamba(gen, cfg, device)
    if has_ffn(spec, cfg):
        p["ln2"] = torch.zeros(d, device=device)
        if spec.moe:
            p["ffn"] = init_moe(gen, cfg, device)
        else:
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
    and bytes/token are compared with it. A Mamba-2 layer's cache is its
    conv window and SSM state, whatever ``max_seq``."""
    _check_ported(spec, cfg)
    if spec.kind == "mamba":
        return init_mamba_cache(cfg, batch, dtype, device)
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
    plain_attention: bool = False,
) -> tuple[torch.Tensor, Params | None, torch.Tensor | None]:
    """Pre-norm residual block. Returns (x, cache, the MoE FFN's
    load-balance loss, or None for a layer without one).
    ``plain_attention``: see ``models.model.forward``."""
    _check_ported(spec, cfg)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec.kind == "attn":
        mix, cache = attn_forward(
            p["mixer"],
            h,
            spec,
            cfg,
            positions=positions,
            cache=cache,
            cache_index=cache_index,
            plain=plain_attention,
        )
    else:
        mix, cache = mamba_forward(p["mixer"], h, cfg, cache=cache)
    x = x + mix
    aux = None
    if has_ffn(spec, cfg):
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        if spec.moe:
            y, aux = moe_forward(p["ffn"], h2, cfg, cfg.mlp_act)
        else:
            y = mlp_forward(p["ffn"], h2, cfg.mlp_act)
        x = x + y
    return x, cache, aux
