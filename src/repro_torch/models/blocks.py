"""Decoder layers: (attention | MLA | Mamba-2) mixer + optional (dense |
MoE) FFN, pre-norm residual. An attention layer is MLA where
``cfg.use_mla`` (deepseek-v3), with either FFN.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models.attention import attn_forward, init_attn, init_attn_cache
from repro_torch.models.common import rms_norm
from repro_torch.models.mla import init_mla, init_mla_cache, mla_forward
from repro_torch.models.mlp import init_mlp, mlp_forward
from repro_torch.models.moe import init_moe, moe_forward
from repro_torch.models.ssm import init_mamba, init_mamba_cache, mamba_forward

__all__ = ["init_layer", "init_layer_cache", "layer_forward", "has_ffn"]

Params = dict[str, Any]


def has_ffn(spec: LayerSpec, cfg: ModelConfig) -> bool:
    return spec.moe or cfg.d_ff > 0


def init_layer(
    gen: torch.Generator,
    spec: LayerSpec,
    cfg: ModelConfig,
    device,
    dtype: torch.dtype = torch.float32,
) -> Params:
    """f32 leaves, but an MoE FFN's expert stacks, which are cast to
    ``dtype`` as each is drawn (see ``models.moe.init_moe``)."""
    d = cfg.d_model
    p: Params = {"ln1": torch.zeros(d, device=device)}
    if spec.kind == "attn" and cfg.use_mla:
        p["mixer"] = init_mla(gen, cfg, device)
    elif spec.kind == "attn":
        p["mixer"] = init_attn(gen, cfg, device)
    else:
        p["mixer"] = init_mamba(gen, cfg, device)
    if has_ffn(spec, cfg):
        p["ln2"] = torch.zeros(d, device=device)
        if spec.moe:
            p["ffn"] = init_moe(gen, cfg, device, dtype)
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
    conv window and SSM state, whatever ``max_seq``; an MLA layer's its
    latent rows ``ckv`` and ``krope``, (B, max_seq, r)."""
    if spec.kind == "mamba":
        return init_mamba_cache(cfg, batch, dtype, device)
    if cfg.use_mla:
        return init_mla_cache(cfg, batch, max_seq, dtype, device)
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
    tp: Any = None,
    pspec: Params | None = None,
) -> tuple[torch.Tensor, Params | None, torch.Tensor | None]:
    """Pre-norm residual block. Returns (x, cache, the MoE FFN's
    load-balance loss, or None for a layer without one).
    ``plain_attention``: see ``models.model.forward``. ``tp`` (a
    ``core.comm.ModelAxis``) and ``pspec`` (this layer's parameter specs):
    a rank's part of a tensor-parallel layer, whose products split by rows
    in ``pspec`` end in the model-axis all-reduce (each mixer and FFN says
    how it splits)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec.kind == "attn" and not cfg.use_mla:
        mix, cache = attn_forward(
            p["mixer"],
            h,
            spec,
            cfg,
            positions=positions,
            cache=cache,
            cache_index=cache_index,
            plain=plain_attention,
            tp=tp,
            pspec=None if pspec is None else pspec["mixer"],
        )
    elif spec.kind == "attn":
        mix, cache = mla_forward(
            p["mixer"],
            h,
            spec,
            cfg,
            positions=positions,
            cache=cache,
            cache_index=cache_index,
            plain=plain_attention,
            tp=tp,
            pspec=None if pspec is None else pspec["mixer"],
        )
    else:
        mix, cache = mamba_forward(
            p["mixer"], h, cfg, cache=cache, plain=plain_attention, tp=tp
        )
    x = x + mix
    aux = None
    if has_ffn(spec, cfg):
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        if spec.moe:
            y, aux = moe_forward(
                p["ffn"],
                h2,
                cfg,
                cfg.mlp_act,
                tp=tp,
                pspec=None if pspec is None else pspec["ffn"],
            )
        else:
            y = mlp_forward(
                p["ffn"],
                h2,
                cfg.mlp_act,
                tp=tp,
                pspec=None if pspec is None else pspec["ffn"],
            )
        x = x + y
    return x, cache, aux
