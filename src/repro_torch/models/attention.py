"""GQA/MQA attention with RoPE, optional sliding window, QK-norm, KV cache.

Layouts follow the JAX package: activations (B, S, D); heads as
(B, H, S, hd) for the attention op. Train and prefill attention dispatch to
the flash kernel through ``repro_torch.kernels.ops`` (the hand-written CUDA
kernel on the card, ``attention_ref`` on the CPU); decode attends one query
against the dequantized cache in plain torch, as the JAX package does.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import dense_init, rms_norm
from repro_torch.models.rope import apply_rope, rope_freqs
from repro_torch.serving.kv_cache import (
    QuantKV,
    kv_read,
    kv_update_token,
    quantize_kv,
)

__all__ = ["init_attn", "init_attn_cache", "attn_forward", "decode_attend"]

Params = dict[str, Any]


def init_attn(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p: Params = {
        "wq": dense_init(gen, (d, h * hd), device=device),
        "wk": dense_init(gen, (d, hkv * hd), device=device),
        "wv": dense_init(gen, (d, hkv * hd), device=device),
        "wo": dense_init(gen, (h * hd, d), device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(h * hd, device=device)
        p["bk"] = torch.zeros(hkv * hd, device=device)
        p["bv"] = torch.zeros(hkv * hd, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(hd, device=device)
        p["k_norm"] = torch.zeros(hd, device=device)
    return p


def init_attn_cache(
    cfg: ModelConfig, batch: int, max_seq: int, dtype: torch.dtype, device
) -> Params:
    shape = (batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def _qkv(
    p: Params,
    x: torch.Tensor,
    spec: LayerSpec,
    cfg: ModelConfig,
    positions: torch.Tensor,
):
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    theta = spec.rope_theta if spec.rope_theta is not None else cfg.rope_theta
    cos, sin = rope_freqs(positions, hd, theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def decode_attend(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    index: int | torch.Tensor,
    window: int | None,
) -> torch.Tensor:
    """q (B, H, 1, hd) vs cache (B, Hkv, S, hd); keys j <= index visible.

    ``index`` is an int (fixed-batch decode) or a (B,) tensor of per-request
    positions (continuous batching), each row masked at its own length."""
    _, h, _, hd = q.shape
    s = k_cache.shape[2]
    rep = h // k_cache.shape[1]
    kc = k_cache.repeat_interleave(rep, dim=1) if rep > 1 else k_cache
    vc = v_cache.repeat_interleave(rep, dim=1) if rep > 1 else v_cache
    scale = 1.0 / float(hd) ** 0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kc.float()) * scale
    j = torch.arange(s, device=q.device)
    if isinstance(index, int):
        mask = j <= index
        if window is not None:
            mask &= j > index - window
        mask = mask[None, None, None, :]
    else:
        mask = j[None, :] <= index[:, None]  # (B, S)
        if window is not None:
            mask &= j[None, :] > index[:, None] - window
        mask = mask[:, None, None, :]
    logits = logits.masked_fill(~mask, -1e30)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, vc.float()).to(q.dtype)


def attn_forward(
    p: Params,
    x: torch.Tensor,
    spec: LayerSpec,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    cache: Params | None = None,
    cache_index: int | torch.Tensor | None = None,
) -> tuple[torch.Tensor, Params | None]:
    """Returns (y, cache). cache=None: full sequence (train). cache given and
    one token: decode, appending K/V in place. cache given and a longer x:
    prefill, writing the whole padded cache in place (rows past S are zero:
    raw zeros, or codes 0 with scale 0 in a QuantKV)."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q, k, v = _qkv(p, x, spec, cfg, positions)
    q = q.transpose(1, 2)  # (B, H, S, hd)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)

    if cache is not None and s == 1:
        k_leaf = kv_update_token(cache["k"], k, cache_index, axis=2)
        v_leaf = kv_update_token(cache["v"], v, cache_index, axis=2)
        out = decode_attend(
            q, kv_read(k_leaf), kv_read(v_leaf), cache_index, spec.window
        )
    else:
        out = ops.flash_attention(q, k, v, causal=True, window=spec.window)
        if cache is not None:
            for name, new in (("k", k), ("v", v)):
                leaf = cache[name]
                raw = leaf.codes if isinstance(leaf, QuantKV) else leaf
                full = F.pad(new, (0, 0, 0, raw.shape[2] - s))
                if isinstance(leaf, QuantKV):
                    qf = quantize_kv(full, leaf.bits, leaf.alpha)
                    leaf.codes.copy_(qf.codes)
                    leaf.scale.copy_(qf.scale)
                else:
                    leaf.copy_(full)
    y = out.transpose(1, 2).reshape(b, s, h * hd)
    return y @ p["wo"].to(x.dtype), cache
