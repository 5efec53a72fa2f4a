"""Multi-head Latent Attention (DeepSeek-V2/V3, arXiv:2412.19437).

The counterpart of the JAX package's ``models/mla.py``. Q and KV are
down-projected to low-rank latents; only the KV latent ``ckv`` (r_kv = 512
at full width) and one decoupled-RoPE key ``krope`` (64) are cached, (B, S,
r) leaves with no head axis, raw or log-quantized (``QuantKV``) like any
other cache leaf.

Train and prefill expand K and V per head and call ``ops.flash_attention``
at the QK head dim (nope + rope: 192 at full width), V zero-padded from
v_head_dim to it and the output sliced back; the scale stays 1/sqrt(qk
dim). ``plain=True`` takes the plain attention on any device, as a
training forward does. Prefill fills the latent cache in place.

Decode is the absorbed form: W_UK folded into the query and W_UV into the
output, so attention runs in latent space over ``kv_read`` of the cache, in
f32, as the JAX package computes it. The new token's latent rows are
appended in place (quantized against their own scales for a ``QuantKV``).
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

__all__ = ["init_mla", "init_mla_cache", "mla_forward"]

Params = dict[str, Any]


def init_mla(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    d, h = cfg.d_model, cfg.n_heads
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq_a": dense_init(gen, (d, rq), device=device),
        "q_a_norm": torch.zeros(rq, device=device),
        "wq_b": dense_init(gen, (rq, h * (nope + rope)), device=device),
        "wkv_a": dense_init(gen, (d, rkv + rope), device=device),
        "kv_a_norm": torch.zeros(rkv, device=device),
        "wkv_b": dense_init(gen, (rkv, h * (nope + vdim)), device=device),
        "wo": dense_init(gen, (h * vdim, d), device=device),
    }


def init_mla_cache(
    cfg: ModelConfig, batch: int, max_seq: int, dtype: torch.dtype, device
) -> Params:
    return {
        "ckv": torch.zeros(
            (batch, max_seq, cfg.kv_lora_rank), dtype=dtype, device=device
        ),
        "krope": torch.zeros(
            (batch, max_seq, cfg.qk_rope_dim), dtype=dtype, device=device
        ),
    }


def _latents(p: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """The query (nope and roped parts, (B, S, H, .)), the normed KV latent
    (B, S, r_kv) and the roped shared key (B, S, rope)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    cq = rms_norm(x @ p["wq_a"].to(x.dtype), p["q_a_norm"], cfg.norm_eps)
    q = (cq @ p["wq_b"].to(x.dtype)).reshape(b, s, h, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    kv_a = x @ p["wkv_a"].to(x.dtype)
    ckv = rms_norm(kv_a[..., : cfg.kv_lora_rank], p["kv_a_norm"], cfg.norm_eps)
    k_rope = kv_a[..., cfg.kv_lora_rank :]
    cos, sin = rope_freqs(positions, rope, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    return q_nope, q_rope, ckv, k_rope


def _absorbed_decode(p, cfg, q_nope, q_rope, ckv_c, kr_c, idx):
    """One query per row against the whole latent cache, in f32; keys
    j <= idx visible (``idx`` an int or a (B,) tensor of positions)."""
    b = q_nope.shape[0]
    h = cfg.n_heads
    nope, vdim = cfg.qk_nope_dim, cfg.v_head_dim
    wkv_b = p["wkv_b"].float().reshape(cfg.kv_lora_rank, h, nope + vdim)
    w_uk, w_uv = wkv_b[..., :nope], wkv_b[..., nope:]
    ckv_c, kr_c = ckv_c.float(), kr_c.float()
    q_lat = torch.einsum("bthn,rhn->bthr", q_nope.float(), w_uk)
    scores = torch.einsum("bthr,bsr->bhts", q_lat, ckv_c)
    scores = scores + torch.einsum("bthr,bsr->bhts", q_rope.float(), kr_c)
    scores = scores * (1.0 / float(nope + cfg.qk_rope_dim) ** 0.5)
    j = torch.arange(ckv_c.shape[1], device=ckv_c.device)
    if isinstance(idx, int):
        mask = (j <= idx)[None, None, None, :]
    else:
        mask = (j[None, :] <= idx[:, None])[:, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    w = torch.softmax(scores, dim=-1)
    ctx_lat = torch.einsum("bhts,bsr->bthr", w, ckv_c)
    out = torch.einsum("bthr,rhv->bthv", ctx_lat, w_uv)
    return out.reshape(b, 1, h * vdim)


def _fill(leaf: Any, new: torch.Tensor) -> None:
    """Write a prefill's (B, S, r) rows into a (B, max_seq, r) cache leaf,
    in place, the rows past S zero (codes 0 with scale 0 in a QuantKV)."""
    raw = leaf.codes if isinstance(leaf, QuantKV) else leaf
    full = F.pad(new, (0, 0, 0, raw.shape[1] - new.shape[1]))
    if isinstance(leaf, QuantKV):
        qf = quantize_kv(full, leaf.bits, leaf.alpha)
        leaf.codes.copy_(qf.codes)
        leaf.scale.copy_(qf.scale)
    else:
        leaf.copy_(full)


def mla_forward(
    p: Params,
    x: torch.Tensor,
    spec: LayerSpec,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    cache: Params | None = None,
    cache_index: int | torch.Tensor | None = None,
    plain: bool = False,
) -> tuple[torch.Tensor, Params | None]:
    """Returns (y, cache): train (no cache), prefill (a cache and S > 1,
    filled in place) or decode (a cache and one token, appended in place)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    nope, rope, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope, ckv, k_rope = _latents(p, x, cfg, positions)

    if cache is not None and s == 1:
        ckv_leaf = kv_update_token(cache["ckv"], ckv, cache_index, axis=1)
        kr_leaf = kv_update_token(cache["krope"], k_rope, cache_index, axis=1)
        ckv_c, kr_c = kv_read(ckv_leaf), kv_read(kr_leaf)
        out = _absorbed_decode(p, cfg, q_nope, q_rope, ckv_c, kr_c, cache_index)
        out = out.to(x.dtype)
        return out @ p["wo"].to(x.dtype), cache

    kv = (ckv @ p["wkv_b"].to(x.dtype)).reshape(b, s, h, nope + vdim)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, rope)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    v_pad = F.pad(v, (0, nope + rope - vdim))
    out = ops.flash_attention(
        q.transpose(1, 2),
        k.transpose(1, 2),
        v_pad.transpose(1, 2),
        causal=True,
        window=spec.window,
        plain=plain,
    )
    out = out[..., :vdim].transpose(1, 2).reshape(b, s, h * vdim)
    if cache is not None:
        _fill(cache["ckv"], ckv)
        _fill(cache["krope"], k_rope)
    return out @ p["wo"].to(x.dtype), cache
