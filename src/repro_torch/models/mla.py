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

Tensor-parallel serving (``tp``): a rank holds its heads and its sequence
shard of the latent cache (:func:`mla_forward`); the decode merges the
shards' partials as the attention's flash-decoding merge does. Training
over the model axis runs the train mode on the rank's heads, the gathered
latents' gradients summed over the ranks (:func:`_latents`).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.comm import copy_to_model, gather_from_model, gather_to_split
from repro_torch.kernels import ops
from repro_torch.models.attention import _owned_index
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


def _latents(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
    tp: Any = None,
    pspec: Params | None = None,
):
    """The query (nope and roped parts, (B, S, h, .), this rank's heads),
    the normed KV latent (B, S, r_kv) and the roped shared key (B, S,
    rope). Where ``pspec`` splits the columns of ``wq_a`` or ``wkv_a``,
    a rank's columns are gathered over the model axis before the norms
    (``tp.mla.q_a``, ``tp.mla.kv_a``). Where the heads split too, each
    rank's gradient of a gathered latent is its heads' part, so the
    gather's backward sums the ranks' before it keeps the rank's columns
    (``core.comm.gather_to_split``); where they do not, the latents are
    whole on every rank, and the input of the split down-projections
    passes a ``copy_to_model`` (``tp.mla.a.in``) instead."""
    b, s, _ = x.shape
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    h = p["wq_b"].shape[1] // (nope + rope)
    q_a, kv_a_split = _split(pspec, "wq_a", 1), _split(pspec, "wkv_a", 1)
    heads = _split(pspec, "wq_b", 1)
    gather = gather_to_split if heads else gather_from_model
    xa = x
    if (q_a or kv_a_split) and not heads:
        xa = copy_to_model(x, tp.comm, "tp.mla.a.in")
    cq = (xa if q_a else x) @ p["wq_a"].to(x.dtype)
    if q_a:
        cq = gather(cq, tp.comm, -1, "tp.mla.q_a")
    cq = rms_norm(cq, p["q_a_norm"], cfg.norm_eps)
    q = (cq @ p["wq_b"].to(x.dtype)).reshape(b, s, h, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    kv_a = (xa if kv_a_split else x) @ p["wkv_a"].to(x.dtype)
    if kv_a_split:
        kv_a = gather(kv_a, tp.comm, -1, "tp.mla.kv_a")
    ckv = rms_norm(kv_a[..., : cfg.kv_lora_rank], p["kv_a_norm"], cfg.norm_eps)
    k_rope = kv_a[..., cfg.kv_lora_rank :]
    cos, sin = rope_freqs(positions, rope, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    return q_nope, q_rope, ckv, k_rope


def _absorbed(p, cfg, q_nope):
    """(q_lat (B, 1, h, r) f32, W_UV (r, h, v) f32) of this rank's h heads."""
    h, nope, vdim = q_nope.shape[2], cfg.qk_nope_dim, cfg.v_head_dim
    wkv_b = p["wkv_b"].float().reshape(cfg.kv_lora_rank, h, nope + vdim)
    w_uk, w_uv = wkv_b[..., :nope], wkv_b[..., nope:]
    return torch.einsum("bthn,rhn->bthr", q_nope.float(), w_uk), w_uv


def _visible(idx, j: torch.Tensor) -> torch.Tensor:
    """Positions ``j`` visible to a query at ``idx`` (an int or (B,)), shaped
    to mask (B, H, 1, S) scores."""
    if isinstance(idx, int):
        return (j <= idx)[None, None, None, :]
    return (j[None, :] <= idx[:, None])[:, None, None, :]


def _absorbed_decode(p, cfg, q_nope, q_rope, ckv_c, kr_c, idx):
    """One query per row against the whole latent cache, in f32; keys
    j <= idx visible (``idx`` an int or a (B,) tensor of positions)."""
    b, h = q_nope.shape[0], q_nope.shape[2]
    q_lat, w_uv = _absorbed(p, cfg, q_nope)
    ckv_c, kr_c = ckv_c.float(), kr_c.float()
    scores = torch.einsum("bthr,bsr->bhts", q_lat, ckv_c)
    scores = scores + torch.einsum("bthr,bsr->bhts", q_rope.float(), kr_c)
    scores = scores * (1.0 / float(cfg.qk_nope_dim + cfg.qk_rope_dim) ** 0.5)
    mask = _visible(idx, torch.arange(ckv_c.shape[1], device=ckv_c.device))
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    w = torch.softmax(scores, dim=-1)
    ctx_lat = torch.einsum("bhts,bsr->bthr", w, ckv_c)
    out = torch.einsum("bthr,rhv->bthv", ctx_lat, w_uv)
    return out.reshape(b, 1, h * cfg.v_head_dim)


def _absorbed_decode_sharded(p, cfg, q_nope, q_rope, ckv_c, kr_c, idx, tp, q_split):
    """The absorbed decode over a latent cache split by sequence over
    ``tp.seq``: this rank holds positions ``r * S_loc`` ..
    ``(r + 1) * S_loc - 1`` of the latent rows. The absorbed queries of the
    rank's heads (``q_lat`` and the roped part, f32) are gathered to all H
    heads over the model axis (``tp.mla.q``, where the heads split), each
    rank takes over its positions a partial max, sum and weighted latent
    for every head (masked on global positions), the partials are
    gathered (``tp.mla.decode``) and merged by their log-sum-exp, and the
    rank keeps its heads' rows for ``W_UV``, as the attention's
    flash-decoding merge (``models.attention._decode_seq_sharded``)."""
    b, h_loc = q_nope.shape[0], q_nope.shape[2]
    r = cfg.kv_lora_rank
    q_lat, w_uv = _absorbed(p, cfg, q_nope)
    q = torch.cat([q_lat, q_rope.float()], dim=-1)  # (B, 1, h, r + rope)
    if q_split:
        q = tp.comm.all_gather(q, 2, "tp.mla.q")
    ckv_c, kr_c = ckv_c.float(), kr_c.float()
    scores = torch.einsum("bthr,bsr->bhts", q[..., :r], ckv_c)
    scores = scores + torch.einsum("bthr,bsr->bhts", q[..., r:], kr_c)
    scores = scores * (1.0 / float(cfg.qk_nope_dim + cfg.qk_rope_dim) ** 0.5)
    s_loc = ckv_c.shape[1]
    j = tp.seq.rank * s_loc + torch.arange(s_loc, device=ckv_c.device)
    mask = _visible(idx, j)
    scores = scores.masked_fill(~mask, -1e30)
    m = scores.amax(dim=-1, keepdim=True)
    w = torch.exp(scores - m) * mask  # 0 on a shard with no visible position
    o = torch.einsum("bhts,bsr->bhtr", w, ckv_c)
    part = torch.cat([o, m, w.sum(-1, keepdim=True)], dim=-1)  # (B, H, 1, r + 2)
    parts = tp.seq.all_gather(part[None], 0, "tp.mla.decode")
    o, mr, sr = parts[..., :r], parts[..., r : r + 1], parts[..., r + 1 :]
    c = torch.exp(mr - mr.amax(dim=0, keepdim=True))
    ctx = (c * o).sum(0) / (c * sr).sum(0)  # (B, H, 1, r)
    first = tp.comm.rank * h_loc if q_split else 0
    ctx = ctx[:, first : first + h_loc].transpose(1, 2)  # (B, 1, h, r)
    out = torch.einsum("bthr,rhv->bthv", ctx, w_uv)
    return out.reshape(b, 1, h_loc * cfg.v_head_dim)


def _fill(leaf: Any, new: torch.Tensor, start: int = 0) -> None:
    """Write a prefill's (B, S, r) rows into a cache leaf of ``n`` positions
    from global position ``start`` (a rank's sequence shard), in place,
    the rows past S zero (codes 0 with scale 0 in a QuantKV)."""
    raw = leaf.codes if isinstance(leaf, QuantKV) else leaf
    n, s = raw.shape[1], new.shape[1]
    full = F.pad(new, (0, 0, 0, start + n - s)) if start + n > s else new
    full = full[:, start : start + n]
    if isinstance(leaf, QuantKV):
        qf = quantize_kv(full, leaf.bits, leaf.alpha)
        leaf.codes.copy_(qf.codes)
        leaf.scale.copy_(qf.scale)
    else:
        leaf.copy_(full)


def _split(pspec: Params | None, name: str, dim: int) -> bool:
    return pspec is not None and pspec[name][dim] is not None


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
    tp: Any = None,
    pspec: Params | None = None,
) -> tuple[torch.Tensor, Params | None]:
    """Returns (y, cache): train (no cache), prefill (a cache and S > 1,
    filled in place) or decode (a cache and one token, appended in place).

    Tensor-parallel (``tp``, a ``core.comm.ModelAxis``, with the layer's
    specs ``pspec``): a rank holds its heads' columns of ``wq_b`` and
    ``wkv_b`` and rows of ``wo`` (a row-parallel all-reduce, ``tp.mla.wo``),
    and its columns of ``wq_a`` and ``wkv_a`` (the JAX rules: ``wkv_a``
    takes the K/V rule, whose head test passes with no KV heads), gathered
    before the norms (:func:`_latents`, whose gathers carry a training
    backward), so every rank holds the whole latent rows and stores
    its sequence shard of them
    (``tp.seq``: the model group, or every rank where the batch does not
    split). A prefill attends its heads over the whole sequence; a decode
    step appends on the rank that holds the position and merges the
    shards' partials (:func:`_absorbed_decode_sharded`)."""
    b, s, _ = x.shape
    nope, rope, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_split = _split(pspec, "wq_b", 1)
    if q_split:  # the heads split: the input's gradient is summed over them
        x = copy_to_model(x, tp.comm, "tp.mla.in")
    q_nope, q_rope, ckv, k_rope = _latents(p, x, cfg, positions, tp, pspec)
    h = q_nope.shape[2]  # this rank's heads
    seq = tp.seq if tp is not None and tp.seq.size > 1 else None

    if cache is not None and s == 1:
        if seq is not None:
            own = _owned_index(cache_index, seq.rank, _seq_len(cache["ckv"]))
        else:
            own = cache_index
        ckv_leaf, kr_leaf = cache["ckv"], cache["krope"]
        if own is not None:
            ckv_leaf = kv_update_token(ckv_leaf, ckv, own, axis=1)
            kr_leaf = kv_update_token(kr_leaf, k_rope, own, axis=1)
        ckv_c, kr_c = kv_read(ckv_leaf), kv_read(kr_leaf)
        if seq is not None:
            out = _absorbed_decode_sharded(
                p, cfg, q_nope, q_rope, ckv_c, kr_c, cache_index, tp, q_split
            )
        else:
            out = _absorbed_decode(p, cfg, q_nope, q_rope, ckv_c, kr_c, cache_index)
        out = out.to(x.dtype)
    else:
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
            start = seq.rank * _seq_len(cache["ckv"]) if seq is not None else 0
            _fill(cache["ckv"], ckv, start)
            _fill(cache["krope"], k_rope, start)
    if _split(pspec, "wo", 0):
        return tp.comm.row_parallel(out, p["wo"].to(x.dtype), "tp.mla.wo"), cache
    return out @ p["wo"].to(x.dtype), cache


def _seq_len(leaf: Any) -> int:
    return (leaf.codes if isinstance(leaf, QuantKV) else leaf).shape[1]
