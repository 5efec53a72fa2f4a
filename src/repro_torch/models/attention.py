"""GQA/MQA attention with RoPE, optional sliding window, QK-norm, KV cache.

Layouts follow the JAX package: activations (B, S, D); heads as
(B, H, S, hd) for the attention op. Prefill attention dispatches to the
flash kernel through ``repro_torch.kernels.ops`` (the hand-written CUDA
kernel on the card, ``attention_ref`` on the CPU); a training forward asks
for the plain attention on any device (``plain=True``), as the JAX
package's training step does; decode attends one query against the
dequantized cache in plain torch, as the JAX package does.

Tensor-parallel (``tp``, a ``core.comm.ModelAxis``, with the layer's
parameter specs ``pspec``): a rank holds the Q heads its ``wq`` columns
give it (all of them where the spec does not split ``wq``) and the KV
heads of its ``wk`` / ``wv`` columns; local Q head i is global head
``first + i`` and reads global KV head ``(first + i) // (H / Hkv)``
(:func:`_kv_of_heads`). ``wo`` split by rows ends in the model-axis all-
reduce of its f32 partials (``ModelComm.row_parallel``), and the layer's
input enters through ``core.comm.copy_to_model``, so a training
forward's backward sums the heads' parts of its gradient; a replicated
``wk`` / ``wv`` / QK norm / bias then holds only the rank's heads' part of
its own gradient, which the training step sums
(``launch/sharding.py:partial_grad_flags``). The KV cache is
split by heads (each rank stores and reads its KV heads) or, where the
KV heads do not divide the model axis, by sequence over ``tp.seq``:
prefill computes the whole K/V (``wk`` / ``wv`` replicate) and each rank
stores the rows of its positions; a decode step appends on the rank that
owns the position and attends flash-decoding style
(:func:`_decode_seq_sharded`).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.comm import copy_to_model
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
    hd = cfg.head_dim
    # this rank's head counts: all heads, or the ones its columns hold
    h, hkv = p["wq"].shape[1] // hd, p["wk"].shape[1] // hd
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


def _kv_of_heads(
    k: torch.Tensor, v: torch.Tensor, n_heads: int, first: int, count: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The K/V heads (all ``n_kv`` of the model's, on dim 1) that query
    heads ``first`` .. ``first + count - 1`` of ``n_heads`` read, laid out
    so that local query head i reads K/V head ``i // (count / heads)``, the
    grouping the kernel and :func:`decode_attend` assume: a slice of whole
    groups where the local heads cover them evenly, else one K/V head a
    query head."""
    if count == n_heads:
        return k, v
    g = n_heads // k.shape[1]
    idx = [(first + i) // g for i in range(count)]
    lo, n = idx[0], idx[-1] + 1 - idx[0]
    if count % n == 0 and idx == [lo + i // (count // n) for i in range(count)]:
        return k[:, lo : lo + n], v[:, lo : lo + n]
    sel = torch.tensor(idx, device=k.device)
    return k.index_select(1, sel), v.index_select(1, sel)


def _decode_seq_sharded(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    index: int | torch.Tensor,
    window: int | None,
    tp: Any,
    first: int,
    q_split: bool,
) -> torch.Tensor:
    """Decode attention over a cache split by sequence over ``tp.seq``: this
    rank holds positions ``r * S_loc`` .. ``(r + 1) * S_loc - 1`` of every
    K/V head. The (B, h, 1, hd) queries are gathered to all H heads over the
    model axis (where ``wq`` splits), each rank takes over its positions a
    partial max, sum and weighted V for every head (masked on global
    positions), the partials are gathered in f32 and merged by their
    log-sum-exp, and the rank keeps its heads' rows."""
    h_loc, hd = q.shape[1], q.shape[3]
    q_all = tp.comm.all_gather(q, 1, "tp.attn.q") if q_split else q
    h = q_all.shape[1]
    s_loc = k_cache.shape[2]
    rep = h // k_cache.shape[1]
    kc = k_cache.repeat_interleave(rep, dim=1) if rep > 1 else k_cache
    vc = v_cache.repeat_interleave(rep, dim=1) if rep > 1 else v_cache
    scale = 1.0 / float(hd) ** 0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q_all.float(), kc.float()) * scale
    j = tp.seq.rank * s_loc + torch.arange(s_loc, device=q.device)
    if isinstance(index, int):
        mask = j <= index
        if window is not None:
            mask &= j > index - window
        mask = mask[None, None, None, :]
    else:
        mask = j[None, :] <= index[:, None]
        if window is not None:
            mask &= j[None, :] > index[:, None] - window
        mask = mask[:, None, None, :]
    logits = logits.masked_fill(~mask, -1e30)
    m = logits.amax(dim=-1, keepdim=True)
    w = torch.exp(logits - m) * mask  # 0 on a shard with no visible position
    part = torch.cat(
        [torch.einsum("bhqk,bhkd->bhqd", w, vc.float()), m, w.sum(-1, keepdim=True)],
        dim=-1,
    )
    parts = tp.seq.all_gather(part[None], 0, "tp.attn.decode")  # (n, B, H, 1, hd+2)
    o, mr, sr = parts[..., :hd], parts[..., hd : hd + 1], parts[..., hd + 1 :]
    c = torch.exp(mr - mr.amax(dim=0, keepdim=True))
    out = (c * o).sum(0) / (c * sr).sum(0)
    return out[:, first : first + h_loc].to(q.dtype)


def _split(pspec: Params | None, name: str, dim: int) -> bool:
    return pspec is not None and pspec[name][dim] is not None


def attn_forward(
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
    """Returns (y, cache). cache=None: full sequence (train; ``plain`` takes
    the plain attention on any device). cache given and
    one token: decode, appending K/V in place. cache given and a longer x:
    prefill, writing the whole padded cache in place (rows past S are zero:
    raw zeros, or codes 0 with scale 0 in a QuantKV). ``tp`` / ``pspec``:
    this rank's part of a tensor-parallel layer (the module doc)."""
    b, s, _ = x.shape
    q_split = _split(pspec, "wq", 1)
    if q_split:  # the heads split: the input's gradient is summed over them
        x = copy_to_model(x, tp.comm, "tp.attn.in")
    q, k, v = _qkv(p, x, spec, cfg, positions)
    q = q.transpose(1, 2)  # (B, h, S, hd): this rank's heads
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    h, h_loc = cfg.n_heads, q.shape[1]
    first = tp.comm.rank * h_loc if q_split else 0
    kv_split = _split(pspec, "wk", 1)
    seq = tp.seq if tp is not None and tp.seq.size > 1 else None

    if cache is not None and s == 1:
        if seq is not None:
            own = _owned_index(cache_index, seq.rank, _seq_len(cache["k"]))
        else:
            own = cache_index
        if own is not None:
            k_leaf = kv_update_token(cache["k"], k, own, axis=2)
            v_leaf = kv_update_token(cache["v"], v, own, axis=2)
        else:  # an int position another rank's shard holds
            k_leaf, v_leaf = cache["k"], cache["v"]
        kc, vc = kv_read(k_leaf), kv_read(v_leaf)
        if seq is not None:
            out = _decode_seq_sharded(
                q, kc, vc, cache_index, spec.window, tp, first, q_split
            )
        else:
            if not kv_split:
                kc, vc = _kv_of_heads(kc, vc, h, first, h_loc)
            out = decode_attend(q, kc, vc, cache_index, spec.window)
    else:
        kq, vq = (k, v) if kv_split else _kv_of_heads(k, v, h, first, h_loc)
        out = ops.flash_attention(
            q, kq, vq, causal=True, window=spec.window, plain=plain
        )
        if cache is not None:
            for name, new in (("k", k), ("v", v)):
                leaf = cache[name]
                raw = leaf.codes if isinstance(leaf, QuantKV) else leaf
                n = raw.shape[2]
                start = seq.rank * n if seq is not None else 0
                full = F.pad(new, (0, 0, 0, start + n - s)) if start + n > s else new
                full = full[:, :, start : start + n]
                if isinstance(leaf, QuantKV):
                    qf = quantize_kv(full, leaf.bits, leaf.alpha)
                    leaf.codes.copy_(qf.codes)
                    leaf.scale.copy_(qf.scale)
                else:
                    leaf.copy_(full)
    y = out.transpose(1, 2).reshape(b, s, h_loc * cfg.head_dim)
    if _split(pspec, "wo", 0):
        return tp.comm.row_parallel(y, p["wo"].to(x.dtype), "tp.attn.wo"), cache
    return y @ p["wo"].to(x.dtype), cache


def _seq_len(leaf: Any) -> int:
    return (leaf.codes if isinstance(leaf, QuantKV) else leaf).shape[2]


def _owned_index(
    index: int | torch.Tensor, shard: int, n: int
) -> int | torch.Tensor | None:
    """A global decode position in the local rows of sequence shard
    ``shard`` (``n`` rows): an int, or None where another shard holds it; a
    (B,) tensor, with ``n`` (past the end, so :func:`seq_update` drops the
    write) where another shard holds a row's position."""
    if isinstance(index, int):
        local = index - shard * n
        return local if 0 <= local < n else None
    local = index - shard * n
    return torch.where((local >= 0) & (local < n), local, n)
