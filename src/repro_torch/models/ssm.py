"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060).

The counterpart of the JAX package's ``models/ssm.py``. The chunked SSD
forward splits the sequence into chunks of Q positions. The quadratic
intra-chunk term goes through ``ops.ssd_chunk``: the hand-written kernel for
a CUDA tensor, its plain version for a CPU one. The per-chunk summary
states and the carried-in state's contribution are plain torch, and the
inter-chunk recurrence is a Python loop over chunks where the JAX package
has a ``lax.scan``.

``ssd_naive`` is the step-by-step recurrence oracle of the tests. Decode is
O(1): one state update per token (the cache is the conv window and the SSM
state).

B and C keep their group dim, (B, S, G, N), through the chunked path: head h
reads group h // (H // G), the order of ``jnp.repeat`` (torch's
``repeat_interleave``, not ``Tensor.repeat``), so the groups are never
broadcast to heads in memory. With G = H the functions take the JAX ones'
pre-broadcast arguments.

Unlike the JAX package, which returns new caches, prefill and decode write
the new conv window and SSM state into the cache tensors in place (``copy_``):
they are views into the model's stacked cache leaves.

Tensor-parallel serving splits the SSM state over heads and the conv window
over channels, as the JAX package's cache specs do (:func:`mamba_forward`).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import dense_init, gated_rms_norm

__all__ = [
    "init_mamba",
    "mamba_forward",
    "init_mamba_cache",
    "ssd_chunked",
    "ssd_naive",
]

Params = dict[str, Any]


# Core SSD math. Shapes: x (B, S, H, P) already dt-weighted; a (B, S, H) =
# dt * A (log-decay per step, <= 0); bm/cm (B, S, G, N) with H % G == 0.
def _heads(t: torch.Tensor, h: int, dim: int = 2) -> torch.Tensor:
    """Groups -> heads along ``dim``, as ``jnp.repeat`` does."""
    rep = h // t.shape[dim]
    return t.repeat_interleave(rep, dim) if rep > 1 else t


def ssd_naive(x, a, bm, cm, h0=None):
    """Sequential recurrence oracle: h_t = e^{a_t} h_{t-1} + x_t B_t^T."""
    b, s, h, p = x.shape
    n = bm.shape[-1]
    bm, cm = _heads(bm, h), _heads(cm, h)
    hstate = torch.zeros((b, h, p, n), device=x.device) if h0 is None else h0
    ys = []
    for t in range(s):
        decay = torch.exp(a[:, t])[..., None, None]
        hstate = hstate * decay + torch.einsum("bhp,bhn->bhpn", x[:, t], bm[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", hstate, cm[:, t]))
    return torch.stack(ys, dim=1), hstate  # (B, S, H, P), (B, H, P, N)


def ssd_chunked(x, a, bm, cm, chunk: int, h0=None, *, plain: bool = False):
    """Chunked SSD; matches ``ssd_naive`` up to f32 association error.
    ``plain=True`` takes the intra-chunk term's plain version on any device
    (``ops.ssd_chunk``), which keeps autograd: a training forward.

    Returns (y (B, S, H, P), final_state (B, H, P, N)), both float32. A
    sequence that is not a multiple of ``chunk`` is padded at the end with
    a = 0 (decay 1) and zero x and B, so the final state is unchanged."""
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    r = h // g
    pad = (-s) % chunk
    if pad:
        zpad = lambda t: F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        x, a, bm, cm = map(zpad, (x, a, bm, cm))
    sp = x.shape[1]
    nc = sp // chunk
    # chunked views: (B, nc, Q, ...)
    xc = x.reshape(b, nc, chunk, h, p).float()
    ac = a.reshape(b, nc, chunk, h).permute(0, 3, 1, 2)  # (B, H, nc, Q)
    bc = bm.reshape(b, nc, chunk, g, n).float()
    cc = cm.reshape(b, nc, chunk, g, n).float()
    a_cum = torch.cumsum(ac.float(), dim=-1)  # (B, H, nc, Q)
    # ---- intra-chunk (quadratic, attention-like): the kernel, on views
    heads_first = (0, 3, 1, 2, 4)
    y_diag = ops.ssd_chunk(
        xc.permute(heads_first),
        a_cum,
        bc.permute(heads_first),
        cc.permute(heads_first),
        plain=plain,
    ).permute(0, 2, 3, 1, 4)  # (B, nc, Q, H, P)
    # ---- per-chunk summary states
    # (B, nc, Q, H)
    decay_states = torch.exp(a_cum[..., -1:] - a_cum).permute(0, 2, 3, 1)
    xw = (xc * decay_states[..., None]).reshape(b, nc, chunk, g, r, p)
    states = torch.einsum("bclgn,bclgrp->bcgrpn", bc, xw).reshape(b, nc, h, p, n)
    # ---- inter-chunk recurrence (sequential over chunks)
    hstate = torch.zeros((b, h, p, n), device=x.device) if h0 is None else h0.float()
    chunk_decay = torch.exp(a_cum[..., -1])  # (B, H, nc)
    prev = []
    for c in range(nc):
        prev.append(hstate)  # the state BEFORE chunk c
        hstate = hstate * chunk_decay[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1).reshape(b, nc, g, r, p, n)
    # ---- contribution of the carried-in state to each position
    state_decay = torch.exp(a_cum).permute(0, 2, 3, 1)  # (B, nc, Q, H)
    y_off = torch.einsum("bclgn,bcgrpn->bclgrp", cc, prev_states)
    y_off = y_off.reshape(b, nc, chunk, h, p) * state_decay[..., None]
    y = (y_diag + y_off).reshape(b, sp, h, p)
    return y[:, :s], hstate


# Full Mamba-2 block.
def _dims(cfg: ModelConfig):
    di = cfg.d_inner
    g, n = cfg.ssm_groups, cfg.ssm_state
    h = cfg.ssm_heads
    conv_ch = di + 2 * g * n
    return di, g, n, h, conv_ch


def init_mamba(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """Seeded in_proj, conv_w and out_proj; A_log, D, dt_bias deterministic
    (A from 1 to 16 over the heads, dt_bias the softplus inverse of dt from
    1e-3 to 0.1), as the JAX package inits them."""
    d = cfg.d_model
    di, g, n, h, conv_ch = _dims(cfg)
    k = cfg.ssm_conv
    dt_init = torch.linspace(1e-3, 0.1, h, device=device)
    return {
        "in_proj": dense_init(gen, (d, 2 * di + 2 * g * n + h), device=device),
        "conv_w": dense_init(gen, (k, conv_ch), in_dim=k, device=device),
        "conv_b": torch.zeros(conv_ch, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=device)),
        "D": torch.ones(h, device=device),
        "dt_bias": torch.log(torch.expm1(dt_init)),
        "norm": torch.zeros(di, device=device),
        "out_proj": dense_init(gen, (di, d), device=device),
    }


def init_mamba_cache(
    cfg: ModelConfig, batch: int, dtype: torch.dtype, device
) -> Params:
    """The conv window in ``dtype``; the SSM state in f32."""
    di, g, n, h, conv_ch = _dims(cfg)
    conv = (batch, cfg.ssm_conv - 1, conv_ch)
    return {
        "conv": torch.zeros(conv, dtype=dtype, device=device),
        "ssm": torch.zeros((batch, h, cfg.ssm_head_dim, n), device=device),
    }


def _split_in(proj, cfg):
    di, g, n, h, _ = _dims(cfg)
    z = proj[..., :di]
    xbc = proj[..., di : 2 * di + 2 * g * n]
    dt = proj[..., 2 * di + 2 * g * n :]
    return z, xbc, dt


def _causal_conv(xbc, w, bias):
    """Depthwise causal conv of width K, xbc (B, S, C) and w (K, C): the sum
    of K shifted products in the JAX package's order. (``F.conv1d`` would go
    through cuDNN, in TF32 by default.)"""
    k, s = w.shape[0], xbc.shape[1]
    xp = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(xp[:, i : i + s, :] * w[i] for i in range(k))
    return out + bias


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)).
    torch's ``F.softplus`` returns x itself above its threshold of 20; the
    two differ far below f32 noise, but this is the JAX formula op for op."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def _ssm_inputs(xbc_conv, dt_raw, p: Params, cfg: ModelConfig):
    """(xs (B,S,H,P), bm/cm (B,S,G,N), dt (B,S,H), a (H,)), all f32; the bf16
    parameters promote to f32 where they meet f32 activations, as in JAX."""
    di, g, n, h, _ = _dims(cfg)
    b, s = xbc_conv.shape[0], xbc_conv.shape[1]
    xbc_conv = F.silu(xbc_conv.float())
    xs = xbc_conv[..., :di].reshape(b, s, h, cfg.ssm_head_dim)
    bm = xbc_conv[..., di : di + g * n].reshape(b, s, g, n)
    cm = xbc_conv[..., di + g * n :].reshape(b, s, g, n)
    dt = _softplus(dt_raw.float() + p["dt_bias"])  # (B, S, H)
    a = -torch.exp(p["A_log"].float())  # (H,)
    return xs, bm, cm, dt, a


def _heads_of(t: torch.Tensor, n_heads: int, first: int, count: int) -> torch.Tensor:
    """The groups (dim 2 of a (B, S, G, N) B or C) that heads ``first`` ..
    ``first + count - 1`` of ``n_heads`` read, laid out so that local head
    i reads group ``i // (count / groups returned)``, as :func:`_heads`
    repeats them: a slice of whole groups where the heads cover them
    evenly, else one group a head."""
    if count == n_heads:
        return t
    r = n_heads // t.shape[2]
    idx = [(first + i) // r for i in range(count)]
    lo, n = idx[0], idx[-1] + 1 - idx[0]
    if count % n == 0 and idx == [lo + i // (count // n) for i in range(count)]:
        return t[:, :, lo : lo + n]
    return t.index_select(2, torch.tensor(idx, device=t.device))


class _Split:
    """A rank's part of a Mamba-2 layer over the model axis, read from the
    shapes of its cache shard (``serving/engine.py:cache_specs``): the SSM
    state's heads ``h0`` .. ``h0 + h - 1`` and the conv window's channels
    ``c0`` .. ``c0 + c - 1`` (all of them where the spec does not split
    them). The projections and the conv weights replicate, so every rank
    computes the conv over all channels and its heads' scan."""

    def __init__(self, cfg: ModelConfig, cache: Params | None, tp: Any):
        _, _, _, heads, conv_ch = _dims(cfg)
        self.tp = tp
        self.h = cache["ssm"].shape[1] if cache is not None else heads
        self.c = cache["conv"].shape[2] if cache is not None else conv_ch
        self.heads_split, self.conv_split = self.h < heads, self.c < conv_ch
        self.h0 = tp.comm.rank * self.h if self.heads_split else 0
        self.c0 = tp.comm.rank * self.c if self.conv_split else 0
        self.n_heads = heads

    def heads(self, xs, bm, cm, dt, a):
        """The scan's inputs of this rank's heads."""
        if not self.heads_split:
            return xs, bm, cm, dt, a
        hs = slice(self.h0, self.h0 + self.h)
        pick = lambda t: _heads_of(t, self.n_heads, self.h0, self.h)
        return xs[:, :, hs], pick(bm), pick(cm), dt[..., hs], a[hs]

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """(B, S, h * P) -> every head's (B, S, d_inner), in head order."""
        if not self.heads_split:
            return y
        return self.tp.comm.all_gather(y, -1, "tp.ssm.y")

    def window(self, conv: torch.Tensor) -> torch.Tensor:
        """A conv window shard (B, K - 1, c) -> every channel's."""
        if not self.conv_split:
            return conv
        return self.tp.comm.all_gather(conv, -1, "tp.ssm.conv")

    def channels(self, t: torch.Tensor) -> torch.Tensor:
        return t[..., self.c0 : self.c0 + self.c]


def mamba_forward(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    cache: Params | None = None,
    plain: bool = False,
    tp: Any = None,
) -> tuple[torch.Tensor, Params | None]:
    """Full-sequence (train/prefill) or single-token (decode) Mamba-2 block.
    With a cache, a one-token input is decode, as in the JAX package.
    ``plain=True`` (a training forward) takes the SSD's plain version on any
    device, so autograd runs through it.

    Over the model axis (``tp``, serving): the projections replicate (the
    JAX rule), the cache's SSM state splits over heads and its conv window
    over contiguous channels (:class:`_Split`). A rank convolves every
    channel (a decode step first gathers the conv window's shards,
    ``tp.ssm.conv``), scans its heads only (the SSD kernel on them), and
    the heads' outputs are gathered (``tp.ssm.y``) before the gated norm
    over the whole ``d_inner`` and the replicated ``out_proj``, which every
    rank then computes alike."""
    b, s, _ = x.shape
    di = cfg.d_inner
    split = _Split(cfg, cache, tp) if tp is not None else None
    proj = x @ p["in_proj"].to(x.dtype)
    z, xbc, dt_raw = _split_in(proj, cfg)

    if cache is not None and s == 1:
        return _mamba_step(p, cfg, z, xbc, dt_raw, cache, split)

    xbc_conv = _causal_conv(xbc.float(), p["conv_w"], p["conv_b"])
    xs, bm, cm, dt, a = _ssm_inputs(xbc_conv, dt_raw, p, cfg)
    d_skip = p["D"].float()
    if split is not None:
        xs, bm, cm, dt, a = split.heads(xs, bm, cm, dt, a)
        d_skip = d_skip[split.h0 : split.h0 + split.h]
    y, h_last = ssd_chunked(
        xs * dt[..., None], dt * a, bm, cm, cfg.ssm_chunk, plain=plain
    )
    y = y + xs * d_skip[:, None]
    y = y.reshape(b, s, -1).to(x.dtype)
    if split is not None:
        y = split.gather(y)
    y = gated_rms_norm(y, z, p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)

    if cache is not None:
        kw = cfg.ssm_conv - 1
        tail = xbc[:, -kw:, :] if s >= kw else F.pad(xbc, (0, 0, kw - s, 0))
        cache["conv"].copy_(split.channels(tail) if split is not None else tail)
        cache["ssm"].copy_(h_last)
    return out, cache


def _mamba_step(p: Params, cfg: ModelConfig, z, xbc, dt_raw, cache, split=None):
    """O(1) decode update, written into ``cache`` in place (over the model
    axis, a rank's :class:`_Split` of it)."""
    b = z.shape[0]
    di, g, n, h, conv_ch = _dims(cfg)
    conv_win = cache["conv"] if split is None else split.window(cache["conv"])
    window = torch.cat([conv_win.float(), xbc.float()], dim=1)  # (B, K, C)
    w = p["conv_w"]
    conv = sum(window[:, i] * w[i] for i in range(w.shape[0])) + p["conv_b"]
    xs, bm, cm, dt, a = _ssm_inputs(conv[:, None, :], dt_raw, p, cfg)
    d_skip = p["D"]
    if split is not None:
        xs, bm, cm, dt, a = split.heads(xs, bm, cm, dt, a)
        d_skip = d_skip[split.h0 : split.h0 + split.h]
    h = xs.shape[2]
    xs, dt = xs[:, 0], dt[:, 0]  # drop the seq dim
    bm, cm = _heads(bm[:, 0], h, 1), _heads(cm[:, 0], h, 1)  # (B, H, N)
    decay = torch.exp(dt * a)  # (B, H)
    hs = cache["ssm"] * decay[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", xs * dt[..., None], bm
    )
    y = torch.einsum("bhpn,bhn->bhp", hs, cm) + xs * d_skip[:, None]
    y = y.reshape(b, 1, -1).to(z.dtype)
    if split is not None:
        y = split.gather(y)
    y = gated_rms_norm(y, z, p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(z.dtype)
    new_win = window[:, 1:, :]
    cache["conv"].copy_(split.channels(new_win) if split is not None else new_win)
    cache["ssm"].copy_(hs)
    return out, cache
