"""Plain PyTorch versions of every kernel of the serving slice.

The CPU path runs these; on the card ``chip_smoke.py`` and the tests hold
each hand-written kernel against them on the same inputs. They repeat the
JAX package's oracle math (``repro/kernels/ref.py``, ``core/quantization.py``)
op for op, so they are also what the CPU tests compare with JAX.
"""

from __future__ import annotations

import torch

from repro_torch.core import codec
from repro_torch.core.quantization import LogQuantConfig, f32_div, log_expand, quantize

__all__ = [
    "log_quantize_ref",
    "log_quantize_pack_ref",
    "log_dequantize_rows_ref",
    "attention_ref",
    "chunked_attention_ref",
]


def log_quantize_ref(
    x: torch.Tensor, scale: float, bits: int, alpha: float
) -> torch.Tensor:
    """Normalize by ``scale`` (<= 0 reads as 1), then log-quantize to codes."""
    safe = scale if scale > 0 else 1.0
    return quantize(f32_div(x.float(), safe), LogQuantConfig(bits=bits, alpha=alpha))


def log_quantize_pack_ref(
    x: torch.Tensor, scale: float, bits: int, alpha: float
) -> torch.Tensor:
    """Quantize then nibble-pack: 1-D int8 of ``ceil(x.numel() / 2)`` bytes."""
    if bits > 4:
        raise ValueError(f"nibble pack needs bits <= 4, got {bits}")
    return codec.pack_nibbles(log_quantize_ref(x, scale, bits, alpha))


def log_dequantize_rows_ref(
    packed: torch.Tensor, scales: torch.Tensor, bits: int, alpha: float
) -> torch.Tensor:
    """Row-scaled dequant: (R, nbytes) int8 + (R, 1) f32 -> (R, d) f32, with
    d = 2 * nbytes for nibble-packed b <= 4 and d = nbytes for b = 8."""
    levels = LogQuantConfig(bits=bits, alpha=alpha).levels
    if bits <= 4:
        codes = codec.unpack_nibbles(packed, 2 * packed.shape[-1])
    else:
        codes = packed
    vals = log_expand(f32_div(codes.float(), levels), alpha)
    return vals * scales.float()


def _repeat_kv(k: torch.Tensor, rep: int) -> torch.Tensor:
    return k.repeat_interleave(rep, dim=1) if rep > 1 else k


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Multi-head attention with GQA and causal/sliding-window masks, in f32.

    q: (B, Hq, S, D); k, v: (B, Hkv, S, D) with Hq % Hkv == 0. ``window=w``
    keeps key j for query i iff i - w < j <= i. Output is in q's dtype."""
    b, hq, s, d = q.shape
    rep = hq // k.shape[1]
    k = _repeat_kv(k, rep).float()
    v = _repeat_kv(v, rep).float()
    sc = scale if scale is not None else 1.0 / float(d) ** 0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) * sc
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= j > i - window
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(q.dtype)


def chunked_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    chunk_q: int = 512,
) -> torch.Tensor:
    """``attention_ref``'s math over query chunks: peak memory
    O(B*H*chunk_q*S) instead of O(B*H*S*S); masks with -1e30 as the JAX
    version does."""
    b, hq, s, d = q.shape
    rep = hq // k.shape[1]
    k32 = _repeat_kv(k, rep).float()
    v32 = _repeat_kv(v, rep).float()
    sc = scale if scale is not None else 1.0 / float(d) ** 0.5
    kpos = torch.arange(s, device=q.device)[None, :]
    outs = []
    for c0 in range(0, s, chunk_q):
        qc = q[:, :, c0 : c0 + chunk_q].float()
        logits = torch.einsum("bhqd,bhkd->bhqk", qc, k32) * sc
        qpos = c0 + torch.arange(qc.shape[2], device=q.device)[:, None]
        m = torch.ones((qc.shape[2], s), dtype=torch.bool, device=q.device)
        if causal:
            m &= kpos <= qpos
        if window is not None:
            m &= kpos > qpos - window
        logits = logits.masked_fill(~m, -1e30)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, -1), v32))
    return torch.cat(outs, dim=2).to(q.dtype)
