"""Prefill attention on Hopper: the wrapper of ``csrc/flash_attention.cu``.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention_pallas``.
The kernel is bound by operations: about 400 FLOP a byte at gemma3-1b's
prefill shape, above the card's bf16 ridge (see the note at the top of the
source). So bf16 inputs go to the tensor cores: one block of 4 warps per
(64-row query tile, head, batch), S = Q K^T and O += P V by ``mma.sync``
m16n8k16 from ``ldmatrix`` operands, 64-key K/V tiles double-buffered in
shared memory by ``cp.async``, the online softmax in f32 registers, only
the key tiles inside the causal window visited, the heaviest query tiles
launched first. f32 inputs, which no serving path gives it, take a scalar
f32 FMA kernel. Its plain version is ``repro_torch.kernels.ref.attention_ref``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, launches

__all__ = ["flash_attention_cuda", "SUPPORTED_HEAD_DIMS"]

SUPPORTED_HEAD_DIMS = (32, 64, 128, 192, 256)  # 192: MLA (128 nope + 64 rope)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _fn():
    lib = build.load_library("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
    fn.argtypes += [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """q: (B, Hq, S, D); k, v: (B, Hkv, S, D), Hq % Hkv == 0 -> (B, Hq, S, D).

    Causal, optionally sliding-window (key j visible to query i iff
    i - window < j <= i); f32 softmax and accumulation; output in q's dtype."""
    if not causal:
        raise ValueError("decoder-only attention: the kernel is causal only")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise ValueError(f"{name}: want f32 or bf16 like q, got {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-D tensor")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if k.shape != (b, hkv, s, d) or v.shape != k.shape or hq % hkv:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {SUPPORTED_HEAD_DIMS}")
    scale = sm_scale if sm_scale is not None else 1.0 / float(d) ** 0.5
    out = torch.empty_like(q)
    err = _fn()(
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        out.data_ptr(),
        b,
        hq,
        hkv,
        s,
        d,
        window or 0,
        scale,
        _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches.count(flash_attention_cuda)
    return out


flash_attention_cuda.launches = 0
