"""Dispatch by tensor device, and the kernels' launch counters.

Model, cache and codec code call these wrappers. A tensor on the CPU takes the
kernel's plain version (``repro_torch.kernels.ref``); a CUDA tensor launches
the hand-written kernel, or the kernel's wrapper raises. There is no
fallback from a failed launch or build to the plain version.

:func:`reference_mode` routes CUDA tensors to the plain versions inside a
``with`` block, so ``chip_smoke.py`` and the tests can run the same forward
both ways on the card and compare. The entry points never enter it. A CUDA
graph bakes in the choice made at its capture, so ``repro_torch.graphs``
keys its graphs on :func:`in_reference_mode`.

:func:`launch_counts` are the launches that ran on the card: a graph's
capture records its launches and each replay adds them
(``repro_torch.kernels.launches``).
"""

from __future__ import annotations

import contextlib
from collections.abc import Iterator

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.log_dequant_rows import log_dequantize_rows_cuda
from repro_torch.kernels.log_quant import (
    log_dequantize_triton,
    log_quantize_pack_triton,
    log_quantize_triton,
    pack_nibbles_triton,
)
from repro_torch.kernels.ssd_chunk import ssd_chunk_cuda

__all__ = [
    "KERNELS",
    "log_quantize",
    "log_quantize_pack",
    "log_dequantize_rows",
    "log_dequantize",
    "pack_nibbles",
    "flash_attention",
    "ssd_chunk",
    "reference_mode",
    "in_reference_mode",
    "launch_counts",
    "reset_launch_counts",
]

# kernel name -> its launching wrapper (each carries a ``launches`` count)
KERNELS = {
    "log_quantize": log_quantize_triton,
    "log_quantize_pack": log_quantize_pack_triton,
    "log_dequantize_rows": log_dequantize_rows_cuda,
    "flash_attention": flash_attention_cuda,
    "pack_nibbles": pack_nibbles_triton,
    "log_dequantize": log_dequantize_triton,
    "ssd_chunk": ssd_chunk_cuda,
}

_reference = False
# the plain attention switches to query chunks above this many positions, as
# the JAX package's XLA path does
_CHUNK_THRESHOLD = 2048


@contextlib.contextmanager
def reference_mode() -> Iterator[None]:
    """Inside the block, CUDA tensors take the plain versions too."""
    global _reference
    prev, _reference = _reference, True
    try:
        yield
    finally:
        _reference = prev


def in_reference_mode() -> bool:
    """True inside a :func:`reference_mode` block."""
    return _reference


def _plain(t: torch.Tensor) -> bool:
    """True for the plain version, False for the kernel; raises on a device
    that has neither."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        if not _reference and is_fake(t):
            # a dry run's fake tensor has no memory for a kernel to read
            raise RuntimeError(
                "a fake tensor reached a kernel's launch: trace under "
                "ops.reference_mode() (launch/dryrun.py)"
            )
        return _reference
    raise ValueError(f"no kernel or plain version for device {t.device}")


def _refuse_autograd(name: str, why: str, *ts: torch.Tensor) -> None:
    """The kernels have no backward: with grad mode on, an input that
    requires grad would come back without a ``grad_fn``, and its gradient
    would vanish silently. Raise instead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(f"the {name} kernel has no backward: {why}")


def launch_counts() -> dict[str, int]:
    """Each kernel's launches that ran on the card since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def log_quantize(
    x: torch.Tensor, scale: float, *, bits: int = 8, alpha: float = 10.0
) -> torch.Tensor:
    if _plain(x):
        return ref.log_quantize_ref(x, scale, bits, alpha)
    return log_quantize_triton(x, scale, bits=bits, alpha=alpha)


def log_quantize_pack(
    x: torch.Tensor, scale: float, *, bits: int = 4, alpha: float = 10.0
) -> torch.Tensor:
    if _plain(x):
        return ref.log_quantize_pack_ref(x, scale, bits, alpha)
    return log_quantize_pack_triton(x, scale, bits=bits, alpha=alpha)


def log_dequantize_rows(
    packed: torch.Tensor, scales: torch.Tensor, *, bits: int = 8, alpha: float = 10.0
) -> torch.Tensor:
    if _plain(packed):
        return ref.log_dequantize_rows_ref(packed, scales, bits, alpha)
    return log_dequantize_rows_cuda(packed, scales, bits=bits, alpha=alpha)


def log_dequantize(
    codes: torch.Tensor, scale: float = 1.0, *, bits: int = 8, alpha: float = 10.0
) -> torch.Tensor:
    """Expand codes (integer, or f32 means of gathered codes) to f32 values."""
    if _plain(codes):
        return ref.log_dequantize_ref(codes, scale, bits, alpha)
    return log_dequantize_triton(codes.contiguous(), scale, bits=bits, alpha=alpha)


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """Signed 4-bit int8 codes -> 1-D int8, two codes per byte."""
    if _plain(codes):
        return ref.pack_nibbles_ref(codes)
    return pack_nibbles_triton(codes.contiguous())


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    sm_scale: float | None = None,
    plain: bool = False,
) -> torch.Tensor:
    """Prefill attention. The plain version goes by query chunks above
    ``_CHUNK_THRESHOLD`` positions; ``plain=True`` takes it on any device,
    as a training forward does (the JAX package trains with its plain
    attention, ``backend="xla"``). The kernel refuses inputs that require
    grad."""
    if plain or _plain(q):
        if q.shape[2] > _CHUNK_THRESHOLD:
            return ref.chunked_attention_ref(
                q, k, v, causal=causal, window=window, scale=sm_scale
            )
        return ref.attention_ref(q, k, v, causal=causal, window=window, scale=sm_scale)
    _refuse_autograd(
        "flash_attention",
        "the JAX package trains with the plain attention, and so does the "
        "port's training forward (forward(..., plain_attention=True))",
        q,
        k,
        v,
    )
    return flash_attention_cuda(
        q.contiguous(),
        k.contiguous(),
        v.contiguous(),
        causal=causal,
        window=window,
        sm_scale=sm_scale,
    )


def ssd_chunk(
    x: torch.Tensor,
    a_cum: torch.Tensor,
    bm: torch.Tensor,
    cm: torch.Tensor,
    *,
    plain: bool = False,
) -> torch.Tensor:
    """Mamba-2's intra-chunk term: x (B, H, NC, Q, P), a_cum (B, H, NC, Q),
    bm/cm (B, G, NC, Q, N) with H % G == 0, head h reading group
    h // (H // G) -> float32 (B, H, NC, Q, P). The kernel reads the groups
    in place; the plain version takes them broadcast to heads. ``plain=True``
    takes the plain version on any device, as a training forward does (the
    JAX package differentiates its plain ``ssd_chunked``). The kernel
    refuses inputs that require grad; the plain version keeps autograd."""
    if plain or _plain(x):
        rep = x.shape[1] // bm.shape[1]
        if rep > 1:
            bm, cm = bm.repeat_interleave(rep, 1), cm.repeat_interleave(rep, 1)
        return ref.ssd_chunk_ref(x, a_cum, bm, cm)
    _refuse_autograd(
        "ssd_chunk",
        "Mamba-2 trains through the plain SSD, as the JAX package does "
        "(forward(..., plain_attention=True))",
        x,
        a_cum,
        bm,
        cm,
    )
    return ssd_chunk_cuda(x, a_cum, bm, cm)
