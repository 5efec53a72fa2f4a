"""Dispatch by tensor device, and the kernels' launch counters.

Model and cache code call these wrappers. A tensor on the CPU takes the
kernel's plain version (``repro_torch.kernels.ref``); a CUDA tensor launches
the hand-written kernel, or the kernel's wrapper raises. There is no
fallback from a failed launch or build to the plain version.

:func:`reference_mode` routes CUDA tensors to the plain versions inside a
``with`` block, so ``chip_smoke.py`` and the tests can run the same forward
both ways on the card and compare. The serving entry points never enter it.
"""

from __future__ import annotations

import contextlib
from collections.abc import Iterator

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.log_quant import (
    log_dequantize_rows_triton,
    log_quantize_pack_triton,
    log_quantize_triton,
)

__all__ = [
    "KERNELS",
    "log_quantize",
    "log_quantize_pack",
    "log_dequantize_rows",
    "flash_attention",
    "reference_mode",
    "launch_counts",
    "reset_launch_counts",
]

# kernel name -> its launching wrapper (each carries a ``launches`` count)
KERNELS = {
    "log_quantize": log_quantize_triton,
    "log_quantize_pack": log_quantize_pack_triton,
    "log_dequantize_rows": log_dequantize_rows_triton,
    "flash_attention": flash_attention_cuda,
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


def _plain(t: torch.Tensor) -> bool:
    """True for the plain version, False for the kernel; raises on a device
    that has neither."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return _reference
    raise ValueError(f"no kernel or plain version for device {t.device}")


def launch_counts() -> dict[str, int]:
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
    return log_dequantize_rows_triton(packed, scales, bits=bits, alpha=alpha)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Prefill attention. The plain version goes by query chunks above
    ``_CHUNK_THRESHOLD`` positions."""
    if _plain(q):
        if q.shape[2] > _CHUNK_THRESHOLD:
            return ref.chunked_attention_ref(
                q, k, v, causal=causal, window=window, scale=sm_scale
            )
        return ref.attention_ref(q, k, v, causal=causal, window=window, scale=sm_scale)
    return flash_attention_cuda(
        q.contiguous(),
        k.contiguous(),
        v.contiguous(),
        causal=causal,
        window=window,
        sm_scale=sm_scale,
    )
