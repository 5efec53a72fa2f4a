"""The KV-cache read's row dequant on Hopper: the wrapper of
``csrc/log_dequant_rows.cu``.

Replaces ``src/repro/kernels/log_quant.py::log_dequantize_rows_pallas``. The
kernel is bound by bytes (see the note at the top of the source): each block
fills a shared table with the value of all 256 code bytes, computed as the
plain version computes them, and each thread then turns 16 code bytes into
16 (b = 8) or 32 (b <= 4) scaled f32 with one 16-byte load, table lookups
and float4 stores. Its plain version is
``repro_torch.kernels.ref.log_dequantize_rows_ref``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, launches
from repro_torch.kernels.log_quant import _check_cuda, _consts

__all__ = ["log_dequantize_rows_cuda"]


@functools.cache
def _fn():
    lib = build.load_library("log_dequant_rows")
    fn = lib.log_dequant_rows
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 2
    fn.argtypes += [ctypes.c_float] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def log_dequantize_rows_cuda(
    packed: torch.Tensor, scales: torch.Tensor, *, bits: int = 8, alpha: float = 10.0
) -> torch.Tensor:
    """(R, nbytes) int8 codes + (R, 1) f32 scales -> (R, d) f32, where
    d = 2 * nbytes for nibble-packed b <= 4 and d = nbytes for b = 8. The
    codes start on a 16-byte boundary, as every allocation does."""
    _check_cuda(packed, "packed", (torch.int8,))
    _check_cuda(scales, "scales", (torch.float32,))
    if packed.dim() != 2 or scales.shape != (packed.shape[0], 1):
        raise ValueError(
            f"want (R, nbytes) codes + (R, 1) scales, got "
            f"{tuple(packed.shape)} / {tuple(scales.shape)}"
        )
    if packed.data_ptr() % 16:
        raise ValueError("packed must start on a 16-byte boundary")
    r, nb = packed.shape
    is_packed = bits <= 4
    out = torch.empty(
        (r, 2 * nb if is_packed else nb), dtype=torch.float32, device=packed.device
    )
    if r and nb:
        err = _fn()(
            packed.data_ptr(),
            scales.data_ptr(),
            out.data_ptr(),
            r,
            nb,
            int(is_packed),
            *_consts(bits, alpha),
            torch.cuda.current_stream(packed.device).cuda_stream,
        )
        if err:
            raise RuntimeError(f"log_dequant_rows launch failed: CUDA error {err}")
        launches.count(log_dequantize_rows_cuda)
    return out


log_dequantize_rows_cuda.launches = 0
