"""Triton kernels of the log-quant codec on Hopper: encode, fused encode +
nibble pack, and the row-scaled dequant of the KV-cache read.

Replaces, in ``src/repro/kernels/log_quant.py``:

* ``log_quantize_pallas``        -> :func:`log_quantize_triton`
* ``log_quantize_pack_pallas``   -> :func:`log_quantize_pack_triton`
* ``log_dequantize_rows_pallas`` -> :func:`log_dequantize_rows_triton`

What bounds them on the H100: bytes. Each is one elementwise pass with no
reuse: 4 bytes read and 1 (b=8) or 1/2 (b=4) written per value for the
encodes, 1 or 1/2 read and 4 written per value for the dequant, against a
few dozen operations; far below the card's ridge of ~20 f32 FLOP per byte.

What the design does about it: one program per block of 2048 flat elements
(2048 packed bytes for the fused pack, 4096 codes' worth of rows for the
dequant), masked
loads and stores so nothing is padded, codes built in registers and written
once in their final container: int8 codes, or two nibbles per byte, so the
codes never round-trip through device memory between quantize and pack.
Rounding is ``libdevice.rint`` (half to even, like ``jnp.round``) and every
division is ``div_rn`` (IEEE), so the arithmetic matches the plain version
op for op; only the last ulp of ``log1p``/``expm1`` may differ between the
device's libdevice and the host's math library.

Triton is imported when a kernel is first launched, never at module import,
so the CPU tests import this module without it. (No ``from __future__
import annotations`` here: Triton reads the ``tl.constexpr`` annotations.)
"""

import functools
from types import SimpleNamespace

import torch

from repro_torch.core.quantization import LogQuantConfig, code_dtype, f32_log1p

__all__ = [
    "log_quantize_triton",
    "log_quantize_pack_triton",
    "log_dequantize_rows_triton",
]

_BLOCK = 2048
_ROW_TILE = 4096  # codes per dequant program: rows * padded row width
_FLOAT_IN = (torch.float32, torch.bfloat16)


@functools.cache
def _kernels() -> SimpleNamespace:
    # Triton resolves the names a kernel uses through the module's globals,
    # so the language modules and the shared helper are bound there.
    global tl, libdevice, _log_code, _log_value
    import triton
    import triton.language as tl
    from triton.language.extra import libdevice

    @triton.jit
    def _log_code(y, alpha, log1p_alpha, levels):
        # sign(y) * log1p(alpha |y|) / log1p(alpha), rounded half to even, clipped
        mag = libdevice.div_rn(libdevice.log1p(alpha * tl.abs(y)), log1p_alpha)
        q = tl.where(y > 0, mag, tl.where(y < 0, -mag, 0.0))
        c = libdevice.rint(q * levels)
        return tl.minimum(tl.maximum(c, -levels), levels)

    @triton.jit
    def _log_value(code, alpha, log1p_alpha, levels):
        # sign(q) * expm1(|q| log1p(alpha)) / alpha with q = code / levels
        q = libdevice.div_rn(code, levels)
        mag = libdevice.div_rn(libdevice.expm1(tl.abs(q) * log1p_alpha), alpha)
        return tl.where(q > 0, mag, tl.where(q < 0, -mag, 0.0))

    @triton.jit
    def quantize(
        x_ptr, o_ptr, n, scale, alpha, log1p_alpha, levels, BLOCK: tl.constexpr
    ):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        x = tl.load(x_ptr + offs, mask=m, other=0.0).to(tl.float32)
        y = libdevice.div_rn(x, scale)
        c = _log_code(y, alpha, log1p_alpha, levels)
        tl.store(o_ptr + offs, c.to(o_ptr.dtype.element_ty), mask=m)

    @triton.jit
    def quantize_pack(
        x_ptr, o_ptr, n, n_bytes, scale, alpha, log1p_alpha, levels, BLOCK: tl.constexpr
    ):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        lo_i = 2 * offs
        hi_i = lo_i + 1
        # a pad element (odd n) loads 0.0 and encodes as code 0
        xl = tl.load(x_ptr + lo_i, mask=lo_i < n, other=0.0).to(tl.float32)
        xh = tl.load(x_ptr + hi_i, mask=hi_i < n, other=0.0).to(tl.float32)
        cl = _log_code(libdevice.div_rn(xl, scale), alpha, log1p_alpha, levels)
        ch = _log_code(libdevice.div_rn(xh, scale), alpha, log1p_alpha, levels)
        byte = (cl.to(tl.int32) & 0xF) | ((ch.to(tl.int32) & 0xF) << 4)
        tl.store(o_ptr + offs, byte.to(tl.int8), mask=offs < n_bytes)

    @triton.jit
    def dequant_rows(
        c_ptr,
        s_ptr,
        o_ptr,
        n_rows,
        n_bytes,
        alpha,
        log1p_alpha,
        levels,
        PACKED: tl.constexpr,
        BLOCK_R: tl.constexpr,
        BLOCK_C: tl.constexpr,
    ):
        rows = tl.program_id(0).to(tl.int64) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.arange(0, BLOCK_C)
        rm = rows < n_rows
        m = rm[:, None] & (cols[None, :] < n_bytes)
        v = tl.load(c_ptr + rows[:, None] * n_bytes + cols[None, :], mask=m, other=0)
        v = v.to(tl.int32)
        s = tl.load(s_ptr + rows, mask=rm, other=0.0)[:, None]
        if PACKED:
            v = v & 0xFF
            lo = ((v & 0xF) ^ 8) - 8  # sign-extend each 4-bit nibble
            hi = (((v >> 4) & 0xF) ^ 8) - 8
            out = o_ptr + rows[:, None] * (2 * n_bytes) + 2 * cols[None, :]
            val_lo = _log_value(lo.to(tl.float32), alpha, log1p_alpha, levels) * s
            val_hi = _log_value(hi.to(tl.float32), alpha, log1p_alpha, levels) * s
            tl.store(out, val_lo, mask=m)
            tl.store(out + 1, val_hi, mask=m)
        else:
            out = o_ptr + rows[:, None] * n_bytes + cols[None, :]
            val = _log_value(v.to(tl.float32), alpha, log1p_alpha, levels) * s
            tl.store(out, val, mask=m)

    return SimpleNamespace(
        quantize=quantize, quantize_pack=quantize_pack, dequant_rows=dequant_rows
    )


def _check_cuda(t: torch.Tensor, name: str, dtypes: tuple[torch.dtype, ...]) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")


def _consts(bits: int, alpha: float) -> tuple[float, float, float]:
    """(alpha, log1p(alpha), levels) as the f32 values the plain version uses."""
    levels = LogQuantConfig(bits=bits, alpha=alpha).levels
    return float(alpha), f32_log1p(alpha), float(levels)


def log_quantize_triton(
    x: torch.Tensor, scale: float, *, bits: int = 8, alpha: float = 10.0
) -> torch.Tensor:
    """x (any shape, f32/bf16), scalar scale (<= 0 reads as 1) -> codes,
    int8 for b <= 8 and int16 above, same shape."""
    _check_cuda(x, "x", _FLOAT_IN)
    out = torch.empty(x.shape, dtype=code_dtype(bits), device=x.device)
    n = x.numel()
    if n:
        grid = (_cdiv(n, _BLOCK),)
        safe = float(scale) if scale > 0 else 1.0
        _kernels().quantize[grid](x, out, n, safe, *_consts(bits, alpha), BLOCK=_BLOCK)
        log_quantize_triton.launches += 1
    return out


def log_quantize_pack_triton(
    x: torch.Tensor, scale: float, *, bits: int = 4, alpha: float = 10.0
) -> torch.Tensor:
    """x (any shape, f32/bf16) -> 1-D int8 of ceil(n/2) bytes, byte i =
    code[2i] | code[2i+1] << 4 of the flattened input; b <= 4 only."""
    if bits > 4:
        raise ValueError(f"nibble pack needs bits <= 4, got {bits}")
    _check_cuda(x, "x", _FLOAT_IN)
    n = x.numel()
    n_bytes = (n + 1) // 2
    out = torch.empty((n_bytes,), dtype=torch.int8, device=x.device)
    if n:
        grid = (_cdiv(n_bytes, _BLOCK),)
        safe = float(scale) if scale > 0 else 1.0
        _kernels().quantize_pack[grid](
            x, out, n, n_bytes, safe, *_consts(bits, alpha), BLOCK=_BLOCK
        )
        log_quantize_pack_triton.launches += 1
    return out


def log_dequantize_rows_triton(
    packed: torch.Tensor, scales: torch.Tensor, *, bits: int = 8, alpha: float = 10.0
) -> torch.Tensor:
    """(R, nbytes) int8 codes + (R, 1) f32 scales -> (R, d) f32, where
    d = 2 * nbytes for nibble-packed b <= 4 and d = nbytes for b = 8."""
    _check_cuda(packed, "packed", (torch.int8,))
    _check_cuda(scales, "scales", (torch.float32,))
    if packed.dim() != 2 or scales.shape != (packed.shape[0], 1):
        raise ValueError(
            f"want (R, nbytes) codes + (R, 1) scales, got "
            f"{tuple(packed.shape)} / {tuple(scales.shape)}"
        )
    r, nb = packed.shape
    is_packed = bits <= 4
    out = torch.empty(
        (r, 2 * nb if is_packed else nb), dtype=torch.float32, device=packed.device
    )
    if r and nb:
        block_c = max(16, 1 << (nb - 1).bit_length())
        block_r = max(1, _ROW_TILE // block_c)
        grid = (_cdiv(r, block_r),)
        _kernels().dequant_rows[grid](
            packed,
            scales,
            out,
            r,
            nb,
            *_consts(bits, alpha),
            PACKED=is_packed,
            BLOCK_R=block_r,
            BLOCK_C=block_c,
        )
        log_dequantize_rows_triton.launches += 1
    return out


def _cdiv(n: int, block: int) -> int:
    return -(-n // block)


log_quantize_triton.launches = 0
log_quantize_pack_triton.launches = 0
log_dequantize_rows_triton.launches = 0
