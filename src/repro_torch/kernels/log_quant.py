"""Triton kernels of the log-quant codec on Hopper: encode, fused encode +
nibble pack, the dequant of the training wire (the expand of averaged
codes) and the bare nibble pack. (The row dequant of the KV-cache read is
CUDA C++: ``kernels/log_dequant_rows.py``.)

Replaces, in ``src/repro/kernels/log_quant.py``:

* ``log_quantize_pallas``        -> :func:`log_quantize_triton`
* ``pack_nibbles_pallas``        -> :func:`pack_nibbles_triton`
* ``log_quantize_pack_pallas``   -> :func:`log_quantize_pack_triton`
* ``log_dequantize_pallas``      -> :func:`log_dequantize_triton`

What bounds them on the H100: bytes. Each is one elementwise pass with no
reuse: 4 bytes read and 1 (b=8) or 1/2 (b=4) written per value for the
encodes, 4 read and 4 written for the wire dequant (its input is the f32
mean of gathered codes), 1 read and 1/2 written for the pack, against a few
dozen operations; far below the card's ridge of ~20 f32 FLOP per byte.

What the design does about it: one program per block of flat elements,
masked loads and stores so nothing is padded, codes built in registers and
written once in their final container: int8 codes, or two nibbles per
byte, so the codes never round-trip through device memory between quantize
and pack. The encode (:func:`log_quantize_triton`), the fused encode + pack
(:func:`log_quantize_pack_triton`) and the wire dequant
(:func:`log_dequantize_triton`) take their block and warps from n
(:func:`launch_shape` over ``QUANTIZE_LAUNCH``, ``PACK_LAUNCH`` and
``DEQUANT_LAUNCH``): a decode append of one token (1024 values) runs as
several programs of a value or two a thread on as many SMs, rather than
one program whose threads walk 16 values each; larger inputs take one
16-byte load a thread, a prefill's million values in thousands of
programs. The fused pack loads its 2 x BLOCK inputs as one contiguous run
and splits it into the [BLOCK, 2] pairs of its bytes in registers (no
stride-2 loads; at two bytes a thread the split stays in registers, at
four Triton moved it through shared memory). Their unit scale, which every
serving and training caller passes (the codec normalizes first), is a
compile-time case that drops the division or multiply by 1 (exact, so no
code or value changes). The bare pack (:func:`pack_nibbles_triton`) reads
its codes the same way, 2 x BLOCK in one contiguous run paired in
registers, with its block and warps from its packed bytes
(``NIBBLE_LAUNCH``): on large inputs two 16-byte loads and a 16-byte store
a thread. A masked load is a vector load only where Triton knows its
bound n to be a multiple of 16, as every training leaf's is; for other n
the whole groups of 16 codes load that way and the program that holds the
last n % 16 codes loads those alone.
Rounding is ``libdevice.rint`` (half to even, like ``jnp.round``) and
every division is ``div_rn`` (IEEE), so the arithmetic matches the plain
version op for op; only the last ulp of ``log1p``/``expm1`` may differ
between the device's libdevice and the host's math library.

Triton is imported when a kernel is first launched, never at module import,
so the CPU tests import this module without it. (No ``from __future__
import annotations`` here: Triton reads the ``tl.constexpr`` annotations.)
"""

import functools
from types import SimpleNamespace

import torch

from repro_torch.core.quantization import LogQuantConfig, code_dtype, f32_log1p
from repro_torch.kernels import launches

__all__ = [
    "QUANTIZE_LAUNCH",
    "PACK_LAUNCH",
    "DEQUANT_LAUNCH",
    "NIBBLE_LAUNCH",
    "launch_shape",
    "quantize_launch",
    "log_quantize_triton",
    "log_quantize_pack_triton",
    "log_dequantize_triton",
    "pack_nibbles_triton",
]

# Launch shapes: (largest n, BLOCK, num_warps), by n; the last row takes
# every larger n. log_quantize's, in values:
QUANTIZE_LAUNCH = (
    (1 << 14, 128, 4),  # decode appends: one value a thread, 8 programs at 1024
    (None, 512, 4),  # four values a thread, one 16-byte load; >= 33 programs
)
# log_quantize_pack's, in packed bytes (two values each); at four bytes a
# thread the pairs' split went through shared memory and ran ~20% slower
PACK_LAUNCH = (
    (1 << 13, 128, 4),  # decode appends: a byte a thread, 4 programs at 512 bytes
    (None, 256, 4),  # two bytes a thread, one 16-byte load; >= 33 programs
)
# log_dequantize's, in values:
DEQUANT_LAUNCH = (
    (1 << 16, 128, 4),  # the training wire's tensors: one value a thread
    (None, 512, 4),  # four values a thread, one 16-byte load
)
# pack_nibbles's, in packed bytes (two codes each):
NIBBLE_LAUNCH = (
    (1 << 13, 128, 4),  # a byte a thread: QSGD's small leaves span several SMs
    (None, 2048, 4),  # 16 bytes a thread: two 16-byte loads, one 16-byte store
)
_FLOAT_IN = (torch.float32, torch.bfloat16)
# the wire dequant takes integer codes or the f32 mean of gathered codes
_CODES_IN = (torch.float32, torch.bfloat16, torch.int8, torch.int16)


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
        x_ptr,
        o_ptr,
        n,
        scale,
        alpha,
        log1p_alpha,
        levels,
        BLOCK: tl.constexpr,
        UNIT: tl.constexpr,
    ):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        x = tl.load(x_ptr + offs, mask=m, other=0.0).to(tl.float32)
        if UNIT:  # x / 1.0 is x
            y = x
        else:
            y = libdevice.div_rn(x, scale)
        c = _log_code(y, alpha, log1p_alpha, levels)
        tl.store(o_ptr + offs, c.to(o_ptr.dtype.element_ty), mask=m)

    @triton.jit
    def quantize_pack(
        x_ptr,
        o_ptr,
        n,
        n_bytes,
        scale,
        alpha,
        log1p_alpha,
        levels,
        BLOCK: tl.constexpr,
        UNIT: tl.constexpr,
    ):
        # the program's 2 x BLOCK inputs in one contiguous load, then split
        # into the low and high value of each byte; a pad element (odd n)
        # loads 0.0 and encodes as code 0
        pid = tl.program_id(0).to(tl.int64)
        idx = pid * (2 * BLOCK) + tl.arange(0, 2 * BLOCK)
        x = tl.load(x_ptr + idx, mask=idx < n, other=0.0).to(tl.float32)
        if UNIT:  # x / 1.0 is x
            y = x
        else:
            y = libdevice.div_rn(x, scale)
        c = _log_code(y, alpha, log1p_alpha, levels).to(tl.int32) & 0xF
        lo, hi = tl.split(tl.reshape(c, (BLOCK, 2)))
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        tl.store(o_ptr + offs, (lo | (hi << 4)).to(tl.int8), mask=offs < n_bytes)

    @triton.jit
    def dequant(
        c_ptr,
        o_ptr,
        n,
        scale,
        alpha,
        log1p_alpha,
        levels,
        BLOCK: tl.constexpr,
        UNIT: tl.constexpr,
    ):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        c = tl.load(c_ptr + offs, mask=m, other=0).to(tl.float32)
        val = _log_value(c, alpha, log1p_alpha, levels)
        if not UNIT:  # v * 1.0 is v
            val = val * scale
        tl.store(o_ptr + offs, val, mask=m)

    @triton.jit
    def pack(c_ptr, o_ptr, n, n_bytes, BLOCK: tl.constexpr, EXACT: tl.constexpr):
        # the program's 2 x BLOCK codes in one contiguous load, split into the
        # low and high code of each byte; a pad code (odd n) loads as 0
        pid = tl.program_id(0).to(tl.int64)
        idx = pid * (2 * BLOCK) + tl.arange(0, 2 * BLOCK)
        if EXACT:  # n a multiple of 16: the masked loads stay vector loads
            c = tl.load(c_ptr + idx, mask=idx < n, other=0)
        else:  # whole groups of 16 codes by vector loads, the rest (< 16 codes,
            # in one program) by that program alone
            n16 = (n // 16) * 16
            c = tl.load(c_ptr + idx, mask=idx < n16, other=0)
            if pid == (n - 1) // (2 * BLOCK):
                c += tl.load(c_ptr + idx, mask=(idx >= n16) & (idx < n), other=0)
        c = c.to(tl.int32) & 0xF
        lo, hi = tl.split(tl.reshape(c, (BLOCK, 2)))
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        tl.store(o_ptr + offs, (lo | (hi << 4)).to(tl.int8), mask=offs < n_bytes)

    return SimpleNamespace(
        quantize=quantize,
        quantize_pack=quantize_pack,
        dequant=dequant,
        pack=pack,
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
        block, warps = quantize_launch(n)
        safe = float(scale) if scale > 0 else 1.0
        _kernels().quantize[(_cdiv(n, block),)](
            x,
            out,
            n,
            safe,
            *_consts(bits, alpha),
            BLOCK=block,
            UNIT=safe == 1.0,
            num_warps=warps,
        )
        launches.count(log_quantize_triton)
    return out


def launch_shape(table, n: int) -> tuple[int, int]:
    """(BLOCK, num_warps) for n from a launch table: its first row whose
    bound n does not exceed."""
    for top, block, warps in table:
        if top is None or n <= top:
            return block, warps
    raise AssertionError("a launch table needs a last row with no bound")


def quantize_launch(n: int) -> tuple[int, int]:
    """(BLOCK, num_warps) of :func:`log_quantize_triton` for n values."""
    return launch_shape(QUANTIZE_LAUNCH, n)


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
        block, warps = launch_shape(PACK_LAUNCH, n_bytes)
        safe = float(scale) if scale > 0 else 1.0
        _kernels().quantize_pack[(_cdiv(n_bytes, block),)](
            x,
            out,
            n,
            n_bytes,
            safe,
            *_consts(bits, alpha),
            BLOCK=block,
            UNIT=safe == 1.0,
            num_warps=warps,
        )
        launches.count(log_quantize_pack_triton)
    return out


def log_dequantize_triton(
    codes: torch.Tensor, scale: float, *, bits: int = 8, alpha: float = 10.0
) -> torch.Tensor:
    """Codes of any shape (int8/int16, or f32/bf16 means of codes) and a
    scalar scale -> f32 values, same shape."""
    _check_cuda(codes, "codes", _CODES_IN)
    out = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    n = codes.numel()
    if n:
        block, warps = launch_shape(DEQUANT_LAUNCH, n)
        scale = float(scale)
        _kernels().dequant[(_cdiv(n, block),)](
            codes,
            out,
            n,
            scale,
            *_consts(bits, alpha),
            BLOCK=block,
            UNIT=scale == 1.0,
            num_warps=warps,
        )
        launches.count(log_dequantize_triton)
    return out


def pack_nibbles_triton(codes: torch.Tensor) -> torch.Tensor:
    """Signed 4-bit codes (int8, any shape) -> 1-D int8 of ceil(n/2) bytes,
    byte i = code[2i] | code[2i+1] << 4 of the flattened input."""
    _check_cuda(codes, "codes", (torch.int8,))
    n = codes.numel()
    n_bytes = (n + 1) // 2
    out = torch.empty((n_bytes,), dtype=torch.int8, device=codes.device)
    if n:
        block, warps = launch_shape(NIBBLE_LAUNCH, n_bytes)
        _kernels().pack[(_cdiv(n_bytes, block),)](
            codes, out, n, n_bytes, BLOCK=block, EXACT=n % 16 == 0, num_warps=warps
        )
        launches.count(pack_nibbles_triton)
    return out


def _cdiv(n: int, block: int) -> int:
    return -(-n // block)


log_quantize_triton.launches = 0
log_quantize_pack_triton.launches = 0
log_dequantize_triton.launches = 0
pack_nibbles_triton.launches = 0
