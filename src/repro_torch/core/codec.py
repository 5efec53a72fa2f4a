"""The wire codec, serving subset: nibble packing and the log-quant codec.

A :class:`WireCodec` turns a normalized float tensor into the exact array
that is stored or shipped (``encode``), recovers code values from those bytes
(``decode``) and maps (possibly averaged) codes back to values (``expand``).
``wire_bits`` reports the byte size of the encoded array: b <= 4 codes are
nibble-packed two per int8 byte, so accounting and array bytes agree.

The KV cache stores exactly these bytes, which is why the serving slice
needs the codec. ``codec_phase``, the collective layer and the randomized
codecs of the JAX package belong to the training slice.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.quantization import LogQuantConfig, f32_div, log_expand

__all__ = [
    "WireCodec",
    "LogQuantCodec",
    "pack_nibbles",
    "unpack_nibbles",
    "packed_wire_bits",
]


# --------------------------------------------------------------------------
# bit packing: two 4-bit two's-complement codes per int8 byte
# --------------------------------------------------------------------------


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """Signed codes in [-8, 7] (any shape) -> 1-D int8, byte i = c[2i] | c[2i+1]<<4.

    An odd count pads with a zero code."""
    flat = codes.reshape(-1).to(torch.int32)
    if flat.numel() % 2:
        flat = torch.nn.functional.pad(flat, (0, 1))
    lo, hi = flat[0::2], flat[1::2]
    return ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.uint8).view(torch.int8)


def unpack_nibbles(packed: torch.Tensor, numel: int) -> torch.Tensor:
    """Packed int8 (..., nbytes) -> signed int32 codes (..., numel)."""
    v = packed.to(torch.int32) & 0xFF
    lo = ((v & 0xF) ^ 8) - 8  # sign-extend a 4-bit two's-complement nibble
    hi = (((v >> 4) & 0xF) ^ 8) - 8
    codes = torch.stack([lo, hi], dim=-1)
    return codes.reshape(packed.shape[:-1] + (-1,))[..., :numel]


def packed_wire_bits(numel: int, bits: int) -> int:
    """Exact bits of the encoded array: nibble-packed int8 for b<=4, int8
    for b<=8, int16 above, matching the containers ``encode`` emits."""
    if bits <= 4:
        return ((numel + 1) // 2) * 8
    if bits <= 8:
        return numel * 8
    return numel * 16


# --------------------------------------------------------------------------
# codecs
# --------------------------------------------------------------------------


class WireCodec:
    """Protocol: what a cache or a compressor needs to store a tensor as codes.

    ``codes``   normalized values -> integer code array, same shape;
    ``encode``  normalized values -> the 1-D stored array (packed for b<=4);
    ``decode``  stored array (..., nbytes|numel) -> float codes (..., numel);
    ``expand``  (possibly averaged) float codes -> normalized values;
    ``wire_bits``  exact bits of ``encode``'s output for ``numel`` elements;
    ``scale_bits`` bits of the scale sideband (0 when ``needs_scale`` is False).
    """

    bits: int = 32
    needs_scale: bool = True

    def codes(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def decode(self, wire: torch.Tensor, numel: int) -> torch.Tensor:
        raise NotImplementedError

    def expand(self, codes: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def wire_bits(self, numel: int) -> int:
        raise NotImplementedError

    def scale_bits(self, n_scales: int) -> int:
        return 32 * n_scales if self.needs_scale else 0


@dataclasses.dataclass(frozen=True)
class LogQuantCodec(WireCodec):
    """Paper Eq. 5/6 log-quantizer.

    ``codes`` and ``encode`` go through ``repro_torch.kernels.ops``: on a
    CUDA tensor the Triton kernels (b=8 encode, fused b<=4 encode + pack),
    on a CPU tensor their plain versions; both emit the same bytes."""

    bits: int = 8
    alpha: float = 10.0
    needs_scale: bool = True

    @property
    def _cfg(self) -> LogQuantConfig:
        return LogQuantConfig(bits=self.bits, alpha=self.alpha)

    def codes(self, x):
        from repro_torch.kernels import ops  # ops -> ref -> codec: import late

        return ops.log_quantize(x, 1.0, bits=self.bits, alpha=self.alpha)

    def encode(self, x):
        if self.bits <= 4:
            from repro_torch.kernels import ops

            # one fused pass: quantize + nibble-pack, so the int8 codes never
            # round-trip through device memory between two launches
            return ops.log_quantize_pack(x, 1.0, bits=self.bits, alpha=self.alpha)
        return self.codes(x).reshape(-1)

    def decode(self, wire, numel):
        if self.bits <= 4:
            return unpack_nibbles(wire, numel).float()
        return wire.float()

    def expand(self, codes):
        return log_expand(f32_div(codes.float(), self._cfg.levels), self.alpha)

    def wire_bits(self, numel):
        return packed_wire_bits(numel, self.bits)
