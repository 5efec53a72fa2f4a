"""Logarithmic quantization (paper Eq. 5/6) with b-bit discretization.

The paper's map:  q(x) = sign(x) * log(1 + alpha*|x|) / log(1 + alpha)
inverse (Eq. 6):  x(q) = sign(q) * ((1 + alpha)^{|q|} - 1) / alpha

Inputs are normalized to ``|x| <= 1`` by a scale that travels beside the
codes. The normalized magnitude is discretized to ``L = 2^(b-1) - 1`` levels
with the sign folded in: codes lie in ``[-L, L]`` and are stored as int8
(b <= 8) or int16. Rounding is half to even, as ``jnp.round`` rounds.

The arithmetic follows the JAX package op for op (f32 throughout, the same
order of multiply and divide), so codes agree byte for byte except where a
last-ulp difference of ``log1p`` between math libraries moves ``q * L``
across a half-integer.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

__all__ = [
    "LogQuantConfig",
    "log_compress",
    "log_expand",
    "quantize",
    "dequantize",
    "code_dtype",
    "wire_bits",
    "f32_log1p",
    "f32_div",
]


@dataclasses.dataclass(frozen=True)
class LogQuantConfig:
    """Static parameters of the log-quantizer.

    bits:  total bits per scalar on the wire (sign + magnitude), paper b=8.
    alpha: curvature of the log map (paper Eq. 5), alpha > 0.
    """

    bits: int = 8
    alpha: float = 10.0

    def __post_init__(self):
        if not (2 <= self.bits <= 16):
            raise ValueError(f"bits must be in [2, 16], got {self.bits}")
        if self.alpha <= 0:
            raise ValueError(f"alpha must be > 0, got {self.alpha}")

    @property
    def levels(self) -> int:
        """Positive magnitude levels, 2^(b-1) - 1, so codes are symmetric."""
        return (1 << (self.bits - 1)) - 1


def code_dtype(bits: int) -> torch.dtype:
    return torch.int8 if bits <= 8 else torch.int16


def wire_bits(n_elements: int, bits: int) -> int:
    """Bits on the wire for ``n_elements`` quantized scalars (+32 for scale)."""
    return n_elements * bits + 32


@functools.cache
def f32_log1p(alpha: float) -> float:
    """``log1p(alpha)`` evaluated in float32, as ``jnp.log1p(alpha)`` is, held
    as a Python float (exactly that f32 value): an f32 tensor op with it
    computes as with the f32 scalar, and no device tensor is made for it."""
    return float(torch.log1p(torch.tensor(alpha, dtype=torch.float32)))


def f32_div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` as one IEEE f32 division, as JAX and the kernels divide.

    PyTorch's CUDA division by a Python scalar multiplies by the scalar's
    reciprocal, which can be an ulp off and move a code across a bin edge.
    Dividing by a 0-dim tensor on x's device is a true division; ``torch.full``
    makes it without a host-to-device copy, so the plain versions stay
    capturable in a CUDA graph."""
    return x / torch.full((), divisor, dtype=torch.float32, device=x.device)


def log_compress(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """Paper Eq. 5 on normalized input: sign(x)*log1p(a|x|)/log1p(a)."""
    return f32_div(torch.sign(x) * torch.log1p(alpha * x.abs()), f32_log1p(alpha))


def log_expand(q: torch.Tensor, alpha: float) -> torch.Tensor:
    """Paper Eq. 6: sign(q)*((1+a)^{|q|} - 1)/a (inverse of log_compress)."""
    return f32_div(torch.sign(q) * torch.expm1(q.abs() * f32_log1p(alpha)), alpha)


def quantize(x: torch.Tensor, cfg: LogQuantConfig) -> torch.Tensor:
    """Normalized input (|x| <= 1) -> signed integer codes in [-L, L]."""
    lv = cfg.levels
    q = log_compress(x.float(), cfg.alpha)
    codes = torch.round(q * lv)  # half to even, like jnp.round
    return torch.clamp(codes, -lv, lv).to(code_dtype(cfg.bits))


def dequantize(codes: torch.Tensor, cfg: LogQuantConfig) -> torch.Tensor:
    """Signed integer codes -> normalized float values (|x| <= 1)."""
    return log_expand(f32_div(codes.float(), cfg.levels), cfg.alpha)
