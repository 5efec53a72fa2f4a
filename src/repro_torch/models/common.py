"""Shared building blocks: device choice, norms, activations, initializers."""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

__all__ = [
    "resolve_device",
    "rms_norm",
    "gated_rms_norm",
    "act_fn",
    "dense_init",
    "embed_init",
    "DTYPES",
]

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_device(device: torch.device | str = "cuda") -> torch.device:
    """The device to run on; asking for CUDA where there is none raises
    (the port never carries on on the CPU in place of the card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    return dev


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + w), in f32, cast back to x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.float())).to(x.dtype)


def gated_rms_norm(
    x: torch.Tensor, gate: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Mamba-2's norm before out_proj: rms_norm(x * silu(gate)), the gate's
    silu in f32 and cast to x's dtype before the product."""
    return rms_norm(x * F.silu(gate.float()).to(x.dtype), weight, eps)


def act_fn(name: str):
    """``jax.nn.gelu`` defaults to the tanh approximation, so 'gelu' is
    ``F.gelu(approximate="tanh")`` here, not torch's exact default."""
    return {
        "silu": F.silu,
        "gelu": functools.partial(F.gelu, approximate="tanh"),
        "relu": F.relu,
    }[name]


def dense_init(
    gen: torch.Generator,
    shape: tuple[int, ...],
    in_dim: int | None = None,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Scaled-normal init, 1/sqrt(fan_in), in f32."""
    fan_in = in_dim if in_dim is not None else shape[0]
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return w / math.sqrt(fan_in)


def embed_init(
    gen: torch.Generator, shape: tuple[int, ...], device: torch.device | str = "cpu"
) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return w * 0.02
