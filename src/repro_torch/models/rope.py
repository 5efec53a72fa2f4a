"""Rotary position embeddings.

Despite the JAX module's docstring ("interleaved-pair"), its ``apply_rope``
rotates the two HALVES of the head dim (x[:D/2], x[D/2:]); the port does the
same. Angles are computed in f32.
"""

from __future__ import annotations

import torch

__all__ = ["rope_freqs", "apply_rope"]


def rope_freqs(
    positions: torch.Tensor, dim: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos, sin of shape (..., dim//2), f32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    inv = 1.0 / (theta**exps)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D) with cos/sin (..., S, D//2) broadcast over heads."""
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)
