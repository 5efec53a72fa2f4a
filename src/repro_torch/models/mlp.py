"""Dense gated MLP (SwiGLU / GeGLU). Weights keep the JAX layout
(d_in, d_out) and are applied as ``x @ w``."""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.common import act_fn, dense_init

__all__ = ["init_mlp", "mlp_forward"]

Params = dict[str, Any]


def init_mlp(gen: torch.Generator, d_in: int, d_ff: int, device) -> Params:
    return {
        "gate": dense_init(gen, (d_in, d_ff), device=device),
        "up": dense_init(gen, (d_in, d_ff), device=device),
        "down": dense_init(gen, (d_ff, d_in), device=device),
    }


def mlp_forward(p: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    g = act_fn(act)(x @ p["gate"].to(x.dtype))
    u = x @ p["up"].to(x.dtype)
    return (g * u) @ p["down"].to(x.dtype)
