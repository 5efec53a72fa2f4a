"""Dense gated MLP (SwiGLU / GeGLU). Weights keep the JAX layout
(d_in, d_out) and are applied as ``x @ w``. Tensor-parallel, a rank holds
the ``gate`` / ``up`` columns and ``down`` rows its specs give it; a
``down`` split by rows ends in the model-axis all-reduce of its f32
partials (``core.comm.ModelComm.row_parallel``), and the input enters
through ``core.comm.copy_to_model``, whose backward sums the ranks' parts of its
gradient."""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.comm import copy_to_model
from repro_torch.models.common import act_fn, dense_init

__all__ = ["init_mlp", "mlp_forward"]

Params = dict[str, Any]


def init_mlp(gen: torch.Generator, d_in: int, d_ff: int, device) -> Params:
    return {
        "gate": dense_init(gen, (d_in, d_ff), device=device),
        "up": dense_init(gen, (d_in, d_ff), device=device),
        "down": dense_init(gen, (d_ff, d_in), device=device),
    }


def mlp_forward(
    p: Params,
    x: torch.Tensor,
    act: str = "silu",
    *,
    tp: Any = None,
    pspec: Params | None = None,
) -> torch.Tensor:
    split = pspec is not None and pspec["down"][0] is not None
    if split:
        x = copy_to_model(x, tp.comm, "tp.mlp.in")
    g = act_fn(act)(x @ p["gate"].to(x.dtype))
    u = x @ p["up"].to(x.dtype)
    if split:
        return tp.comm.row_parallel(g * u, p["down"].to(x.dtype), "tp.mlp.down")
    return (g * u) @ p["down"].to(x.dtype)
