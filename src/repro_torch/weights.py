"""Carry the JAX package's parameters into the port.

``params_from_jax(tree, cfg)`` takes the JAX param pytree as numpy arrays
(``jax.tree.map(np.asarray, params)``: nested dicts and lists) and returns
the port's model state. The JAX ``scan`` leaves carry a leading ``repeats``
dim; they are unstacked in the order the JAX forward runs them (lead layers,
then for each repeat r every pattern position, then tail layers). Weights
keep their (d_in, d_out) layout, because the port applies them as ``x @ w``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import resolve_device

__all__ = ["params_from_jax", "tensor_from_numpy"]


def tensor_from_numpy(a: np.ndarray, device: torch.device | str) -> torch.Tensor:
    """numpy -> torch, including ml_dtypes' bfloat16 (bit-reinterpreted)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(
    tree: dict[str, Any], cfg: ModelConfig, device: torch.device | str = "cuda"
) -> dict[str, Any]:
    dev = resolve_device(device)

    def conv(t: Any, r: int | None = None) -> Any:
        if isinstance(t, dict):
            return {k: conv(v, r) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v, r) for v in t]
        return tensor_from_numpy(t if r is None else np.asarray(t)[r], dev)

    if cfg.n_codebooks or cfg.mtp or not cfg.tie_embeddings:
        raise NotImplementedError(
            f"{cfg.name}: untied, multi-codebook or MTP heads are not ported yet"
        )
    layers = [conv(p) for p in tree["lead"]]
    for r in range(cfg.repeats):
        layers += [conv(tree["scan"][pos], r) for pos in range(len(cfg.pattern))]
    layers += [conv(p) for p in tree["tail"]]
    return {
        "embed": conv(tree["embed"]),
        "layers": layers,
        "final_norm": conv(tree["final_norm"]),
    }
