"""Carry the JAX package's parameters and compressor state into the port.

Each function takes a JAX pytree as numpy arrays (``jax.tree.map(np.asarray,
tree)``: nested dicts and lists) and returns tensors on the port's device.

``params_from_jax(tree, cfg)`` returns the LM's model state. The JAX
``scan`` leaves carry a leading ``repeats`` dim; they are unstacked in the
order the JAX forward runs them (lead layers, then for each repeat r every
pattern position, then tail layers). Weights keep their (d_in, d_out)
layout, because the port applies them as ``x @ w``.

``resnet_params_from_jax(tree)`` returns the ResNet-18 (or mini-CNN) tree
as it is: the same keys, HWIO conv kernels. ``compressor_state_from_jax``
broadcasts a state from ``comp.init_state(key)`` over the workers, since
the port cannot redraw JAX's warm-start Q.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_map
from repro_torch.models.common import resolve_device

__all__ = [
    "params_from_jax",
    "resnet_params_from_jax",
    "compressor_state_from_jax",
    "tensor_from_numpy",
]


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


def resnet_params_from_jax(
    tree: dict[str, Any], device: torch.device | str = "cuda"
) -> dict[str, Any]:
    """A JAX image-model param tree (numpy leaves) -> the same tree of f32
    tensors, layouts unchanged (HWIO conv kernels)."""
    dev = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, dev).float(), tree)


def compressor_state_from_jax(
    state: dict[str, Any], n_workers: int, device: torch.device | str = "cuda"
) -> dict[str, Any]:
    """A JAX compressor state (numpy leaves: E and warm-start Q, without a
    worker dim) -> the port's per-worker state, every leaf copied over a
    leading dim of ``n_workers``. The randomized compressors' PRNG state
    does not carry over: their streams are the port's own."""
    if "key" in state:
        raise ValueError("a PRNG key cannot carry over; seed the port's state")
    dev = resolve_device(device)

    def per_worker(a):
        t = tensor_from_numpy(a, dev)
        return t.expand((n_workers,) + t.shape).clone()

    return tree_map(per_worker, state)
