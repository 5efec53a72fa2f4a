"""Carry the JAX package's parameters and compressor state into the port.

Each function takes a JAX pytree as numpy arrays (``jax.tree.map(np.asarray,
tree)``: nested dicts and lists) and returns tensors on the port's device.

``params_from_jax(tree, cfg)`` returns the LM's model state (an untied
``head``, the MoE and MLA leaves, the (cb, V, d) codebook embedding and
(cb, d, V) head, and the unstacked ``mtp`` subtree included). The JAX
``scan`` leaves carry a leading ``repeats`` dim; they are unstacked in the
order the JAX forward runs them (lead layers, then for each repeat r every
pattern position, then tail layers). Weights keep their (d_in, d_out)
layout, because the port applies them as ``x @ w``.

``to_jax_layout(params, cfg)`` is its inverse: the serving tree -> the
training tree, the JAX package's own layout (``lead``/``scan``/``tail``,
scan leaves stacked by repeat, as copies), which the compressor sees;
``models.model.layer_params`` reads it back as per-layer views.
``train_state_from_jax(state)`` carries a whole JAX training state
(params, optimizer, per-worker compressor state, step) over as it is.

``shard_params(params, specs, mesh)`` cuts a rank's shard of each leaf
along the dims its spec names (``launch/sharding.py``), and
``init_sharded_params`` does so leaf by leaf as the seeded init draws
them, so a rank never holds the whole model: the serving tree, or the
training tree (stacked leaves, the JAX layout) given its specs.
``train_state_from_jax`` and ``compressor_state_from_jax`` take the specs
of the state too and cut each JAX array to the rank's block as it is
carried over.

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
from repro_torch.launch.sharding import cut
from repro_torch.models.common import resolve_device
from repro_torch.models.model import init_params

__all__ = [
    "params_from_jax",
    "to_jax_layout",
    "train_state_from_jax",
    "resnet_params_from_jax",
    "compressor_state_from_jax",
    "tensor_from_numpy",
    "shard_params",
    "init_sharded_params",
]

# top-level subtrees besides the embedding, the layers and the final norm:
# carried as they are, both ways
_UNSTACKED = ("head", "mtp")


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

    layers = [conv(p) for p in tree["lead"]]
    for r in range(cfg.repeats):
        layers += [conv(tree["scan"][pos], r) for pos in range(len(cfg.pattern))]
    layers += [conv(p) for p in tree["tail"]]
    out = {
        "embed": conv(tree["embed"]),
        "layers": layers,
        "final_norm": conv(tree["final_norm"]),
    }
    for key in _UNSTACKED:
        if key in tree:
            out[key] = conv(tree[key])
    return out


def to_jax_layout(params: dict[str, Any], cfg: ModelConfig) -> dict[str, Any]:
    """The serving tree ``{"embed", "layers", "final_norm"}`` -> the
    training tree ``{"embed", "lead", "scan", "tail", "final_norm"}``: the
    lead and tail layers as they are, each pattern position's repeats
    stacked (copies), in the order :func:`params_from_jax` unstacks them."""
    layers = params["layers"]
    n_lead, n_pat = len(cfg.lead), len(cfg.pattern)
    if len(layers) != n_lead + n_pat * cfg.repeats + len(cfg.tail):
        raise ValueError(f"{len(layers)} layers do not fit {cfg.name}'s stack")
    scan = []
    for pos in range(n_pat):
        reps = [layers[n_lead + r * n_pat + pos] for r in range(cfg.repeats)]
        scan.append(_stack(reps))
    out = {
        "embed": params["embed"],
        "lead": layers[:n_lead],
        "scan": scan,
        "tail": layers[n_lead + n_pat * cfg.repeats :],
        "final_norm": params["final_norm"],
    }
    for key in _UNSTACKED:
        if key in params:
            out[key] = params[key]
    return out


def shard_params(params: Any, specs: Any, mesh: Any) -> Any:
    """This rank's shard of every leaf of ``params`` (a dict / list tree:
    the serving tree, or any subtree of it with the matching subtree of
    ``specs``), cut along the dims its spec names over ``mesh`` (a
    ``launch.mesh.DataMesh``: its ``sizes`` and this rank's ``coords``).
    A cut leaf is a copy, so the whole one can be freed; a replicated leaf
    is kept as it is."""
    if isinstance(params, dict):
        return {k: shard_params(v, specs[k], mesh) for k, v in params.items()}
    if isinstance(params, list):
        return [shard_params(v, s, mesh) for v, s in zip(params, specs, strict=True)]
    if all(e is None for e in specs):
        return params
    return cut(params, specs, mesh.sizes, mesh.coords).clone()


def init_sharded_params(
    cfg: ModelConfig, seed: int, device: torch.device | str, specs: Any, mesh: Any
) -> dict[str, Any]:
    """``models.model.init_params(cfg, seed, device)`` cut to this rank's
    shards as it goes: each part (the embedding, a layer, the head) is
    drawn whole, cast and cut before the next is drawn, so the draws, and
    so the shards, are those of the one-process init. ``specs`` of the
    training tree (``lead`` / ``scan`` / ``tail``) give the training tree:
    each layer cut by its stacked leaf's spec without the stacked dim, the
    scan layers' shards then stacked (``to_jax_layout``)."""
    if "scan" in specs:
        layers = _layer_specs_of_train(specs, cfg)

        def shard(path: tuple, tree: Any) -> Any:
            if path[0] == "layers":
                return shard_params(tree, layers[path[1]], mesh)
            return shard_params(tree, specs[path[0]], mesh)

        return to_jax_layout(init_params(cfg, seed, device, shard=shard), cfg)

    def shard(path: tuple, tree: Any) -> Any:
        sub = specs
        for k in path:
            sub = sub[k]
        return shard_params(tree, sub, mesh)

    return init_params(cfg, seed, device, shard=shard)


def _unstack(spec: Any) -> Any:
    if isinstance(spec, dict):
        return {k: _unstack(v) for k, v in spec.items()}
    return type(spec)(*tuple(spec)[1:])


def _layer_specs_of_train(specs: dict[str, Any], cfg: ModelConfig) -> list[Any]:
    """Each layer's specs in execution order from the training tree's:
    lead, then every repeat of the scan positions (unstacked), then tail."""
    scan = [_unstack(s) for s in specs["scan"]]
    return list(specs["lead"]) + scan * cfg.repeats + list(specs["tail"])


def _block(a: Any, spec: Any, mesh: Any, dev: torch.device) -> torch.Tensor:
    """The rank's block of the numpy array ``a`` under ``spec`` on ``dev``:
    only the block is copied (bfloat16 bit-reinterpreted)."""
    a = np.asarray(a)
    bf16 = a.dtype.name == "bfloat16"
    t = torch.from_numpy(np.ascontiguousarray(a.view(np.uint16) if bf16 else a))
    if spec is not None and any(e is not None for e in spec):
        t = cut(t, spec, mesh.sizes, mesh.coords)
    t = t.to(dev, copy=True)
    return t.view(torch.bfloat16) if bf16 else t


def _stack(trees: list[Any]) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def train_state_from_jax(
    state: dict[str, Any],
    device: torch.device | str = "cuda",
    *,
    specs: Any = None,
    mesh: Any = None,
) -> dict[str, Any]:
    """A JAX ``init_train_state`` (numpy leaves) -> the port's training
    state: params in the training tree, the optimizer state, the
    per-worker compressor state (its leading worker dim kept) and the
    int32 step, every leaf as it is, or, given the state's ``specs``
    (``train/step.py:train_state_specs``) and a ``mesh``, cut leaf by leaf
    to this rank's blocks. A PRNG key cannot carry over."""
    if "key" in state["comp"]:
        raise ValueError("a PRNG key cannot carry over; seed the port's state")
    dev = resolve_device(device)
    if specs is None:
        return tree_map(lambda a: tensor_from_numpy(a, dev), state)
    return _cut_tree(state, specs, mesh, dev)


def _cut_tree(tree: Any, specs: Any, mesh: Any, dev: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _cut_tree(v, specs[k], mesh, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cut_tree(v, s, mesh, dev) for v, s in zip(tree, specs, strict=True)]
    return _block(tree, specs, mesh, dev)


def resnet_params_from_jax(
    tree: dict[str, Any], device: torch.device | str = "cuda"
) -> dict[str, Any]:
    """A JAX image-model param tree (numpy leaves) -> the same tree of f32
    tensors, layouts unchanged (HWIO conv kernels)."""
    dev = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, dev).float(), tree)


def compressor_state_from_jax(
    state: dict[str, Any],
    n_workers: int,
    device: torch.device | str = "cuda",
    *,
    specs: Any = None,
    mesh: Any = None,
) -> dict[str, Any]:
    """A JAX compressor state (numpy leaves: E and warm-start Q, without a
    worker dim) -> the port's per-worker state, every leaf copied over a
    leading dim of ``n_workers``; given ``specs`` (the compressor's
    ``state_pspecs``, without the worker dim) and a ``mesh``, each leaf is
    first cut to this rank's block. The randomized compressors' PRNG state
    does not carry over: their streams are the port's own."""
    if "key" in state:
        raise ValueError("a PRNG key cannot carry over; seed the port's state")
    dev = resolve_device(device)

    def per_worker(t):
        return t.expand((n_workers,) + t.shape).clone()

    if specs is None:
        return tree_map(lambda a: per_worker(tensor_from_numpy(a, dev)), state)
    return tree_map(per_worker, _cut_tree(state, specs, mesh, dev))
