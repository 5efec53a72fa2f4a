"""SGD and Adam over a tree of parameters, updated in place.

The paper's Algorithm 1 steps plain SGD on the reconstructed gradient; the
JAX package's ``sgd`` adds momentum and weight decay, and its ``adam``
serves the LM runs. The compressor always runs before the optimizer (it
replaces the all-reduce). Unlike the JAX functional update, the port writes
each parameter in place (no second copy of the model), in the same f32
arithmetic: ``w - lr * g`` with the product rounded first, cast back to the
parameter's dtype. The optimizer state (momentum, moments, Adam's step
count) is updated in place too and returned as the same tensors, so a
CUDA graph of the step replays on fixed addresses.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import Any

import torch

from repro_torch.core.tree import Tree, tree_leaves, tree_map

__all__ = ["Optimizer", "sgd", "adam", "make_optimizer"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Any]
    # update(grads, opt_state, params) -> new opt_state; params change in place
    update: Callable[[Tree, Any, Tree], Any]


def sgd(lr: float, momentum: float = 0.0, weight_decay: float = 0.0) -> Optimizer:
    def init(params: Tree) -> Any:
        if momentum == 0.0:
            return {}
        return {
            "mu": tree_map(lambda w: torch.zeros_like(w, dtype=torch.float32), params)
        }

    @torch.no_grad()
    def update(grads: Tree, state: Any, params: Tree) -> Any:
        ws, gs = tree_leaves(params), tree_leaves(grads)
        if weight_decay:
            gs = [g.float() + weight_decay * w.float() for g, w in zip(gs, ws)]
        if momentum == 0.0:
            for w, g in zip(ws, gs):
                w.copy_(w.float() - lr * g.float())
            return state
        for w, m, g in zip(ws, tree_leaves(state["mu"]), gs):
            m.mul_(momentum).add_(g.float())  # momentum * m + g, rounded as so
            w.copy_(w.float() - lr * m)
        return state

    return Optimizer(init, update)


def adam(
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    """The JAX package's Adam: moments m, v in f32 (updated in place, like
    the parameters: at 1B parameters a second copy is 8 GB), the step count
    ``t`` an int32 tensor on the parameters' device, and the bias
    corrections ``1 - b ** t`` computed in f32 from it, as JAX computes
    them (not as Python floats, which would round once, in f64). ``t``
    advances in place."""

    def init(params: Tree) -> Any:
        leaves = tree_leaves(params)

        def zeros(w: torch.Tensor) -> torch.Tensor:
            return torch.zeros_like(w, dtype=torch.float32)

        return {
            "m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
            "t": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
        }

    @torch.no_grad()
    def update(grads: Tree, state: Any, params: Tree) -> Any:
        t = state["t"].add_(1)
        tf = t.float()
        bc1 = 1 - torch.pow(b1, tf)
        bc2 = 1 - torch.pow(b2, tf)
        for w, g, m, v in zip(
            tree_leaves(params),
            tree_leaves(grads),
            tree_leaves(state["m"]),
            tree_leaves(state["v"]),
        ):
            g = g.float()
            # in place, each product rounded as in b1 * m + (1 - b1) * g
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                upd = upd + weight_decay * w.float()
            w.copy_(w.float() - lr * upd)
        return {"m": state["m"], "v": state["v"], "t": t}

    return Optimizer(init, update)


def make_optimizer(name: str, lr: float, **kw: Any) -> Optimizer:
    if name == "sgd":
        return sgd(lr, **kw)
    if name == "adam":
        return adam(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
