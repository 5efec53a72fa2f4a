"""SGD over a tree of parameters, updated in place.

The paper's Algorithm 1 steps plain SGD on the reconstructed gradient; the
JAX package's ``sgd`` adds momentum and weight decay. The compressor always
runs before the optimizer (it replaces the all-reduce). Unlike the JAX
functional update, the port writes each parameter in place (no second copy
of the model), in the same f32 arithmetic: ``w - lr * g`` with the product
rounded first.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import Any

import torch

from repro_torch.core.tree import Tree, tree_leaves, tree_map, tree_unflatten

__all__ = ["Optimizer", "sgd"]


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
        mus = [momentum * m + g.float() for m, g in zip(tree_leaves(state["mu"]), gs)]
        for w, m in zip(ws, mus):
            w.copy_(w.float() - lr * m)
        return {"mu": tree_unflatten(state["mu"], mus)}

    return Optimizer(init, update)
