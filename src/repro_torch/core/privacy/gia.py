"""Gradient inversion attack (paper §III-C / §V-C; Geiping et al. 2020).

The attacker observes the gradient *as transmitted*: for the compressed
methods that is the lossy reconstruction (P̂Q̂ᵀ after dequantization, the
top-k masked tensor, ...), which is what ``GradCompressor.sync_once``
returns. The attack reconstructs inputs x̂ by minimizing

    1 - cos( ∇_w L(f(x̂; w), y), g_obs )  +  tv_coef · TV(x̂)       (Eq. 4)

with sign-fixed Adam, labels assumed known (the standard strongest-attack
setting).

The loss holds a gradient, so its gradient in x̂ is a double backward:
``torch.func.grad`` over the attack loss, whose ``grad_fn`` is itself a
``torch.func.grad`` of the model's loss in the weights. Independent
restarts run under ``torch.func.vmap``, never folded into the model's
batch: a batch-statistics BatchNorm (ResNet-18's) and a mean loss would
then mix them. ``g_obs`` is a constant of the attack. The initial images
are drawn from explicit ``torch.Generator`` s (``init_scale`` · N(0, 1)),
or passed in by the caller (``x0``), so a test can feed in another
framework's draw. The attack runs in f32 with TF32 off.

The JAX package runs the steps as one jitted ``lax.scan``. Here the step
updates x̂ and the Adam moments in place and counts its steps in a 0-dim
f32 tensor, so on CUDA :func:`invert_gradients_batched` runs step 0
eagerly, captures one step into a CUDA graph and replays it for the rest
(``repro_torch.graphs``); on the CPU every step runs eagerly.

The step's backward runs on the calling thread
(``torch.autograd.set_multithreading_enabled(False)``). By default the
autograd engine runs a CUDA backward on a thread of its own, so the double
backward's graph holds nodes made on two threads, and the engine orders
ready nodes by per-thread sequence numbers: the order of the backward, and
with it which gradients are summed in which order, then depended on how
much autograd each thread had run before. A graph captured under one
order and an eager loop under another gave other x̂ (``chip_smoke.py``
(h2) after other work; ``tools/gia_capture_probe.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from collections.abc import Callable, Sequence
from typing import Any

import torch

from repro_torch import graphs
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.train.data_parallel import _tf32_off

__all__ = [
    "GIAConfig",
    "total_variation",
    "cosine_distance",
    "invert_gradients",
    "invert_gradients_batched",
    "observed_gradient",
    "attack_loss",
    "make_attack_step",
]

# sign-Adam's moments
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class GIAConfig:
    steps: int = 240
    lr: float = 0.1
    tv_coef: float = 1e-2
    init_scale: float = 0.5


def total_variation(x: torch.Tensor) -> torch.Tensor:
    """Anisotropic TV over (B, H, W, C) images."""
    dh = (x[:, 1:, :, :] - x[:, :-1, :, :]).abs().mean()
    dw = (x[:, :, 1:, :] - x[:, :, :-1, :]).abs().mean()
    return dh + dw


def _flat(tree: Any) -> torch.Tensor:
    # f32 at least (the JAX package casts to f32; f64 stays f64 here, so the
    # attack can be checked in f64)
    return torch.cat(
        [
            leaf.reshape(-1).to(torch.promote_types(leaf.dtype, torch.float32))
            for leaf in tree_leaves(tree)
        ]
    )


def cosine_distance(g1: Any, g2: Any) -> torch.Tensor:
    a, b = _flat(g1), _flat(g2)
    denom = torch.linalg.norm(a) * torch.linalg.norm(b) + 1e-12
    return 1.0 - torch.dot(a, b) / denom


def observed_gradient(
    grad_fn: Callable,
    params: Any,
    x: torch.Tensor,
    y: torch.Tensor,
    compressor=None,
    comp_state=None,
) -> tuple[Any, Any]:
    """The (gradient, next compressor state) an eavesdropper sees at ONE
    training step: the raw gradient for SGD, or the compressor's lossy
    reconstruction from syncing with the CURRENT threaded state.

    Callers MUST thread the returned state into the next step: a fresh
    state every step only ever measures *cold-start* leakage (zero error
    feedback, random warm-start Q), while the paper's Fig. 5 claim is about
    training-time traffic (*steady-state* leakage).
    :mod:`repro_torch.core.privacy.harness` does the threading."""
    g = grad_fn(params, x, y)
    if compressor is None:
        return g, comp_state
    out, new_state, _ = compressor.sync_once(g, comp_state)
    return out, new_state


def attack_loss(
    grad_fn: Callable,
    params: Any,
    g_obs: Any,
    y: torch.Tensor,
    tv_coef: float,
    x: torch.Tensor,
) -> torch.Tensor:
    """Eq. 4 at the images ``x``: the cosine distance of their gradient in
    the weights to ``g_obs``, plus ``tv_coef`` times their TV."""
    g = grad_fn(params, x, y)
    return cosine_distance(g, g_obs) + tv_coef * total_variation(x)


def make_attack_step(
    grad_fn: Callable, params: Any, g_obs: Any, y: torch.Tensor, cfg: GIAConfig
) -> Callable:
    """One sign-Adam step of the attack over stacked restarts:
    ``step(x, m, v, t) -> losses`` updates x, m, v of (S, *x_shape) in
    place and returns the losses (S,) at x before the step. ``t``, a 0-dim
    f32 tensor on their device, counts the steps from 0 and is advanced in
    place; the bias corrections take it in f32, as the JAX package's scan
    over an f32 ``arange`` does."""
    g_obs = tree_map(lambda t: t.detach(), g_obs)
    loss = functools.partial(attack_loss, grad_fn, params, g_obs, y, cfg.tv_coef)
    grad_and_loss = torch.func.vmap(torch.func.grad_and_value(loss))

    def step(x, m, v, t):
        # one thread's sequence numbers order the whole double backward
        with torch.autograd.set_multithreading_enabled(False):
            g, losses = grad_and_loss(x)
        # the sign trick (Geiping et al.) stabilizes cosine-loss inversion
        g = torch.sign(g)
        m.copy_(_B1 * m + (1 - _B1) * g)
        v.copy_(_B2 * v + (1 - _B2) * g * g)
        mh = m / (1 - _B1 ** (t + 1))
        vh = v / (1 - _B2 ** (t + 1))
        x.copy_(x - cfg.lr * mh / (torch.sqrt(vh) + _EPS))
        t.add_(1)
        return losses

    return step


@_tf32_off()
def invert_gradients_batched(
    grad_fn: Callable,
    params: Any,
    g_obs: Any,
    x_shape: tuple[int, ...],
    y: torch.Tensor,
    keys: Sequence[torch.Generator] | None = None,
    cfg: GIAConfig = GIAConfig(),
    *,
    x0: torch.Tensor | None = None,
    graph: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Independent restarts of the attack, one per generator of ``keys``
    (x̂₀ = ``init_scale`` · N(0, 1) from each), or from the initial images
    ``x0`` (S, *x_shape). Returns ``(x_hats, losses)`` of shapes
    ``(S, *x_shape)`` and ``(S,)``, the losses at the last step. On CUDA the
    steps after the first are replays of one captured step, unless
    ``graph=False``; ``graph=True`` on the CPU raises. A graph is captured
    for each call."""
    if (keys is None) == (x0 is None):
        raise ValueError("give exactly one of keys (generators) and x0")
    if x0 is None:
        x0 = torch.stack(
            [
                cfg.init_scale * torch.randn(x_shape, generator=k, device=k.device)
                for k in keys
            ]
        )
    if tuple(x0.shape[1:]) != tuple(x_shape):
        raise ValueError(f"x0 {tuple(x0.shape)} is not (S, *{tuple(x_shape)})")
    step = make_attack_step(grad_fn, params, g_obs, y, cfg)
    x = x0.float().clone()
    m, v = torch.zeros_like(x), torch.zeros_like(x)
    t = torch.zeros((), device=x.device)
    losses = torch.full((x.shape[0],), float("nan"), device=x.device)

    def one_step():
        losses.copy_(step(x, m, v, t))

    if graphs.use_graph(graph, x.device):
        graphs.StepGraph(one_step, x.device).run(cfg.steps)
    else:
        for _ in range(cfg.steps):
            one_step()
    return x, losses


def invert_gradients(
    grad_fn: Callable,
    params: Any,
    g_obs: Any,
    x_shape: tuple[int, ...],
    y: torch.Tensor,
    key: torch.Generator | None = None,
    cfg: GIAConfig = GIAConfig(),
    *,
    x0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One attack from ``key``'s draw or from ``x0`` (``x_shape``). Returns
    ``(x_hat, final attack loss)``."""
    keys = None if key is None else [key]
    x0 = None if x0 is None else x0[None]
    x, losses = invert_gradients_batched(
        grad_fn, params, g_obs, x_shape, y, keys, cfg, x0=x0
    )
    return x[0], losses[0]
