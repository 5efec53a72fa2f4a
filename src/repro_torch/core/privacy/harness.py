"""Trajectory trustworthiness harness: cold-start vs steady-state GIA.

The paper's Fig. 5 claim is about *training-time* wire traffic, so the
attack observes the gradient a victim actually transmits at step t of
training, produced by a compressor whose error feedback and warm-start Q
have evolved for t steps. This module:

  * trains a victim for ``train_steps`` plain-SGD steps on its private
    batch, threading the REAL compressor state through every sync
    (:func:`~repro_torch.core.privacy.gia.observed_gradient`;
    ``GradCompressor.sync_once`` runs the one worker);
  * snapshots ``(params, g_obs)`` at each ``attack_steps`` entry (step 0 is
    the cold start, later steps the steady state);
  * runs the batched attack from each snapshot (independent restarts under
    ``torch.func.vmap``) and scores the best restart by SSIM and PSNR.
    "Best" is chosen by SSIM against the private target, an ORACLE the real
    attacker does not have, so the scores are worst-case leakage bounds;
  * :func:`sweep_methods` repeats that over a methods x config sweep.

The victim computes the gradients of the SAME private batch every step
(the federated GIA setting: the attacker targets one participant's data),
which is the regime where error feedback re-accumulates what compression
dropped. Victim steps and attacks run in f32 with TF32 off.
"""

from __future__ import annotations

import dataclasses
import time
from collections.abc import Callable, Mapping
from typing import Any

import torch

from repro_torch.core.compressors import leaf_generator
from repro_torch.core.privacy.accounting import gaussian_epsilon
from repro_torch.core.privacy.gia import (
    GIAConfig,
    invert_gradients_batched,
    observed_gradient,
)
from repro_torch.core.privacy.ssim import psnr, ssim
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.train.data_parallel import _tf32_off

__all__ = [
    "HarnessConfig",
    "AttackPoint",
    "PostHocNoiseCompressor",
    "run_attack_harness",
    "sweep_methods",
]

# leaf_generator streams: the post-hoc noise's, and the attack restarts'
# (the restart's index in the place of the leaf's)
_NOISE_STREAM, _RESTART_STREAM = 1, 2


class PostHocNoiseCompressor:
    """The strawman the randomized codecs must beat: run a DETERMINISTIC
    compressor, then add Gaussian noise to the decoded output.

    ``sigma_norm`` is the std in the normalized [-1, 1] domain, scaled per
    leaf by max |g| after decoding. Each leaf's noise at each step comes
    from its own generator, seeded by (seed, step, leaf) as
    :func:`~repro_torch.core.compressors.leaf_generator` seeds them, on a
    stream of its own. Duck-types the surface the harness drives
    (``init_state`` / ``sync_once`` / ``privacy_epsilon_per_step``); not a
    wire method: the noise is local and ships no extra bits.
    """

    def __init__(self, inner, sigma_norm: float):
        if sigma_norm <= 0:
            raise ValueError(f"sigma_norm must be > 0, got {sigma_norm}")
        self.inner = inner
        self.sigma_norm = float(sigma_norm)

    def init_state(self, seed: int, n_workers: int = 1, device="cuda") -> dict:
        return {
            "inner": self.inner.init_state(seed, n_workers, device),
            "noise_key": int(seed),
            "noise_step": 0,
        }

    def sync_once(self, grads, state, *, comm=None):
        out, inner2, rec = self.inner.sync_once(grads, state["inner"], comm=comm)
        key, step = state["noise_key"], state["noise_step"]
        noisy = []
        for i, g in enumerate(tree_leaves(out)):
            sigma = self.sigma_norm * g.abs().max()
            gen = leaf_generator(key, step, i, g.device, stream=_NOISE_STREAM)
            noise = torch.randn(g.shape, generator=gen, device=g.device)
            noisy.append((g.float() + sigma * noise).to(g.dtype))
        new_state = {"inner": inner2, "noise_key": key, "noise_step": step + 1}
        return tree_unflatten(out, noisy), new_state, rec

    def privacy_epsilon_per_step(self, delta: float = 1e-5) -> float:
        """Matched-epsilon bookkeeping: each leaf's noise is a Gaussian
        mechanism at ``sigma_norm`` in the normalized domain."""
        n_leaves = len(getattr(self.inner, "plans", [])) or 1
        return n_leaves * gaussian_epsilon(self.sigma_norm, delta)


@dataclasses.dataclass(frozen=True)
class HarnessConfig:
    """Victim training + attack schedule.

    ``attack_steps`` are 0-indexed training steps; the attack observes the
    gradient *transmitted at* that step (the state after t prior syncs), so
    step 0 is the cold-start measurement.
    """

    train_steps: int = 8
    attack_steps: tuple[int, ...] = (0, 7)
    # single-restart inversion is bimodal in its init; leakage is scored as
    # the attacker's best of N restarts (vmapped, so N is cheap)
    n_attack_seeds: int = 4
    # a single-batch victim at lr 0.05 fits its batch within a few steps and
    # the gradient loses information; 0.02 keeps steady-state comparable
    victim_lr: float = 0.02
    seed: int = 7
    gia: GIAConfig = GIAConfig()

    def __post_init__(self):
        bad = [s for s in self.attack_steps if not 0 <= s < self.train_steps]
        if bad:
            raise ValueError(
                f"attack_steps {bad} outside [0, train_steps={self.train_steps})"
            )


@dataclasses.dataclass(frozen=True)
class AttackPoint:
    """One (method, step) attack result; ``x_hat`` is the best restart's
    reconstruction. ``ssim`` / ``psnr`` / ``attack_loss`` all refer to the
    ORACLE-selected (max-SSIM) restart: worst-case leakage, not a pick the
    attacker could make (that would select by ``attack_loss``)."""

    method: str
    step: int
    ssim: float
    psnr: float
    attack_loss: float
    state_threaded: bool  # compressor state evolved through t > 0 syncs
    seed_ssims: tuple[float, ...]
    attack_seconds: float = 0.0  # host time of the batched attack, synced
    # the victim's loss at the END of the run (when the caller passes loss_fn)
    final_loss: float | None = None
    x_hat: torch.Tensor | None = None

    @property
    def phase(self) -> str:
        """The phase label of ``BENCH_privacy.json``'s rows."""
        return "cold_start" if self.step == 0 else "steady_state"


def _restart_keys(seed: int, step: int, n: int, device) -> list[torch.Generator]:
    return [
        leaf_generator(seed, step, s, device, stream=_RESTART_STREAM) for s in range(n)
    ]


@_tf32_off()
def run_attack_harness(
    grad_fn: Callable,
    params: Any,
    x: torch.Tensor,
    y: torch.Tensor,
    compressor=None,
    cfg: HarnessConfig = HarnessConfig(),
    *,
    method: str = "custom",
    loss_fn: Callable | None = None,
) -> list[AttackPoint]:
    """Train the victim for ``cfg.train_steps`` steps (applying the synced
    gradient, threading the compressor state from ``init_state(cfg.seed, 1,
    device)``) and attack each snapshot. ``loss_fn(params, x, y)``
    (optional) is evaluated once after training and stamped on every point
    as ``final_loss``."""
    comp_state = (
        compressor.init_state(cfg.seed, 1, x.device) if compressor is not None else None
    )
    snaps: dict[int, tuple[Any, Any]] = {}
    for t in range(cfg.train_steps):
        g_obs, comp_state = observed_gradient(
            grad_fn, params, x, y, compressor, comp_state
        )
        if t in cfg.attack_steps:
            snaps[t] = (params, g_obs)
        stepped = [
            p - cfg.victim_lr * g.to(p.dtype)
            for p, g in zip(tree_leaves(params), tree_leaves(g_obs), strict=True)
        ]
        params = tree_unflatten(params, stepped)
    final_loss = float(loss_fn(params, x, y)) if loss_fn is not None else None

    points = []
    for t in sorted(snaps):
        p_t, g_t = snaps[t]
        keys = _restart_keys(cfg.seed, t, cfg.n_attack_seeds, x.device)
        t0 = time.perf_counter()
        x_hats, losses = invert_gradients_batched(
            grad_fn, p_t, g_t, tuple(x.shape), y, keys, cfg.gia
        )
        if x_hats.is_cuda:
            torch.cuda.synchronize(x_hats.device)
        secs = time.perf_counter() - t0
        ssims = [float(ssim(x, x_hats[s])) for s in range(cfg.n_attack_seeds)]
        best = max(range(cfg.n_attack_seeds), key=lambda s: ssims[s])
        points.append(
            AttackPoint(
                method=method,
                step=t,
                ssim=ssims[best],
                psnr=float(psnr(x, x_hats[best])),
                attack_loss=float(losses[best]),
                state_threaded=compressor is not None and t > 0,
                seed_ssims=tuple(ssims),
                attack_seconds=secs,
                final_loss=final_loss,
                x_hat=x_hats[best],
            )
        )
    return points


def sweep_methods(
    methods: Mapping[str, Any],
    grad_fn: Callable,
    params: Any,
    x: torch.Tensor,
    y: torch.Tensor,
    cfg: HarnessConfig = HarnessConfig(),
    *,
    loss_fn: Callable | None = None,
) -> list[AttackPoint]:
    """Run the harness for every ``{name: entry}`` of ``methods``, where an
    entry is a ``CompressorConfig``, ``None`` (uncompressed SGD) or a
    callable ``abstract_grads -> compressor`` (wrappers such as
    :class:`PostHocNoiseCompressor`). Every method starts from the same
    ``params`` and attacks the same schedule, so (method, step) cells are
    comparable."""
    from repro_torch.core.compressors import make_compressor

    # the gradients have the params' shapes
    abstract = tree_map(lambda p: torch.empty(p.shape, device="meta"), params)
    points = []
    for name, entry in methods.items():
        if entry is None:
            comp = None
        elif callable(entry):
            comp = entry(abstract)
        else:
            comp = make_compressor(entry, abstract)
        points.extend(
            run_attack_harness(
                grad_fn, params, x, y, comp, cfg, method=name, loss_fn=loss_fn
            )
        )
    return points
