"""The data-parallel LM training step: loss -> grad -> COMPRESSED sync ->
optimizer, the JAX package's ``train/step.py`` over N simulated workers.

The JAX step runs under ``shard_map`` with the data-parallel mesh axes
manual, so the compressor's quantized collectives are the only cross-worker
traffic (the paper's Algorithm 1). One card holds all N workers here: the
mesh's data axis becomes the leading worker dim of every per-worker tensor
over ``SimComm(N)``, the reference's vmap semantics. Worker w takes its own
contiguous rows of the global batch, as ``P("data")`` shards them, and its
gradient of its own mean loss; the compressor syncs the (N, ...) gradients
and keeps per-worker state (error feedback E, warm-start Q) with that
leading dim; the optimizer steps the shared parameters in place.

The parameters are the training tree, the JAX package's layout (scan
leaves stacked by repeat, ``models.model.stacked_flags``), so the
compressor's plans, per-layer scales, bits and collective counts are the
JAX package's. A mesh is ``(data, model)``; a model axis above 1 (tensor
parallelism) is not ported (ROADMAP Queue 1, item 15).
"""

from __future__ import annotations

import functools
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.comm import CommRecord, SimComm
from repro_torch.core.compressors import (
    CompressorConfig,
    GradCompressor,
    make_compressor,
)
from repro_torch.core.tree import Tree, tree_leaves, tree_map, tree_unflatten
from repro_torch.models.common import resolve_device
from repro_torch.models.model import init_params, stacked_flags
from repro_torch.train.data_parallel import _clock
from repro_torch.train.loss import lm_loss
from repro_torch.train.optimizer import Optimizer
from repro_torch.weights import to_jax_layout

__all__ = [
    "build_train_step",
    "init_train_state",
    "init_train_params",
    "make_model_compressor",
    "abstract_grads_of",
    "n_dp_of",
]

Mesh = tuple[int, int]  # (data, model)
# called as on_sync(per-worker grads, synced grads, new compressor state, record)
OnSync = Callable[[Tree, Tree, Any, CommRecord], None]


def n_dp_of(mesh: Mesh) -> int:
    """The data-parallel workers of a (data, model) mesh."""
    data, model = mesh
    if model != 1:
        raise NotImplementedError(
            f"a model axis of {model}: tensor parallelism is not ported yet "
            "(ROADMAP Queue 1, item 15)"
        )
    if data < 1:
        raise ValueError(f"a data axis of {data}")
    return data


def abstract_grads_of(cfg: ModelConfig) -> tuple[Tree, Tree]:
    """(the gradient tree on the ``meta`` device, its stacked flags): what
    the compressor and the policy planner consume, with no allocation."""
    abstract = to_jax_layout(init_params(cfg, device="meta"), cfg)
    return abstract, stacked_flags(abstract)


def make_model_compressor(
    cfg: ModelConfig, comp_cfg: CompressorConfig
) -> GradCompressor:
    """The compressor bound to this model's gradient tree (abstract)."""
    abstract, flags = abstract_grads_of(cfg)
    return make_compressor(comp_cfg, abstract, flags)


def init_train_params(
    cfg: ModelConfig, seed: int = 0, device: torch.device | str = "cuda"
) -> Tree:
    """The seeded init of ``models.model.init_params`` in the training tree,
    every leaf requiring grad."""
    params = to_jax_layout(init_params(cfg, seed, device), cfg)
    return tree_map(lambda w: w.requires_grad_(True), params)


def init_train_state(
    cfg: ModelConfig,
    seed: int,
    optimizer: Optimizer,
    compressor: GradCompressor,
    n_dp: int,
    device: torch.device | str = "cuda",
) -> dict[str, Any]:
    """{params, opt, comp (per-worker, leading dim ``n_dp``), step (int32)}."""
    dev = resolve_device(device)
    params = init_train_params(cfg, seed, dev)
    return dict(
        params=params,
        opt=optimizer.init(params),
        comp=compressor.init_state(seed, n_dp, dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _to_device(batch: dict[str, Any], device: torch.device) -> dict[str, Any]:
    """numpy arrays are copied to ``device``; tensors (the async runtime's
    pinned ones) go without blocking the host."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        out[k] = v.to(device, non_blocking=True)
    return out


def _f32(value: Any, device: torch.device) -> torch.Tensor:
    """A 0-dim f32 metric on ``device``: a device value cast, a host number
    filled in (no host-to-device copy)."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32)
    return torch.full((), float(value), dtype=torch.float32, device=device)


def build_train_step(
    cfg: ModelConfig,
    mesh: Mesh,
    compressor: GradCompressor,
    optimizer: Optimizer,
    *,
    accum_steps: int = 1,
    head_chunk: int = 0,
    loss_fn: Callable | None = None,
    comm: SimComm | None = None,
    on_sync: OnSync | None = None,
    split_times: bool = False,
) -> Callable[[dict[str, Any], dict[str, Any]], tuple[dict[str, Any], dict]]:
    """Returns ``step_fn(state, batch) -> (state, metrics)``.

    ``batch`` is {"tokens": (B, S)}, numpy or a tensor, B divisible by the
    mesh's data axis. The parameters and optimizer moments are updated in
    place; the returned state holds them, the new compressor state and
    ``step + 1``. ``metrics`` are 0-dim f32 tensors on the device, so a
    caller reads them when it chooses: ``ce`` and ``loss`` (the mean over
    workers), the sync's effective ``wire_mb_per_step`` and
    ``collectives_per_step``, and ``down_mb_per_step``.

    ``accum_steps=k`` splits each worker's rows into k sequential
    microbatches, sums their gradients in f32 and divides by k, then syncs
    once: error feedback and wire bits per step are unchanged; ``k=1`` is
    the single pass. ``comm`` (a ``SimComm`` of the mesh's workers, e.g.
    with ``record=True``) carries the sync; ``on_sync`` sees each step's
    gradients going in and out of it; ``split_times`` ends each phase in a
    device sync and adds host ``grad_ms``, ``sync_ms``, ``update_ms``."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    n = n_dp_of(mesh)
    comm = comm if comm is not None else SimComm(n)
    if comm.size() != n:
        raise ValueError(f"a comm of {comm.size()} workers for a mesh of {n}")
    loss_fn = loss_fn or functools.partial(lm_loss, cfg=cfg, head_chunk=head_chunk)

    def grad_of(params: Tree, leaves: list, rows: dict) -> tuple[list, dict]:
        loss, metrics = loss_fn(params, rows)
        grads = torch.autograd.grad(loss, leaves)
        return list(grads), {k: v.detach() for k, v in metrics.items()}

    def worker_grad(params: Tree, leaves: list, rows: dict) -> tuple[list, dict]:
        if accum_steps == 1:
            return grad_of(params, leaves, rows)
        b = next(iter(rows.values())).shape[0]
        if b % accum_steps:
            raise ValueError(
                f"per-worker batch {b} not divisible by accum_steps={accum_steps}"
            )
        acc = [torch.zeros_like(w, dtype=torch.float32) for w in leaves]
        ms = []
        for mb in range(accum_steps):
            sl = slice(mb * b // accum_steps, (mb + 1) * b // accum_steps)
            gs, m = grad_of(params, leaves, {k: v[sl] for k, v in rows.items()})
            for a, g in zip(acc, gs):
                a.add_(g.float())
            ms.append(m)
        grads = [(a / accum_steps).to(w.dtype) for a, w in zip(acc, leaves)]
        # equal microbatches: the mean of their mean losses is the batch's
        return grads, {k: torch.stack([m[k] for m in ms]).mean(0) for k in ms[0]}

    def step_fn(state: dict[str, Any], batch: dict[str, Any]):
        params = state["params"]
        leaves = tree_leaves(params)
        for w in leaves:
            w.requires_grad_(True)
        dev = leaves[0].device
        t0 = _clock(dev) if split_times else 0.0
        batch = _to_device(batch, dev)
        b = next(iter(batch.values())).shape[0]
        if b % n:
            raise ValueError(f"global batch {b} not divisible by {n} workers")
        per = {k: v.reshape((n, b // n) + v.shape[1:]) for k, v in batch.items()}
        grads = [torch.empty((n,) + w.shape, dtype=w.dtype, device=dev) for w in leaves]
        worker_metrics = []
        for wk in range(n):
            gs, m = worker_grad(params, leaves, {k: v[wk] for k, v in per.items()})
            for buf, g in zip(grads, gs):
                buf[wk].copy_(g)
            del gs
            worker_metrics.append(m)
        grads = tree_unflatten(params, grads)
        t1 = _clock(dev) if split_times else 0.0
        with torch.no_grad():
            synced, comp, rec = compressor.sync(grads, state["comp"], comm)
        if on_sync is not None:
            on_sync(grads, synced, comp, rec)
        del grads
        t2 = _clock(dev) if split_times else 0.0
        opt = optimizer.update(synced, state["opt"], params)
        t3 = _clock(dev) if split_times else 0.0
        with torch.no_grad():
            metrics = {
                k: comm.pmean(torch.stack([m[k] for m in worker_metrics]))
                for k in worker_metrics[0]
            }
            metrics["wire_mb_per_step"] = _f32(rec.effective_bits() / 8e6, dev)
            metrics["collectives_per_step"] = _f32(rec.effective_collectives(), dev)
            metrics["down_mb_per_step"] = _f32(rec.down_bits / 8e6, dev)
        if split_times:
            metrics["grad_ms"] = (t1 - t0) * 1e3
            metrics["sync_ms"] = (t2 - t1) * 1e3
            metrics["update_ms"] = (t3 - t2) * 1e3
        new_state = dict(params=params, opt=opt, comp=comp, step=state["step"] + 1)
        return new_state, metrics

    return step_fn
