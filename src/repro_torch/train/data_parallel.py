"""The data-parallel training step of the paper's Algorithm 1, over N
workers: the worker loop of the JAX package's
``benchmarks/convergence.py::train_one``. One process holds all N on one
device (``SimComm``), or each rank of a ``torch.distributed`` process
group holds its share of them (``DistComm``: the rank computes only its
workers' gradients, on their shards of the global batch, and the sync's
collectives cross the ranks).

Each step, every worker takes the gradient of its own loss on its own
shard (a loop over workers, so BatchNorm statistics are per worker, as in
the vmap'd reference); the compressor's ``sync`` replaces the all-reduce;
SGD steps the shared parameters with the synced gradient, which every
worker holds alike. The loss reported is the mean over workers (the
reference's pmean'd loss). Two models: ResNet-18 (the paper's) and the
reference's 4-conv mini-CNN (its CPU-budget stand-in for the figures).

A compressor with a schedule (warm-up, decay) is rebuilt at each of its
boundaries (``at_step``) and its state carried across (``adapt_state``),
with one history and one clock over the phases, as the JAX package's
``train/runtime.py:run_schedule`` does.

On CUDA a step of a uniform compressor is one CUDA-graph replay
(``graphs.StepGraph``), the counterpart of the reference's jitted step:
the images and labels are copied into static device buffers, and the
parameters and the donated compressor state are updated in place.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from collections.abc import Callable, Iterator
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import graphs
from repro_torch.core.comm import CommRecord, DistComm, SimComm
from repro_torch.core.compressors import (
    CompressorConfig,
    GradCompressor,
    make_compressor,
)
from repro_torch.core.tree import Tree, tree_leaves, tree_map, tree_unflatten
from repro_torch.data.synthetic import ImageDataConfig, image_batch
from repro_torch.models.common import resolve_device
from repro_torch.models.resnet import conv_same, init_resnet18, resnet18_forward
from repro_torch.train.optimizer import Optimizer, sgd

__all__ = [
    "MODELS",
    "StepResult",
    "TrainResult",
    "init_mini_cnn",
    "mini_cnn_forward",
    "cross_entropy",
    "worker_grads",
    "train_step",
    "train_one",
    "steps_per_epoch",
    "mb_per_epoch",
]

Forward = Callable[[Tree, torch.Tensor], torch.Tensor]


def init_mini_cnn(n_classes: int = 10, *, seed: int = 0, device="cuda") -> Tree:
    """The reference's 4-conv mini-net (He-normal convs, N(0, 0.05^2) head)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def conv(*s):
        w = torch.randn(s, generator=gen, device=dev)
        return w * math.sqrt(2.0 / (s[0] * s[1] * s[2]))

    return {
        "c1": conv(3, 3, 3, 16),
        "c2": conv(3, 3, 16, 32),
        "c3": conv(3, 3, 32, 64),
        "w": torch.randn((64, n_classes), generator=gen, device=dev) * 0.05,
        "b": torch.zeros(n_classes, device=dev),
    }


def mini_cnn_forward(p: Tree, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) -> logits: three stride-2 SAME convs with ReLU, mean."""
    h = x.permute(0, 3, 1, 2)
    for name in ("c1", "c2", "c3"):
        h = F.relu(conv_same(h, p[name], 2))
    return h.mean(dim=(2, 3)) @ p["w"] + p["b"]


# model name -> (seeded init, forward)
MODELS: dict[str, tuple[Callable[..., Tree], Forward]] = {
    "resnet18": (init_resnet18, resnet18_forward),
    "cnn": (init_mini_cnn, mini_cnn_forward),
}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-mean(log_softmax(logits)[i, labels[i]]), the reference's loss."""
    return -F.log_softmax(logits, dim=-1).gather(1, labels[:, None]).mean()


def worker_grads(
    forward: Forward, params: Tree, images: torch.Tensor, labels: torch.Tensor
) -> tuple[torch.Tensor, Tree]:
    """Each worker's loss and gradient on its own shard: images (N, B, H, W,
    C), labels (N, B) -> losses (N,), grads shaped like ``params`` with a
    leading worker dim."""
    leaves = tree_leaves(params)
    per_leaf: list[list[torch.Tensor]] = [[] for _ in leaves]
    losses = []
    for w in range(images.shape[0]):
        loss = cross_entropy(forward(params, images[w]), labels[w])
        for acc, g in zip(per_leaf, torch.autograd.grad(loss, leaves)):
            acc.append(g)
        losses.append(loss.detach())
    grads = [torch.stack(gs) for gs in per_leaf]
    return torch.stack(losses), tree_unflatten(params, grads)


def _clock(device: torch.device) -> float:
    """Host seconds after the device has finished the work queued so far."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


@dataclasses.dataclass
class StepResult:
    loss: float  # mean over workers
    rec: CommRecord  # the sync's accounting
    # the phases on the host clock, each ending in a device sync (eager
    # steps; NaN for a graph replay, which has no phase boundaries)
    grad_ms: float
    sync_ms: float
    update_ms: float
    # the sync's effective wire bits and collectives (static + gated), read
    # on the host once, after the sync
    wire_bits: float = 0.0
    collectives: float = 0.0
    # the whole step: the sum of the phases, or a replay's CUDA-event time
    step_ms: float = 0.0


def train_step(
    forward: Forward,
    params: Tree,
    opt: Optimizer,
    opt_state: Any,
    comp: GradCompressor,
    comp_state: dict[str, Any],
    comm: SimComm | DistComm,
    images: torch.Tensor,
    labels: torch.Tensor,
) -> tuple[StepResult, Tree, Any, dict[str, Any]]:
    """One step of every worker: grads -> ``comp.sync`` -> SGD in place.
    Returns (result, synced grads, new optimizer state, new compressor
    state). The compressor state is donated, as the reference's jit
    donates its state: the sync writes the new state into the old one's
    memory where it can, so ``comp_state`` must not be used again (the
    values are the functional sync's). The times split the step on the
    host clock, each phase ending in a device sync."""
    dev = images.device
    t0 = _clock(dev)
    losses, grads = worker_grads(forward, params, images, labels)
    t1 = _clock(dev)
    synced, comp_state, rec = comp.sync(grads, comp_state, comm, donate=True)
    t2 = _clock(dev)
    opt_state = opt.update(synced, opt_state, params)
    t3 = _clock(dev)
    res = StepResult(
        loss=float(comm.metric_mean(losses)),
        rec=rec,
        grad_ms=(t1 - t0) * 1e3,
        sync_ms=(t2 - t1) * 1e3,
        update_ms=(t3 - t2) * 1e3,
        wire_bits=float(rec.effective_bits()),
        collectives=float(rec.effective_collectives()),
        step_ms=(t3 - t0) * 1e3,
    )
    return res, synced, opt_state, comp_state


class _GraphedStep:
    """:func:`train_step` as CUDA-graph replays over static image and label
    buffers (``graphs.SyncStepGraph``): the first call runs eagerly (the
    warm-up), the second is captured, the rest replay. After each call
    ``out`` holds the synced gradients (the replay's, valid until the next
    call), the new compressor state and the record."""

    def __init__(self, forward, params, opt, opt_state, comp, comp_state, comm, x, y):
        # the body holds these, not the step (no cycle to outlive it)
        images, labels = torch.empty_like(x), torch.empty_like(y)
        out: dict[str, Any] = {"comp_state": comp_state}

        def body(gens):
            losses, grads = worker_grads(forward, params, images, labels)
            state = {**comp_state, "gen": gens} if gens else comp_state
            synced, new_comp, rec = comp.sync(grads, state, comm, donate=True)
            new_opt = opt.update(synced, opt_state, params)
            out.update(loss=comm.metric_mean(losses), synced=synced, rec=rec)
            return params, new_opt, {k: v for k, v in new_comp.items() if k != "gen"}

        self.images, self.labels, self.out = images, labels, out
        self.sync_graph = graphs.SyncStepGraph(
            body, x.device, comp, (params, opt_state, comp_state), comp_state, comm
        )

    def __call__(self, images: torch.Tensor, labels: torch.Tensor) -> StepResult:
        self.images.copy_(images)
        self.labels.copy_(labels)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state = self.sync_graph.run(self.out["comp_state"])
        end.record()
        # the donated state holds the same tensors; its host numbers advance
        self.out["comp_state"] = state
        rec = self.out["rec"]
        nan = math.nan
        return StepResult(
            loss=float(self.out["loss"]),  # waits for the replay
            rec=rec,
            grad_ms=nan,
            sync_ms=nan,
            update_ms=nan,
            wire_bits=float(rec.effective_bits()),
            collectives=float(rec.effective_collectives()),
            step_ms=start.elapsed_time(end),
        )


@dataclasses.dataclass
class TrainResult:
    losses: list[float]
    acc: float  # on a fresh batch (step 10_000 of the data), final params
    secs_per_step: float
    steps: list[StepResult]
    params: Tree
    comp: GradCompressor
    comp_state: dict[str, Any]
    last_grads: Tree  # the last step's synced gradients
    comm: SimComm | DistComm  # the caller's ``comm=``, or a fresh SimComm


@contextlib.contextmanager
def _tf32_off() -> Iterator[None]:
    """Turn TF32 off for cuDNN's convolutions and cuBLAS's matmuls, through
    the legacy ``allow_tf32`` flags (setting PyTorch's newer
    ``fp32_precision`` as well would make it raise on the mix), and restore
    both on exit."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    was = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = was


@_tf32_off()
def train_one(
    comp_cfg: CompressorConfig,
    *,
    model: str = "resnet18",
    n_workers: int = 4,
    batch: int = 32,
    hw: int = 16,
    n_classes: int = 10,
    steps: int = 60,
    lr: float = 0.05,
    seed: int = 0,
    device="cuda",
    noniid_alpha: float = 0.0,
    comm: SimComm | DistComm | None = None,
    on_step: Callable[[int, StepResult], None] | None = None,
    on_sync: Callable[[int, Tree, dict[str, Any]], None] | None = None,
    graph: bool | None = None,
) -> TrainResult:
    """Train ``model`` for ``steps`` steps over ``n_workers`` simulated
    workers of ``batch`` images each, syncing through ``comp_cfg``'s
    compressor, with plain SGD as the reference steps. The defaults are the
    reference's (4 workers x 32, 16x16). The init and the data come from
    ``seed``, the compressor state from seed 7 (the reference's
    ``PRNGKey(7)``). With ``noniid_alpha > 0`` worker w draws its shard as
    federated client w (Dirichlet label skew). ``on_step(step, result)``
    sees each step as it ends, ``on_sync(step, synced_grads, comp_state)``
    the step's synced gradients and new compressor state; ``comm``, a
    ``SimComm(n_workers)`` of the caller's (with ``record=True`` it keeps
    every step's gathered wire arrays, graphed or eager), is the workers'
    comm. A ``DistComm`` of ``n_workers`` workers in all runs this rank's
    share of them: its workers' shards of each global batch, their
    compressor state (``comp_state`` holds their rows), the sync across the
    ranks; the parameters, losses and accuracy are the same on every rank,
    for every compressor; over gloo the steps run eagerly (``graph=True``
    raises).

    The steps run with TF32 off for convolutions and matmuls, whatever the
    caller set: the reference computes in f32, and PyTorch's default
    ``torch.backends.cudnn.allow_tf32 = True`` would run every f32
    convolution on the card through cuDNN in TF32, which keeps about three
    decimal digits. The two flags are put back as the caller had them when
    this returns or raises.

    ``graph`` follows ``graphs.use_graph``: on CUDA (None) each step of a
    uniform compressor is a CUDA-graph replay, and ``on_sync`` then sees
    the replay's static tensors (clone what you keep); ``graph=False``
    steps eagerly, with the grad / sync / update split on the host clock;
    ``graph=True`` off CUDA raises, and with a compressor whose step cannot
    be one graph (the composite: schedules, lazy groups, the server wire)
    raises, naming its ROADMAP item. Both donate the compressor state."""
    dev = resolve_device(device)
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}; options: {sorted(MODELS)}")
    init, forward = MODELS[model]
    params = init(n_classes, seed=seed, device=dev)
    params = tree_map(lambda t: t.requires_grad_(True), params)
    comp = make_compressor(comp_cfg, params)
    comm = comm if comm is not None else SimComm(n_workers)
    if comm.size() != n_workers:
        raise ValueError(f"a comm of {comm.size()} workers for {n_workers}")
    mine = comm.workers()  # this process's global workers
    comp_state = comp.init_state(7, comm.local_size(), dev)
    opt = sgd(lr)
    opt_state = opt.init(params)
    data_cfg = ImageDataConfig(
        n_classes=n_classes, hw=hw, batch=n_workers * batch, seed=seed
    )
    client_cfg = dataclasses.replace(
        data_cfg, batch=batch, noniid_alpha=noniid_alpha, n_clients=n_workers
    )
    # schedule phases: rebuild at each boundary, carry the state across
    sched = getattr(comp, "schedule", None)
    bounds = {b for b in sched.boundaries() if 0 < b < steps} if sched else set()

    graphed = graphs.use_graph(graph, dev)
    if graphed:
        why = comp.graph_refusal() or comm.graph_refusal()
        if why is not None:
            if graph:
                raise NotImplementedError(f"a graphed step: {why}")
            graphed = False
    replay = None

    results, losses, synced = [], [], None
    t0 = _clock(dev)
    for step in range(steps):
        if step in bounds:
            comp_t = comp.at_step(step)
            if comp_t is not comp:
                comp_state, comp = comp_t.adapt_state(comp_state), comp_t
        if noniid_alpha > 0:
            shards = [
                image_batch(client_cfg, step, dev, client=w)
                for w in range(mine.start, mine.stop)
            ]
            imgs = torch.stack([b["images"] for b in shards])
            lbls = torch.stack([b["labels"] for b in shards])
        else:
            b = image_batch(data_cfg, step, dev)
            imgs = b["images"].reshape((n_workers, batch) + b["images"].shape[1:])
            imgs, lbls = imgs[mine], b["labels"].reshape(n_workers, batch)[mine]
        if graphed:
            if replay is None:
                replay = _GraphedStep(
                    forward, params, opt, opt_state, comp, comp_state, comm, imgs, lbls
                )
            res = replay(imgs, lbls)
            synced, comp_state = replay.out["synced"], replay.out["comp_state"]
        else:
            res, synced, opt_state, comp_state = train_step(
                forward, params, opt, opt_state, comp, comp_state, comm, imgs, lbls
            )
        results.append(res)
        losses.append(res.loss)
        if on_step is not None:
            on_step(step, res)
        if on_sync is not None:
            on_sync(step, synced, comp_state)
    secs = (_clock(dev) - t0) / max(steps, 1)
    with torch.no_grad():
        b = image_batch(data_cfg, 10_000, dev)
        hit = forward(params, b["images"]).argmax(-1) == b["labels"]
        acc = float(hit.float().mean())
    return TrainResult(
        losses, acc, secs, results, params, comp, comp_state, synced, comm
    )


def steps_per_epoch(n_train: int, global_batch: int) -> int:
    return -(-n_train // global_batch)


def mb_per_epoch(comp: GradCompressor, n_train: int, global_batch: int) -> float:
    """The paper's 'Size' column: wire MB each worker sends per epoch."""
    return comp.wire_bits_per_step() / 8e6 * steps_per_epoch(n_train, global_batch)
