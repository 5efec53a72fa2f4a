"""The data-parallel LM training step: loss -> grad -> COMPRESSED sync ->
optimizer, the JAX package's ``train/step.py``.

The JAX step runs under ``shard_map`` with the data-parallel mesh axes
manual, so the compressor's quantized collectives are the only cross-worker
traffic (the paper's Algorithm 1). Here the mesh's data axis is a leading
worker dim of every per-worker tensor, over a comm of the reference's
collective semantics: ``SimComm(N)`` where one process (one card) holds
all N workers, or a ``DistComm`` over a ``torch.distributed`` process group
whose every rank holds ``k = N / world`` of them (``launch/mesh.py``; NCCL
a card, gloo on the CPU). Global worker w takes its own contiguous rows of
the global batch, as ``P("data")`` shards them (a rank is given the rows
of its k workers), and its gradient of its own mean loss; the compressor
syncs the (k, ...) gradients across all N workers and keeps per-worker
state (error feedback E, warm-start Q) for the rank's workers; the
optimizer steps the parameters in place, the same on every rank.

The parameters are the training tree, the JAX package's layout (scan
leaves stacked by repeat, ``models.model.stacked_flags``), so the
compressor's plans, per-layer scales, bits and collective counts are the
JAX package's. A mesh is ``(data, model)``.

Over a model axis above 1 (``tp``, a ``core.comm.ModelAxis`` over the
training tree's specs, ``launch/sharding.py:param_specs``) each rank of a
``data x model`` process group holds one worker (``comm`` spans its
data-axis group) and 1/M of every split parameter, its optimizer state and
its error feedback (:func:`train_state_specs`): the JAX package's layout,
whose ``model`` axis GSPMD shards automatically, so the sharded step
computes what the unsharded one does, up to rounding. The forward and the
loss are the tensor-parallel ones (``models/model.py``, the vocab-parallel
``train/loss.py``), whose model-axis collectives carry their backward; a
replicated leaf used inside a split branch gets only the rank's part of
its gradient, and the step sums those over the model axis in one
all-reduce before the sync (``launch/sharding.py:partial_grad_flags``).
The sync runs on the blocks (``core/compressors.py:ModelSplit``), and the
optimizer steps each block in place: SGD and Adam are elementwise, so a
block's update is the whole update's block. Every architecture and every
compressor run so, the composite's per-leaf policies, schedules, lazy
groups and server wire too: each rank's synced block is the block of what
one process computes on the same weights and batches.
"""

from __future__ import annotations

import functools
import weakref
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from repro_torch import graphs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.comm import CommRecord, DistComm, SimComm
from repro_torch.core.compressors import (
    CompressorConfig,
    GradCompressor,
    ModelSplit,
    make_compressor,
    model_split,
)
from repro_torch.core.lazy import SHARED_NS, STALE_NS
from repro_torch.core.tree import Tree, tree_leaves, tree_map, tree_unflatten
from repro_torch.launch.sharding import (
    Spec,
    assert_replicated,
    param_specs,
    partial_grad_flags,
)
from repro_torch.models.common import resolve_device
from repro_torch.models.model import init_params, stacked_flags
from repro_torch.train.loss import lm_loss
from repro_torch.train.optimizer import Optimizer
from repro_torch.weights import init_sharded_params, to_jax_layout

__all__ = [
    "build_train_step",
    "TrainStep",
    "init_train_state",
    "init_train_params",
    "make_model_compressor",
    "abstract_grads_of",
    "n_dp_of",
    "train_param_specs",
    "train_state_specs",
]

Mesh = tuple[int, int]  # (data, model)
# called as on_sync(per-worker grads, synced grads, new compressor state,
# record) after each step
OnSync = Callable[[Tree, Tree, Any, CommRecord], None]


def n_dp_of(mesh: Mesh) -> int:
    """The data-parallel workers of a (data, model) mesh (all ranks'): its
    data axis, whatever its model axis."""
    data, model = mesh
    if model < 1:
        raise ValueError(f"a model axis of {model}")
    if data < 1:
        raise ValueError(f"a data axis of {data}")
    return data


def train_param_specs(cfg: ModelConfig, model: int) -> Tree:
    """The training tree's parameter specs over a model axis of ``model``
    (``launch/sharding.py:param_specs`` of the abstract tree)."""
    abstract, flags = abstract_grads_of(cfg)
    return param_specs(abstract, flags, axis_size=model, cfg=cfg)


def _replicated(leaf: Any) -> Spec:
    return Spec(*([None] * len(getattr(leaf, "shape", ()))))


def train_state_specs(
    state: dict[str, Any], specs: Tree, compressor: GradCompressor
) -> dict[str, Any]:
    """The spec of every leaf of a training state ``{params, opt, comp,
    step}``: the parameters' ``specs``; an optimizer state's param-shaped
    subtrees (Adam's moments, SGD's momentum) the same, the rest (Adam's
    step count) replicated; the compressor state's
    :meth:`~repro_torch.core.compressors.GradCompressor.state_pspecs`
    behind the leading worker dim (but the lazy groups' shared
    namespaces, ``lazy.SHARED_NS``, which have none); ``step``
    replicated."""
    opt = {
        k: specs if isinstance(v, dict) else _replicated(v)
        for k, v in state["opt"].items()
    }

    def strip(x):
        return x[0] if isinstance(x, torch.Tensor) and x.dim() else x

    inner = {
        ns: sub if ns in SHARED_NS else tree_map(strip, sub)
        for ns, sub in state["comp"].items()
    }
    comp_specs = compressor.state_pspecs(inner, specs)
    if STALE_NS in comp_specs:
        # the lazy fire decision reads the staleness counter on every rank:
        # a counter sharded over the model axis could split the branch
        assert_replicated(comp_specs[STALE_NS], f"comp.{STALE_NS}")
    comp = {
        ns: sp if ns in SHARED_NS else _map_specs(_worker_dim, sp, state["comp"][ns])
        for ns, sp in comp_specs.items()
    }
    return dict(params=specs, opt=opt, comp=comp, step=Spec())


def _worker_dim(spec: Spec) -> Spec:
    return Spec(None, *spec)


def _map_specs(fn: Callable, specs: Any, like: Any) -> Any:
    """``fn`` over the specs of a spec tree laid out as ``like`` (a Python
    number's spec is kept: it has no worker dim)."""
    if isinstance(like, dict):
        return {k: _map_specs(fn, specs[k], v) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_map_specs(fn, sp, v) for sp, v in zip(specs, like)]
    return fn(specs) if isinstance(like, torch.Tensor) and like.dim() else specs


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
    *,
    tp: Any = None,
    mesh: Any = None,
) -> dict[str, Any]:
    """{params, opt, comp (per-worker, leading dim ``n_dp``: the workers
    this process holds), step (int32)}. With ``tp`` (a ``ModelAxis`` over
    the training tree's specs) and its ``mesh``, this rank's blocks: the
    seeded init cut as it is drawn (``weights.init_sharded_params``), the
    optimizer state of the blocks, the error feedback's blocks."""
    dev = resolve_device(device)
    if tp is None or tp.comm.size == 1:
        params = init_train_params(cfg, seed, dev)
        comp = compressor.init_state(seed, n_dp, dev)
    else:
        params = init_sharded_params(cfg, seed, dev, tp.specs, mesh)
        params = tree_map(lambda w: w.requires_grad_(True), params)
        split = model_split(tp.comm, tp.specs)
        comp = compressor.init_state(seed, n_dp, dev, model=split)
    return dict(
        params=params,
        opt=optimizer.init(params),
        comp=comp,
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
    remat: bool = True,
    loss_fn: Callable | None = None,
    comm: SimComm | None = None,
    on_sync: OnSync | None = None,
    graph: bool | None = None,
    tp: Any = None,
) -> TrainStep:
    """Returns ``step_fn(state, batch) -> (state, metrics)``, a
    :class:`TrainStep`.

    ``batch`` is {"tokens": (B, S)}, numpy or a tensor: the rows of the
    workers this process holds (the global batch with one process, the
    rank's ``comm.rows`` of it over several), B divisible by them. The
    whole state is donated, as the JAX launcher's jit donates it
    (``donate_argnums=0``): the parameters, the optimizer
    state, the compressor state (an f32 error feedback, the warm-start Q)
    and ``step`` are updated in place and the returned state holds the same
    tensors, so the state passed in is the state returned. ``metrics`` are
    0-dim f32 tensors on the device, so a caller reads them when it chooses:
    ``ce`` and ``loss`` (the mean over workers; ``moe_aux`` too for a model
    with MoE layers), the sync's effective
    ``wire_mb_per_step`` and ``collectives_per_step``, and
    ``down_mb_per_step``.

    ``graph`` follows ``graphs.use_graph``: on CUDA (None) the step is one
    CUDA-graph replay (the port's counterpart of the jitted step), bound to
    the state it is first given; ``graph=False`` runs it eagerly, for
    comparisons; ``graph=True`` off CUDA raises. A compressor whose step
    cannot be one graph (``compressor.graph_refusal()``: the composite, the
    server wire, an error feedback stored in another dtype than f32) runs
    eagerly, and with ``graph=True`` raises, naming its ROADMAP item.

    ``remat`` (the JAX step's ``remat_scan``, on by default as there)
    recomputes each repeat of the layer pattern in the backward; it applies
    to the default loss. ``accum_steps=k`` splits each worker's rows into k
    sequential microbatches, sums their gradients in f32 and divides by k,
    then syncs once: error feedback and wire bits per step are unchanged;
    ``k=1`` is the single pass. ``comm`` carries the sync: a ``SimComm``
    of the mesh's workers, or a ``DistComm`` whose ranks hold them (either
    with ``record=True`` keeps every step's gathers, graphed or eager); by
    default a ``SimComm`` (``launch/mesh.py:make_comm`` picks one for a
    mesh over ranks). Over several ranks each is given the rows of its
    own workers (``comm.rows``), metrics are the mean over all workers on
    every rank, and every compressor syncs across the ranks; over gloo the
    step runs eagerly and ``graph=True`` raises (``comm.graph_refusal()``).
    ``on_sync`` is called after each
    step, outside any capture, with the step's per-worker gradients into
    the sync, its synced gradients, the new compressor state and its
    ``CommRecord``: the step's buffers, which the next step overwrites.

    A mesh whose model axis is above 1 takes ``tp``, a ``ModelAxis`` of
    that size over the training tree's specs (:func:`train_param_specs`);
    ``comm`` then spans the rank's data-axis group and the state is the
    rank's blocks (:func:`init_train_state` with ``tp``). The per-worker
    gradients are the blocks, the partial ones of replicated leaves summed
    over the model axis; ``metrics`` are the same on every model rank of a
    data row. Over NCCL the step is one graph with its model-axis and
    data-axis collectives captured; over gloo it runs eagerly, and
    ``graph=True`` raises."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    n = n_dp_of(mesh)
    model = mesh[1]
    if model > 1:
        if tp is None or tp.comm.size != model:
            raise ValueError(
                f"a model axis of {model} needs a ModelAxis of {model} ranks (tp)"
            )
    elif tp is not None and tp.comm.size != 1:
        raise ValueError(f"a ModelAxis of {tp.comm.size} for a model axis of 1")
    comm = comm if comm is not None else SimComm(n)
    if comm.size() != n:
        raise ValueError(f"a comm of {comm.size()} workers for a mesh of {n}")
    tp = tp if model > 1 else None
    loss_fn = loss_fn or functools.partial(
        lm_loss, cfg=cfg, head_chunk=head_chunk, remat=remat, tp=tp
    )
    return TrainStep(
        n,
        compressor,
        optimizer,
        loss_fn,
        comm,
        accum_steps=accum_steps,
        on_sync=on_sync,
        graph=graph,
        tp=tp,
    )


class TrainStep:
    """One data-parallel training step over the mesh's workers (see
    :func:`build_train_step`), eager or as a CUDA-graph replay.

    Graphed, the first call binds the step to its state: the parameters,
    optimizer and compressor state and step counter are the graph's static
    buffers, updated in place by every replay, and the batch is copied into
    a static device buffer before each. The first step runs eagerly (the
    warm-up), the second is captured and replayed, the rest are replays
    (``graphs.SyncStepGraph``, which also keeps what the compressor holds
    on the host, QSGD's seed and step counter, in step with the replays).
    A call with another state (a restored checkpoint, a fresh run)
    drops the graph and binds anew. Attributes a caller may read after
    a call: ``batch`` (the static batch of a graphed step), ``grads`` (the
    per-worker gradient buffers), ``synced`` (the last step's synced
    gradients), ``graph`` (the ``StepGraph``, or None) and ``capture_s``.

    ``tp`` (a ``ModelAxis``): the state holds this rank's blocks over the
    model axis; ``model`` is the sync's ``ModelSplit`` and ``partial`` the
    flattened indices of the leaves whose gradients are summed over the
    axis before the sync."""

    def __init__(
        self,
        n: int,
        compressor: GradCompressor,
        optimizer: Optimizer,
        loss_fn: Callable,
        comm: SimComm | DistComm,
        *,
        accum_steps: int = 1,
        on_sync: OnSync | None = None,
        graph: bool | None = None,
        tp: Any = None,
    ):
        self.n = n
        self.k = comm.local_size()  # the workers this process holds
        self.compressor = compressor
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.comm = comm
        self.accum_steps = accum_steps
        self.on_sync = on_sync
        self.graph_arg = graph
        self.sync_graph: graphs.SyncStepGraph | None = None
        self.batch: dict[str, torch.Tensor] | None = None
        self.grads: Tree | None = None
        self.synced: Tree | None = None
        self._call_state: dict[str, Any] | None = None  # the call's state
        self._out: tuple | None = None  # the graph body's (state, metrics, rec)
        self.tp = tp
        self.model: ModelSplit | None = None
        self.partial: list[int] = []
        if tp is not None:
            self.model = model_split(tp.comm, tp.specs)
            flags = tree_leaves(partial_grad_flags(tp.specs))
            self.partial = [i for i, f in enumerate(flags) if f]

    @property
    def graph(self) -> graphs.StepGraph | None:
        return self.sync_graph.graph if self.sync_graph is not None else None

    @property
    def capture_s(self) -> float:
        return self.graph.capture_s if self.graph is not None else 0.0

    def release(self) -> None:
        """Drop the graph and the buffers bound to a state."""
        self.sync_graph = self.batch = self.grads = self.synced = None
        self._out = self._call_state = None

    def __call__(self, state: dict[str, Any], batch: dict[str, Any]):
        dev = tree_leaves(state["params"])[0].device
        if not self._graphed(dev):
            return self._eager(state, batch, dev)
        if self.sync_graph is None or not self.sync_graph.binds(state):
            self._bind(state, batch, dev)
        for k, v in batch.items():
            src = torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            self.batch[k].copy_(src, non_blocking=True)
        self._call_state = state
        comp = self.sync_graph.run(state["comp"])
        new_state, metrics, rec = self._out
        new_state = {**new_state, "comp": comp}
        self._call_on_sync(new_state, rec)
        # a replay overwrites its outputs: each step's metrics in fresh
        # tensors, copied on the stream before the next replay
        return new_state, {k: v.clone() for k, v in metrics.items()}

    def graph_refusal(self) -> str | None:
        """Why this step cannot be one CUDA graph (its compressor, its
        data-axis comm, its model axis's), or None."""
        why = self.compressor.graph_refusal() or self.comm.graph_refusal()
        if why is None and self.tp is not None and self.tp.gloo:
            why = (
                "the model axis's gloo collectives run from the host, which a "
                "CUDA graph cannot capture (use NCCL, one rank a card)"
            )
        return why

    def _graphed(self, dev: torch.device) -> bool:
        if not graphs.use_graph(self.graph_arg, dev):
            return False
        why = self.graph_refusal()
        if why is not None:
            if self.graph_arg:
                raise NotImplementedError(f"a graphed step: {why}")
            return False
        return True

    def _eager(self, state, batch, dev):
        self.synced = None  # the last step's, released before this one's
        self.batch = _to_device(batch, dev)
        new_state, metrics, rec = self._run(state, self.batch, dev)
        self._call_on_sync(new_state, rec)
        return new_state, metrics

    def _bind(self, state, batch, dev) -> None:
        self.release()
        self.batch = {
            k: torch.empty(v.shape, dtype=_dtype_of(v), device=dev)
            for k, v in batch.items()
        }
        self._alloc_grads(state["params"])
        me = weakref.ref(self)  # no cycle: the step frees its graph at once

        def body(gens):
            step = me()
            new_state, metrics, rec = step._run(step._call_state, step.batch, dev, gens)
            step._out = (new_state, metrics, rec)
            return new_state

        self.sync_graph = graphs.SyncStepGraph(
            body, dev, self.compressor, state, state["comp"], self.comm
        )

    def _alloc_grads(self, params: Tree) -> None:
        leaves = tree_leaves(params)
        have = tree_leaves(self.grads) if self.grads is not None else []
        if len(have) == len(leaves) and all(
            g.shape[1:] == w.shape and g.dtype == w.dtype and g.device == w.device
            for g, w in zip(have, leaves)
        ):
            return
        self.grads = tree_unflatten(
            params,
            [
                torch.empty((self.k,) + w.shape, dtype=w.dtype, device=w.device)
                for w in leaves
            ],
        )

    def _call_on_sync(self, new_state, rec) -> None:
        if self.on_sync is not None:
            self.on_sync(self.grads, self.synced, new_state["comp"], rec)

    def _grad_of(self, params: Tree, leaves: list, rows: dict):
        loss, metrics = self.loss_fn(params, rows)
        grads = torch.autograd.grad(loss, leaves)
        return list(grads), {k: v.detach() for k, v in metrics.items()}

    def _worker_grad(self, params: Tree, leaves: list, rows: dict):
        k = self.accum_steps
        if k == 1:
            return self._grad_of(params, leaves, rows)
        b = next(iter(rows.values())).shape[0]
        if b % k:
            raise ValueError(
                f"per-worker batch {b} not divisible by accum_steps={k}"
            )
        acc = [torch.zeros_like(w, dtype=torch.float32) for w in leaves]
        ms = []
        for mb in range(k):
            sl = slice(mb * b // k, (mb + 1) * b // k)
            mb_rows = {name: v[sl] for name, v in rows.items()}
            gs, m = self._grad_of(params, leaves, mb_rows)
            for a, g in zip(acc, gs):
                a.add_(g.float())
            ms.append(m)
        grads = [(a / k).to(w.dtype) for a, w in zip(acc, leaves)]
        # equal microbatches: the mean of their mean losses is the batch's
        return grads, {
            name: torch.stack([m[name] for m in ms]).mean(0) for name in ms[0]
        }

    def _sum_partial(self, bufs: list[torch.Tensor]) -> None:
        """The partial gradients of the replicated leaves used inside a
        split branch, summed over the model axis (every worker's rows)."""
        _sum_partial_into([bufs[i] for i in self.partial], self.tp.comm)

    def _run(self, state, batch, dev, gens=None):
        """The step's work on a batch already on ``dev``: every worker's
        gradients into ``grads``, the donated sync (drawing from ``gens``,
        the graph's generators, where given), the update in place. Reads
        nothing on the host."""
        n, comm = self.k, self.comm
        params = state["params"]
        leaves = tree_leaves(params)
        for w in leaves:
            w.requires_grad_(True)
        b = next(iter(batch.values())).shape[0]
        if b % n:
            raise ValueError(f"batch of {b} rows not divisible by {n} workers")
        per = {k: v.reshape((n, b // n) + v.shape[1:]) for k, v in batch.items()}
        self._alloc_grads(params)
        bufs = tree_leaves(self.grads)
        worker_metrics = []
        for wk in range(n):
            rows = {k: v[wk] for k, v in per.items()}
            gs, m = self._worker_grad(params, leaves, rows)
            for buf, g in zip(bufs, gs):
                buf[wk].copy_(g)
            del gs
            worker_metrics.append(m)
        if self.partial:
            self._sum_partial(bufs)
        comp = state["comp"]
        with torch.no_grad():
            kw = {} if self.model is None else {"model": self.model}
            synced, comp, rec = self.compressor.sync(
                self.grads,
                {**comp, "gen": gens} if gens else comp,
                comm,
                donate=True,
                **kw,
            )
        comp = {k: v for k, v in comp.items() if k != "gen"}
        self.synced = synced
        opt = self.optimizer.update(synced, state["opt"], params)
        with torch.no_grad():
            metrics = {
                k: comm.metric_mean(torch.stack([m[k] for m in worker_metrics]))
                for k in worker_metrics[0]
            }
            metrics["wire_mb_per_step"] = _f32(rec.effective_bits() / 8e6, dev)
            metrics["collectives_per_step"] = _f32(rec.effective_collectives(), dev)
            metrics["down_mb_per_step"] = _f32(rec.down_bits / 8e6, dev)
            state["step"].add_(1)
        # donated: the caller's dict takes the new state, so no caller keeps
        # an old compressor state alive (the composite's is new every step)
        state.update(params=params, opt=opt, comp=comp)
        return state, metrics, rec


@torch.no_grad()
def _sum_partial_into(bufs: list[torch.Tensor], comm: Any) -> None:
    """Each of ``bufs`` replaced in place by its f32 sum over ``comm``, all
    in one all-reduce."""
    flat = torch.cat([b.reshape(-1).float() for b in bufs])
    flat = comm.all_reduce(flat, "tp.grad.partial")
    for b, x in zip(bufs, flat.split([b.numel() for b in bufs])):
        b.copy_(x.reshape(b.shape))


def _dtype_of(v: Any) -> torch.dtype:
    if isinstance(v, np.ndarray):
        return torch.from_numpy(np.empty(0, v.dtype)).dtype
    return v.dtype
