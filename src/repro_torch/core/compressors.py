"""Gradient-compressor framework + the paper's non-low-rank baselines.

A compressor replaces the data-parallel gradient all-reduce:

    comp  = make_compressor(cfg, abstract_grads, stacked=...)
    state = comp.init_state(seed, n_workers, device)    # E, warm Q, counters
    g_bar, state, rec = comp.sync(grads, state, comm)   # SimComm or DistComm

Every per-worker tensor carries the workers as its leading dim: the grads
and the error feedback E are (N, *shape), the warm-start Q (N, m, r), with
N the workers this process holds (all of them on a ``SimComm``, a rank's
``local_workers`` on a ``DistComm``). The
synced gradients come back without it, since every worker holds the same
values after a sync, as the JAX package's vmap'd workers do.

Per-leaf routing: each leaf gets a :class:`LeafPlan` from its shape. Small
or 1-D tensors (biases, norms) take the raw path ("rank-1 tensors are
aggregated uncompressed", as in PowerSGD's reference implementation); the
rest take the method's path. Leaves are numbered in JAX flatten order
(:mod:`repro_torch.core.tree`): the number names the state keys, seeds the
warm-start Q and orders the fused buffers.

The method math lives in :class:`LeafGroupHandler` subclasses; a
dedicated compressor drives one handler over every leaf, and
:class:`~repro_torch.core.composite.CompositeCompressor` one handler per
method group of a per-leaf policy. :func:`make_compressor` routes per-leaf
policies, schedules, lazy aggregation, server drop-out and the randomized
privacy codecs (``codec``, ``dp_epsilon``) to the composite, as the JAX
package does.

Over a ``(data, model)`` mesh of M > 1 (:class:`ModelSplit`) each rank
holds its model-axis block of every split gradient leaf, of its error
feedback (:meth:`GradCompressor.state_pspecs`) and of the parameter; the
warm-start Q stays whole. The sync ships blocks over the data-axis comm and
joins what the method needs over the model axis, so that each rank's
synced block is the block of what one process computes: PowerSGD / LQ-SGD's
split power iteration (``core/powersgd.py``), TopK's candidates
(:func:`topk_mask`), the quantization scales' max, and the whole tensor's
draws cut to the block (``codec.ModelBlock``). ``CommRecord.bits_sent``
stays the whole model's accounting, and ``phys_bits`` says what the rank
shipped. Every compressor runs so, the composite's policies, lazy groups
and server wire too (``core/composite.py``).

Generators: a randomized method draws from one ``torch.Generator`` per
(leaf, step, stream), seeded from the state's ``key`` seed
(:func:`leaf_generator`). One generator draws the whole (N, ...) tensor,
so the workers' draws are independent, as JAX's ``fold_in`` of the worker
index makes them; a process holding k < N of the workers draws the whole
tensor too and keeps its rows (``codec.WorkerRows``), so a worker's bits
do not depend on how the workers are spread over processes. Streams: QSGD
0; the post-hoc noise and the attack restarts of
:mod:`repro_torch.core.privacy.harness` 1 and 2; LQ-SGD's randomized
codecs :data:`PHASE_STREAMS` (the JAX package's phase tags P, Q and raw),
so no leaf's streams collide in a composite.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable, Iterable, Sequence
from typing import Any

import numpy as np
import torch

from repro_torch.core.comm import CommRecord, SimComm
from repro_torch.core.low_rank import matricize_shape
from repro_torch.core.tree import (
    Tree,
    flatten_with_paths,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from repro_torch.core.wire import ServerWire, SymmetricWire, as_wire

__all__ = [
    "CompressorConfig",
    "LeafPolicy",
    "LeafPlan",
    "LeafGroupHandler",
    "TopKHandler",
    "QSGDHandler",
    "GradCompressor",
    "NoCompression",
    "TopKCompressor",
    "QSGDCompressor",
    "make_compressor",
    "build_plans",
    "leaf_generator",
    "leaf_seed",
    "per_worker",
    "donates",
    "error_corrected",
    "state_dtype",
    "check_across_ranks",
    "ModelSplit",
    "model_split",
    "topk_mask",
    "POLICY_METHODS",
    "PHASE_STREAMS",
]

# every method a LeafPolicy may name; 'raw' is the uncompressed f32 pmean
POLICY_METHODS = ("raw", "topk", "qsgd", "powersgd", "lq_sgd")
# leaf_generator streams of a randomized factor codec's P, Q and raw phases
# (the JAX package's phase tags 0 / 1 / 2); QSGD draws from stream 0
PHASE_STREAMS = {"p": 3, "q": 4, "raw": 5}


@dataclasses.dataclass(frozen=True)
class CompressorConfig:
    """Config shared by all compressors (the JAX package's fields, without
    its backend flag: the port dispatches by tensor device)."""

    name: str = "none"
    # low-rank options (powersgd / lq_sgd)
    rank: int = 1
    # quantization options (lq_sgd / qsgd)
    bits: int = 8
    bits_q: int | None = None  # paper allows b_p != b_q; None -> same as bits
    alpha: float = 10.0
    # topk options
    topk_ratio: float = 0.01
    # routing
    min_compress_numel: int = 1024
    # 'allgather_codes' (exact packed wire) or 'psum_sim' (ring all-reduce
    # simulated over f32 codes)
    wire_accounting: str = "allgather_codes"
    # 'paper' = expand(mean(codes)) [Algorithm 1 literal];
    # 'dequant_then_mean' = mean(expand(codes))
    avg_mode: str = "paper"
    # fuse all factor payloads of a phase into one flat collective
    fuse_collectives: bool = False
    # error-feedback storage dtype, a torch dtype name ('float32', or
    # 'bfloat16' to halve the dominant per-worker state)
    state_dtype: str = "float32"
    # ---- per-leaf policies (core/policy.py, core/composite.py) -----------
    # None/'uniform': ``name`` everywhere; 'auto': the cost-model planner
    # under ``error_budget``; else a spec 'pattern=method:knob=v,...'
    policy: str | None = None
    error_budget: float = 0.3
    # schedule: the exact f32 mean for the first ``warmup_steps`` steps
    warmup_steps: int = 0
    # schedule: piecewise-constant caps ((start_step, rank_cap|None,
    # bits_cap|None), ...), applied by rebuilding at phase boundaries
    schedule_decay: tuple[tuple[int, int | None, int | None], ...] = ()
    # ---- lazy aggregation (core/lazy.py) ---------------------------------
    # > 0: a method group whose innovation is small skips its round and
    # applies its cached aggregate; 0 = eager
    lazy_thresh: float = 0.0
    # max consecutive skipped rounds before a fire is forced
    max_stale: int = 4
    # 'elide': a skipped round issues none of the group's kernels or
    # gathers (one host read of the decision per group and step); 'gate':
    # the group runs every round and the result is selected on the device
    lazy_mode: str = "elide"
    # adaptive LAQ: > 0 caps the drift-EMA threshold scaling; 0 = fixed
    lazy_adaptive: float = 0.0
    # ---- wire topology (core/wire.py) ------------------------------------
    # 'symmetric' all-reduce among peers, or 'server': a parameter-server
    # round with per-worker participation and per-worker lazy decisions
    topology: str = "symmetric"
    # server wire: each worker's per-round upload probability
    participation: float = 1.0
    # server weighting: 'participation' or 'sparsity' (FedDropoutAvg)
    agg: str = "participation"
    participation_seed: int = 0
    # ---- randomized privacy codecs (core/codec.py) -----------------------
    # the log-quant family's wire codec: None -> 'log' (or 'dlog' when
    # dp_epsilon > 0); 'dlog' / 'lrq' the randomized ones
    codec: str | None = None
    # per-use DP budget: > 0 calibrates dlog's Gaussian noise to
    # (dp_epsilon, dp_delta) per transmitted message; 0 = no DP noise
    dp_epsilon: float = 0.0
    dp_delta: float = 1e-5
    # layer count of the 'lrq' layered randomized quantizer
    lrq_layers: int = 2

    def __post_init__(self):
        if self.dp_epsilon < 0:
            raise ValueError(f"dp_epsilon must be >= 0, got {self.dp_epsilon}")


@dataclasses.dataclass(frozen=True)
class LeafPolicy:
    """Per-tensor compression decision: which method ships this leaf, and
    with what knobs. Dedicated compressors use one uniform policy."""

    method: str = "lq_sgd"  # one of POLICY_METHODS
    rank: int = 1
    bits: int = 8
    bits_q: int | None = None  # factor-Q wire bits; None -> same as bits
    topk_ratio: float = 0.01
    # wire codec of the log-quant family: None -> the config's ('log', or
    # 'dlog' when a DP budget is set); 'dlog' / 'lrq' the randomized ones
    codec: str | None = None
    dp_epsilon: float = 0.0  # per-use DP budget of this leaf; 0 -> the config's
    min_numel: int | None = None  # per-leaf routing-threshold override
    # lazy aggregation: relative innovation threshold (0.0 = eager) and the
    # max consecutive skips before a forced fire
    lazy_thresh: float = 0.0
    max_stale: int = 4
    # adaptive LAQ: cap on the drift-EMA threshold scaling; 0.0 or >= 1
    lazy_adaptive: float = 0.0

    def __post_init__(self):
        if self.method not in POLICY_METHODS:
            raise ValueError(
                f"unknown policy method {self.method!r}; options: {POLICY_METHODS}"
            )
        if self.lazy_thresh < 0:
            raise ValueError(f"lazy_thresh must be >= 0, got {self.lazy_thresh}")
        if self.lazy_thresh > 0 and self.max_stale < 1:
            raise ValueError(
                f"lazy_thresh > 0 needs max_stale >= 1 (a staleness cap so "
                f"no group silently freezes), got max_stale={self.max_stale}"
            )
        if self.lazy_adaptive != 0 and self.lazy_adaptive < 1:
            raise ValueError(
                f"lazy_adaptive is a scaling CAP: 0 (off) or >= 1, got "
                f"{self.lazy_adaptive}"
            )
        if self.dp_epsilon < 0:
            raise ValueError(f"dp_epsilon must be >= 0, got {self.dp_epsilon}")
        if self.codec is not None:
            from repro_torch.core.codec import available_codecs

            if self.codec not in available_codecs():
                raise ValueError(
                    f"unknown codec {self.codec!r}; available: {available_codecs()}"
                )

    @property
    def eff_bits_q(self) -> int:
        return self.bits if self.bits_q is None else self.bits_q


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """Static per-tensor routing decision (computed once from shapes)."""

    path: str
    shape: tuple[int, ...]
    dtype: Any
    route: str  # 'lowrank' | 'raw'
    stacked: bool  # leading dim is a scan-layer stack
    mat_shape: tuple[int, int] | None  # per-instance matricized (n, m)
    eff_rank: int
    policy: LeafPolicy = LeafPolicy()


def _numel(shape: tuple[int, ...]) -> int:
    return math.prod(shape)


def _leaf_plan(
    path: str, leaf: Any, policy: LeafPolicy, min_numel: int, stacked: bool
) -> LeafPlan:
    shape = tuple(leaf.shape)
    if policy.min_numel is not None:
        min_numel = policy.min_numel
    inst_shape = shape[1:] if stacked else shape
    route, mat, eff_rank = "raw", None, 0
    if policy.method != "raw" and len(inst_shape) >= 2 and _numel(shape) >= min_numel:
        n, m = matricize_shape(inst_shape)
        r = min(policy.rank, n, m)
        if n * m > r * (n + m):  # compression actually pays
            route, mat, eff_rank = "lowrank", (n, m), r
    return LeafPlan(path, shape, leaf.dtype, route, stacked, mat, eff_rank, policy)


def build_plans(
    abstract_grads: Tree,
    rank: int = 1,
    min_numel: int = 1024,
    stacked: Tree | None = None,
    *,
    policy: LeafPolicy | None = None,
    policies: Sequence[LeafPolicy] | None = None,
) -> tuple[LeafPlan, ...]:
    """One LeafPlan per leaf (anything with ``.shape`` and ``.dtype``), in
    JAX flatten order, under one uniform ``policy`` (by default powersgd at
    ``rank``) or a per-leaf list ``policies`` in flatten order."""
    flat = flatten_with_paths(abstract_grads)
    if stacked is None:
        stacked_leaves = [False] * len(flat)
    else:
        stacked_leaves = tree_leaves(stacked)
        if len(stacked_leaves) != len(flat):
            raise ValueError("`stacked` tree does not match grads structure")
    if policies is None:
        policies = [policy or LeafPolicy(method="powersgd", rank=rank)] * len(flat)
    if len(policies) != len(flat):
        raise ValueError(f"{len(policies)} policies for {len(flat)} leaves")
    return tuple(
        _leaf_plan(path, leaf, pol, min_numel, bool(st))
        for (path, leaf), pol, st in zip(flat, policies, stacked_leaves)
    )


def leaf_seed(seed: int, step: int, leaf: int, *, stream: int = 0) -> int:
    """The seed of one leaf's generator at one step, derived from the
    state's seed (the counterpart of ``fold_in(fold_in(key, step), leaf)``:
    the port's own stream, mixed by numpy's SeedSequence). Another
    ``stream`` gives another, independent seed for the same (seed, step,
    leaf)."""
    spawn_key = (stream,) if stream else ()
    seq = np.random.SeedSequence([seed, step, leaf], spawn_key=spawn_key)
    return int(seq.generate_state(1, np.uint64)[0]) >> 1


def leaf_generator(
    seed: int, step: int, leaf: int, device, *, stream: int = 0
) -> torch.Generator:
    """A generator on ``device`` seeded with :func:`leaf_seed`."""
    return torch.Generator(device=device).manual_seed(
        leaf_seed(seed, step, leaf, stream=stream)
    )


def state_dtype(cfg: CompressorConfig) -> torch.dtype:
    """The torch dtype of ``cfg.state_dtype`` (error-feedback storage)."""
    dtype = getattr(torch, cfg.state_dtype, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown state_dtype {cfg.state_dtype!r}")
    return dtype


def donates(err: torch.Tensor, donate: bool) -> bool:
    """Does a sync asked to ``donate`` write the new error feedback into
    ``err``? Only an f32 one can hold ``g + err``: an error feedback stored
    in another dtype (``state_dtype``) keeps the functional path."""
    return donate and err.dtype == torch.float32


def error_corrected(
    g: torch.Tensor, err: torch.Tensor, shape: tuple[int, ...], in_place: bool
) -> torch.Tensor:
    """``g + err`` in f32, shaped ``shape``; ``in_place`` forms it in the
    f32 ``err``'s own memory as ``err + g``, the same bits (IEEE addition
    commutes, and a bf16 ``g`` widens to f32 exactly), so the residual the
    caller writes into it is the new error feedback without a second copy."""
    if in_place:
        return err.view(shape).add_(g.reshape(shape))
    return g.float().reshape(shape) + err.float().reshape(shape)


def per_worker(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (k,) per-worker ``mask`` shaped to broadcast over ``like``'s
    (k, ...) layout (k the workers this process holds)."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - 1))


def _pmean_raw(
    g: torch.Tensor,
    comm: SimComm | SymmetricWire,
    rec: CommRecord,
    split: Any = None,
) -> torch.Tensor:
    """The f32 mean over the workers; ``split`` (a ``ModelComm``): ``g`` is
    this rank's block of a leaf split over that group, accounted whole."""
    whole = 1 if split is None else split.size
    rec.add(g[0].numel() * whole * 32, 1)  # f32 wire, ring payload ~ numel
    rec.add_phys(g[0].numel() * 32)
    return comm.pmean(g.float()).to(g.dtype)


@dataclasses.dataclass(frozen=True)
class ModelSplit:
    """The model axis a sync's gradients are sharded over: its comm (a
    ``core.comm.ModelComm``) and, per flattened leaf, the dim of the leaf
    (without the worker dim) that the axis cuts, None where the leaf is
    whole on every model rank (``launch/sharding.py:split_dim``)."""

    comm: Any
    dims: tuple[int | None, ...]

    @property
    def size(self) -> int:
        return self.comm.size

    def block(self, i: int, view: tuple[int, ...], dim: int | None = None) -> Any:
        """A ``codec.ModelBlock`` where the axis splits leaf ``i``, else
        None: of the leaf itself (``view`` its whole shape), or of a tensor
        made from it whose ``view`` cuts the leaf's split on ``dim``."""
        from repro_torch.core.codec import ModelBlock

        if self.dims[i] is None:
            return None
        d = self.dims[i] if dim is None else dim % len(view)
        return ModelBlock(self.comm, tuple(view), d)

    def block_plan(self, i: int, pl: LeafPlan) -> LeafPlan:
        """``pl`` with the shape of this rank's block of leaf ``i``."""
        if self.dims[i] is None:
            return pl
        shape = list(pl.shape)
        shape[self.dims[i]] //= self.size
        return dataclasses.replace(pl, shape=tuple(shape))

    def kind(self, i: int, pl: LeafPlan) -> str | None:
        """How leaf ``i``'s matricized instance is split: 'col' (its last
        dim: the columns), 'row' (another dim: a subset of the rows), or
        None (whole)."""
        d = self.dims[i]
        if d is None:
            return None
        return "col" if d == len(pl.shape) - 1 else "row"


def model_split(comm: Any, param_specs: Tree) -> ModelSplit:
    """The :class:`ModelSplit` of a model-axis ``comm`` over the gradient
    tree whose parameters take ``param_specs``."""
    from repro_torch.launch.sharding import flatten_specs, split_dim

    dims = tuple(split_dim(spec) for _, spec in flatten_specs(param_specs))
    return ModelSplit(comm, dims)


def check_across_ranks(compressor: Any, comm: Any) -> None:
    """Raise where ``comm`` spans several ranks (a ``DistComm`` of world
    above 1) and ``compressor`` cannot sync across them yet
    (``compressor.dist_refusal()``)."""
    world = getattr(comm, "world", 1)
    if world > 1:
        why = compressor.dist_refusal()
        if why is not None:
            raise NotImplementedError(f"a sync across {world} ranks: {why}")


def _block(model: ModelSplit | None, i: int, pl: LeafPlan) -> Any:
    """Leaf ``i``'s ``codec.ModelBlock`` over ``model``, None where it is
    whole (or there is no model axis)."""
    return None if model is None else model.block(i, pl.shape)


def topk_mask(flat: torch.Tensor, k: int, block: Any = None) -> torch.Tensor:
    """The f32 0/1 mask of each worker's top ``k`` entries by magnitude of a
    (w, numel) ``flat``, the whole leaf flattened. With ``block`` (a
    ``codec.ModelBlock``) ``flat`` is this rank's block of the leaf, and
    the top k are the whole leaf's: each rank's top ``min(k, block numel)``
    magnitudes are gathered over the model axis (one all-gather,
    ``tp.topk.cand``), every rank picks the same top k of them and keeps
    those of its own block. The whole leaf's top k lie inside the union of
    the blocks' top k, so the mask is one process's; equal magnitudes at
    the k-th place are taken in candidate order (entries of 0 change no
    value)."""
    mag = flat.abs()
    if block is None:
        idx = torch.topk(mag, k, dim=1).indices
        return torch.zeros_like(flat).scatter_(1, idx, 1.0)
    kc = min(k, flat.shape[1])
    vals, loc = torch.topk(mag, kc, dim=1)  # (w, kc) each
    cand = block.comm.all_gather(vals[None], 0, "tp.topk.cand")  # (M, w, kc)
    pick = torch.topk(cand.permute(1, 0, 2).reshape(flat.shape[0], -1), k, dim=1)
    pos = pick.indices  # (w, k) in rank-major candidate order
    mine = pos // kc == block.comm.rank
    local = torch.gather(loc, 1, torch.where(mine, pos % kc, 0))
    # a spare slot past the block takes the other ranks' picks
    local = torch.where(mine, local, flat.shape[1])
    mask = flat.new_zeros((flat.shape[0], flat.shape[1] + 1))
    return mask.scatter_(1, local, 1.0)[:, : flat.shape[1]]


def _group_by(items: Iterable[Any], keyf: Callable[[Any], Any]):
    """Insertion-ordered grouping: a uniform group stays ONE group."""
    groups: dict[Any, list] = {}
    for it in items:
        groups.setdefault(keyf(it), []).append(it)
    return groups.items()


# --------------------------------------------------------------------------
# leaf-group handlers: the method-specific sync over a subset of leaves
# --------------------------------------------------------------------------


class LeafGroupHandler:
    """Method-specific sync over a subset of the grad leaves.

    ``sync_group`` takes ``items = [(i, grad_leaf, plan), ...]`` (``i`` the
    global flattened-leaf index, each grad (N, *plan.shape)) and the
    compressor state, and returns ``(outs, updates)``: ``outs`` maps leaf
    index -> synced tensor, ``updates`` maps state namespace ->
    {str(i): new per-worker leaf state}, each in the dtype of the state it
    replaces. Namespaces in ``param_shaped`` hold each worker's own
    param-shaped tensors (error feedback); the rest are the same on every
    worker. ``needs_prng``: the group draws from the state's ``key`` seed
    and ``step`` counter (``group_needs_prng`` answers per group). With
    ``donate=True`` a handler may write a new state tensor into the memory
    of the one it replaces and return that same tensor (the JAX step's
    donated state); the values are the same bits either way."""

    method = "raw"
    namespaces: tuple[str, ...] = ()
    param_shaped: tuple[str, ...] = ()
    needs_prng = False

    def __init__(self, cfg: CompressorConfig):
        self.cfg = cfg

    def group_needs_prng(self, plans: Sequence[LeafPlan]) -> bool:
        """Does syncing these plans draw from the state's generators? The
        class flag for a static handler; a codec-driven one (LQ-SGD) answers
        per group, so a deterministic group keeps a state without ``key``."""
        del plans
        return self.needs_prng

    # ---- per-leaf state ---------------------------------------------------
    def init_leaf_state(
        self, seed: int, i: int, pl: LeafPlan, n_workers: int, device
    ) -> dict[str, torch.Tensor]:
        return {}

    # ---- the group sync ---------------------------------------------------
    def sync_raw(
        self,
        g: torch.Tensor,
        pl: LeafPlan,
        comm: SymmetricWire,
        rec: CommRecord,
        *,
        key: torch.Generator | None = None,
        split: Any = None,
    ) -> torch.Tensor:
        """One raw-route leaf; ``split``, a ``ModelComm``: ``g`` is the
        rank's block of a leaf split over its group."""
        del key  # the f32 pmean is deterministic
        return _pmean_raw(g, comm, rec, split)

    def sync_group(self, items, state, comm, rec, *, donate=False, model=None):
        """``model`` (a :class:`ModelSplit`, handlers that run over one):
        the items are the rank's blocks of leaves split over it."""
        return {
            i: self.sync_raw(g, pl, comm, rec, split=_block(model, i, pl))
            for i, g, pl in items
        }, {}

    # ---- static accounting ------------------------------------------------
    def raw_wire_bits(self, pl: LeafPlan, numel: int) -> int:
        return numel * 32

    def leaf_wire_bits(self, pl: LeafPlan) -> int:
        return self.raw_wire_bits(pl, _numel(pl.shape))

    def leaf_physical_bits(self, pl: LeafPlan) -> int:
        """Bits the run moves for this leaf, where a wire is simulated at
        another width than it is accounted (TopK's dense f32 stand-in for the
        sparse payload, ``psum_sim``'s f32 codes)."""
        return self.leaf_wire_bits(pl)

    def leaf_replicated_bits(self, pl: LeafPlan, kind: str | None) -> int:
        """Of this leaf's physical bits, those every model rank ships alike
        over a model axis that splits it as ``kind`` (``ModelSplit.kind``):
        a whole leaf's all, a split raw leaf's none (each rank ships its
        block)."""
        return self.leaf_physical_bits(pl) if kind is None else 0

    def leaf_epsilon(self, pl: LeafPlan, delta: float = 1e-5) -> float:
        """Per-step DP epsilon spent transmitting this leaf: the sum of
        ``epsilon_per_use`` over every encode of the leaf's sync (``inf``
        for any deterministic transmission, which has no DP guarantee)."""
        del delta
        return math.inf

    def leaf_epsilon_kind(self, pl: LeafPlan) -> str | None:
        """The kind of this leaf's epsilon claim (a codec's ``epsilon_kind``:
        'calibrated', 'gaussian_equiv'), ``None`` where it ships no noise."""
        del pl
        return None

    def raw_collectives(self, pl: LeafPlan) -> int:
        return 1

    def group_collectives(self, plans: Sequence[LeafPlan]) -> int:
        """The collectives ``sync_group`` over ``plans`` issues: static, as
        its bits are (``leaf_wire_bits``)."""
        return sum(self.raw_collectives(pl) for pl in plans if pl.route != "lowrank")


class TopKHandler(LeafGroupHandler):
    """TopK-SGD with error feedback: keep each worker's top-k entries by
    magnitude of the error-corrected gradient, zero the rest; the dense
    masked tensor is averaged (the dense simulation of a sparse all-reduce)
    while the accounting charges k * (32-bit value + ceil(log2(numel))-bit
    index) per worker."""

    method = "topk"
    namespaces = ("err",)
    param_shaped = ("err",)

    @staticmethod
    def _k(numel: int, ratio: float) -> int:
        return max(1, int(numel * ratio))

    @staticmethod
    def index_bits(numel: int) -> int:
        """Bits to address one of ``numel`` slots on the sparse wire."""
        return max(1, math.ceil(math.log2(numel))) if numel > 1 else 1

    def init_leaf_state(self, seed, i, pl, n_workers, device):
        if pl.route != "lowrank":  # the routing says which leaves compress
            return {}
        sd = state_dtype(self.cfg)
        return {"err": torch.zeros((n_workers,) + pl.shape, dtype=sd, device=device)}

    def sync_group(self, items, state, comm, rec, *, donate=False, model=None):
        from repro_torch.core.codec import codec_phase, make_codec

        outs: dict[int, torch.Tensor] = {}
        new_err: dict[str, torch.Tensor] = {}
        comp, kepts, account = [], [], []
        for i, g, pl in items:
            if pl.route != "lowrank":
                outs[i] = self.sync_raw(g, pl, comm, rec, split=_block(model, i, pl))
                continue
            err = state["err"][str(i)]
            in_place = donates(err, donate)
            flat = error_corrected(g, err, (g.shape[0], -1), in_place)
            numel = _numel(pl.shape)  # the whole leaf's, over a model axis too
            k = self._k(numel, pl.policy.topk_ratio)
            kept = flat * topk_mask(flat, k, _block(model, i, pl))
            if in_place:  # the residual in the old error feedback's memory
                new_err[str(i)] = err
                flat.sub_(kept)
            else:
                err_new = (flat - kept).reshape(g.shape)
                new_err[str(i)] = err_new.to(state_dtype(self.cfg))
            comp.append((i, g, pl))
            kepts.append(kept.reshape(g.shape))
            account.append(k * (32 + self.index_bits(numel)))
        if comp:
            synced = codec_phase(
                kepts,
                [pl.stacked for _, _, pl in comp],
                make_codec("float32"),
                comm,
                rec,
                avg_mode=self.cfg.avg_mode,
                wire=self.cfg.wire_accounting,
                fuse=self.cfg.fuse_collectives,
                account_bits=account,
            )
            for (i, g, pl), s in zip(comp, synced):
                outs[i] = s.to(g.dtype)
        return outs, {"err": new_err}

    def leaf_wire_bits(self, pl):
        numel = _numel(pl.shape)
        if pl.route != "lowrank":
            return self.raw_wire_bits(pl, numel)
        return self._k(numel, pl.policy.topk_ratio) * (32 + self.index_bits(numel))

    def leaf_physical_bits(self, pl):
        numel = _numel(pl.shape)
        if pl.route != "lowrank":
            return self.raw_wire_bits(pl, numel)
        return numel * 32  # the dense f32 simulation ships the whole tensor

    def group_collectives(self, plans):
        from repro_torch.core.codec import make_codec, phase_collectives

        n_comp = sum(pl.route == "lowrank" for pl in plans)
        return super().group_collectives(plans) + phase_collectives(
            n_comp,
            make_codec("float32"),
            wire=self.cfg.wire_accounting,
            fuse=self.cfg.fuse_collectives,
        )


class QSGDHandler(LeafGroupHandler):
    """QSGD (Alistarh et al. 2017): stochastic uniform quantization, with one
    generator per leaf and step derived from the state's ``key`` seed and
    ``step`` counter (:func:`leaf_generator`). A state that carries
    ``"gen"`` (leaf index -> generator, already seeded with this step's
    :func:`leaf_seed`) draws from those instead, the same stream: a CUDA
    graph registers them and reseeds them on the host before each replay
    (:meth:`GradCompressor.prng_seeds`)."""

    method = "qsgd"
    needs_prng = True

    def _codec(self, bits: int):
        from repro_torch.core.codec import make_codec

        return make_codec("qsgd", bits=bits)

    @staticmethod
    def _generator(state, i: int, device) -> torch.Generator:
        if "gen" in state:
            return state["gen"][str(i)]
        return leaf_generator(state["key"], state["step"], i, device)

    def sync_group(self, items, state, comm, rec, *, donate=False, model=None):
        from repro_torch.core.codec import codec_phase

        outs: dict[int, torch.Tensor] = {}
        comp = []
        for i, g, pl in items:
            if pl.route != "lowrank":
                outs[i] = self.sync_raw(g, pl, comm, rec, split=_block(model, i, pl))
            else:
                comp.append((i, g, pl))
        # one codec == one wire dtype == one (fused) phase
        for bits, sub in _group_by(comp, lambda it: it[2].policy.bits):
            # stochastic rounding is unbiased under plain averaging, and the
            # linear codec makes both avg modes the same
            synced = codec_phase(
                [g for _, g, _ in sub],
                [pl.stacked for _, _, pl in sub],
                self._codec(bits),
                comm,
                rec,
                avg_mode="dequant_then_mean",
                wire=self.cfg.wire_accounting,
                fuse=self.cfg.fuse_collectives,
                keys=[self._generator(state, i, g.device) for i, g, _ in sub],
                split=[_block(model, i, pl) for i, _, pl in sub],
            )
            for (i, g, pl), s in zip(sub, synced):
                outs[i] = s.to(g.dtype)
        return outs, {}

    def leaf_wire_bits(self, pl):
        numel = _numel(pl.shape)
        if pl.route != "lowrank":
            return self.raw_wire_bits(pl, numel)
        codec = self._codec(pl.policy.bits)
        n_scales = pl.shape[0] if pl.stacked else 1
        return codec.wire_bits(numel) + codec.scale_bits(n_scales)

    def leaf_physical_bits(self, pl):
        if pl.route != "lowrank" or self.cfg.wire_accounting != "psum_sim":
            return self.leaf_wire_bits(pl)
        codec = self._codec(pl.policy.bits)
        n_scales = pl.shape[0] if pl.stacked else 1
        return _numel(pl.shape) * 32 + codec.scale_bits(n_scales)  # f32 codes

    def leaf_replicated_bits(self, pl, kind):
        # a split leaf's codes go in blocks; its scales are the model-wide max
        if pl.route != "lowrank" or kind is None:
            return super().leaf_replicated_bits(pl, kind)
        n_scales = pl.shape[0] if pl.stacked else 1
        return self._codec(pl.policy.bits).scale_bits(n_scales)

    def group_collectives(self, plans):
        from repro_torch.core.codec import phase_collectives

        comp = [pl for pl in plans if pl.route == "lowrank"]
        return super().group_collectives(plans) + sum(
            phase_collectives(
                len(sub),
                self._codec(bits),
                wire=self.cfg.wire_accounting,
                fuse=self.cfg.fuse_collectives,
            )
            for bits, sub in _group_by(comp, lambda pl: pl.policy.bits)
        )


# --------------------------------------------------------------------------
# compressors: one handler driven over the whole tree
# --------------------------------------------------------------------------


class GradCompressor:
    """Base: raw pmean for everything. Subclasses swap the handler."""

    method = "raw"
    handler_cls: type[LeafGroupHandler] = LeafGroupHandler

    def __init__(
        self, cfg: CompressorConfig, abstract_grads: Tree, stacked: Tree | None = None
    ):
        self.cfg = cfg
        self._structure = abstract_grads
        policy = LeafPolicy(
            method=self.method,
            rank=cfg.rank,
            bits=cfg.bits,
            bits_q=cfg.bits_q,
            topk_ratio=cfg.topk_ratio,
        )
        self.plans = build_plans(
            abstract_grads, cfg.rank, cfg.min_compress_numel, stacked, policy=policy
        )
        self.handler = self.handler_cls(cfg)

    # ---- state -----------------------------------------------------------
    def init_state(
        self,
        seed: int,
        n_workers: int,
        device="cuda",
        model: ModelSplit | None = None,
    ) -> dict[str, Any]:
        """Per-worker state: every tensor has the leading worker dim, of the
        ``n_workers`` this process holds (a ``DistComm`` rank's local ones).
        Over a model axis (``model``) a param-shaped leaf (the error
        feedback) is this rank's block; the rest (the warm-start Q) is
        whole, drawn as in one process."""
        state: dict[str, Any] = {ns: {} for ns in self.handler.namespaces}
        for i, pl in enumerate(self.plans):
            if model is not None:
                pl = model.block_plan(i, pl)
            leaf = self.handler.init_leaf_state(seed, i, pl, n_workers, device)
            for ns, v in leaf.items():
                state[ns][str(i)] = v
        return state

    @staticmethod
    def _merge_state(state: dict[str, Any], updates: dict) -> dict[str, Any]:
        new = dict(state)
        for ns, sub in updates.items():
            new[ns] = {**state.get(ns, {}), **sub}
        return new

    # ---- the wire --------------------------------------------------------
    def _make_wire(
        self,
        comm: SimComm | SymmetricWire,
        state: dict[str, Any],
        device: torch.device,
        mask: torch.Tensor | None = None,
    ) -> SymmetricWire:
        """The configured wire over ``comm`` (a wire passes through). The
        server wire draws its participation from the state's step counter,
        so the drop-out pattern varies over the run, unless the caller
        gives the round's (N,) ``mask``."""
        return as_wire(
            comm,
            topology=self.cfg.topology,
            participation=self.cfg.participation,
            agg=self.cfg.agg,
            seed=self.cfg.participation_seed,
            step=state.get("step", 0),
            mask=mask,
            device=device,
        )

    def _param_shaped_namespaces(self) -> tuple[str, ...]:
        return self.handler.param_shaped

    def _freeze_inactive(
        self, updates: dict, state: dict[str, Any], wire: SymmetricWire
    ) -> dict:
        """Server wire with drop-out: a worker that sat the round out never
        uploaded, so its own error feedback must not advance (by this
        process's rows of the round's flags). State that came out of a
        collective (warm Q, counters) is the same on every worker and
        advances for all."""
        if not isinstance(wire, ServerWire) or wire.participation >= 1.0:
            return updates
        act = wire.active()
        for ns in self._param_shaped_namespaces():
            sub = updates.get(ns)
            for k, v in (sub or {}).items():
                old = state.get(ns, {}).get(k)
                if old is not None:
                    sub[k] = torch.where(per_worker(act, v), v, old.to(v.dtype))
        return updates

    def _charge_downlink(self, rec: CommRecord, wire: SymmetricWire) -> None:
        """A server round ends with the server broadcasting the f32
        aggregate: downlink bookkeeping, apart from the uplink headline."""
        if wire.kind == "server":
            rec.add_down(32 * sum(_numel(pl.shape) for pl in self.plans))

    def _check_grads(
        self,
        leaves: list[torch.Tensor],
        n_workers: int,
        model: ModelSplit | None = None,
    ) -> None:
        if len(leaves) != len(self.plans):
            raise ValueError(f"{len(leaves)} grad leaves for {len(self.plans)} plans")
        for i, (g, pl) in enumerate(zip(leaves, self.plans)):
            shape = pl.shape if model is None else model.block_plan(i, pl).shape
            if tuple(g.shape[1:]) != tuple(shape) or g.shape[0] != n_workers:
                raise ValueError(
                    f"{pl.path}: want ({n_workers}, *{tuple(shape)}) per-worker "
                    f"grads, got {tuple(g.shape)}"
                )

    # ---- the sync op -----------------------------------------------------
    def sync(
        self,
        grads: Tree,
        state: dict[str, Any],
        comm: SimComm | SymmetricWire,
        *,
        participation_mask: torch.Tensor | None = None,
        donate: bool = False,
        model: ModelSplit | None = None,
    ) -> tuple[Tree, dict[str, Any], CommRecord]:
        """Per-worker grads (N, *shape) -> synced grads (*shape), new state
        and the round's :class:`CommRecord`. ``participation_mask``: the
        server wire's (N,) bool flags for this round, in place of its draw.
        ``model``: the gradients, error feedback and synced gradients are
        this rank's blocks over a model axis (:class:`ModelSplit`); the
        per-worker shapes checked are the blocks'.

        Functional by default, as the JAX ``sync`` is: ``state`` is left as
        it was. ``donate=True`` is the JAX step's ``donate_argnums``: the
        new state is written into the old one's memory where it can be (an
        f32 error feedback, the warm-start Q, counters) and holds the same
        tensors, so ``state`` must not be used again; the values are the
        functional sync's, bit for bit."""
        rec = CommRecord()
        leaves = tree_leaves(grads)
        wire = self._make_wire(comm, state, leaves[0].device, participation_mask)
        wire.prepare(rec)
        check_across_ranks(self, wire)
        tp = model if model is not None and model.size > 1 else None
        self._check_grads(leaves, wire.local_size(), tp)
        items = list(zip(range(len(leaves)), leaves, self.plans))
        outs, updates = self.handler.sync_group(
            items, state, wire, rec, donate=donate, model=tp
        )
        updates = self._freeze_inactive(updates, state, wire)
        self._charge_downlink(rec, wire)
        out = [outs[i] for i in range(len(leaves))]
        return (
            tree_unflatten(self._structure, out),
            self._merge_state(state, updates),
            rec,
        )

    # ---- host bookkeeping a CUDA graph leaves to the host ----------------
    def graph_refusal(self) -> str | None:
        """Why a training step over this compressor cannot be one CUDA
        graph yet, naming the ROADMAP item that lifts it; None where it
        can."""
        if self.cfg.topology != "symmetric":
            return (
                "the server wire is not captured yet (ROADMAP Queue 1, item 20, "
                "the graphed composite)"
            )
        if self.cfg.state_dtype != "float32":
            return (
                f"an error feedback stored in {self.cfg.state_dtype} is not "
                "donated, so the step cannot update it in place (ROADMAP Queue "
                "1, item 20, the graphed composite)"
            )
        return None

    def state_pspecs(
        self, state: dict[str, Any], param_pspecs: Tree, dp_axes: Any = None
    ) -> dict[str, Any]:
        """The JAX package's ``state_pspecs``: a ``launch.sharding.Spec``
        for each leaf of ``state`` WITHOUT its leading worker dim (the step
        adds it), as ``{namespace: {leaf index: spec}}``. A namespace the
        handler declares ``param_shaped`` (the error feedback) holds
        param-shaped tensors keyed by the flattened leaf index and mirrors
        that parameter's model-axis spec; every other leaf replicates (a
        Python number is a 0-dim leaf). ``dp_axes`` is the JAX signature's,
        unused: the worker dim is not part of these specs."""
        from repro_torch.launch.sharding import Spec, flatten_specs

        del dp_axes
        flat = [spec for _, spec in flatten_specs(param_pspecs)]
        param_ns = set(self._param_shaped_namespaces())

        def rep(leaf: Any) -> Any:
            return Spec(*([None] * len(getattr(leaf, "shape", ()))))

        specs: dict[str, Any] = {}
        for ns, sub in state.items():
            if ns in param_ns and isinstance(sub, dict):
                specs[ns] = {k: flat[int(k)] for k in sub}
            elif isinstance(sub, dict):
                specs[ns] = tree_map(rep, sub)
            else:
                specs[ns] = rep(sub)
        return specs

    def model_replicated_bits(self, model: ModelSplit) -> int:
        """Of a step's physical bits (``CommRecord.phys_bits``), those every
        model rank ships alike over ``model`` (each a whole copy: the
        replicated leaves, such as the norms, an MoE router and a Mamba-2
        mixer's projections, a split leaf's whole factor and its scales): so
        the ranks of one data row ship one process's physical bits plus
        ``(M - 1) * model_replicated_bits`` together."""
        return sum(
            self.handler.leaf_replicated_bits(pl, model.kind(i, pl))
            for i, pl in enumerate(self.plans)
        )

    def dist_refusal(self) -> str | None:
        """Why a sync over this compressor cannot run across ranks (a
        ``DistComm`` of world above 1), naming the ROADMAP item that lifts
        it; None where it can: every compressor the port builds syncs
        across ranks."""
        return None

    def prng_seeds(self, state: dict[str, Any]) -> dict[str, int]:
        """The seeds of this step's per-leaf generators (leaf index ->
        :func:`leaf_seed`), which a CUDA graph of the step registers and
        reseeds before each replay; none for a deterministic compressor."""
        return {}

    def next_host_state(self, state: dict[str, Any]) -> dict[str, Any]:
        """The state's host numbers (a seed, a step counter) after one sync:
        what a CUDA graph, which replays only device work, leaves to the
        host."""
        return state

    def sync_once(
        self, grads: Tree, state: dict[str, Any], *, comm: SimComm | None = None
    ) -> tuple[Tree, dict[str, Any], CommRecord]:
        """One worker's :meth:`sync`: ``grads`` without a worker dim, over a
        ``SimComm(1)`` (``comm``, or a fresh one; one with ``record=True``
        keeps the wire). The compression is still lossy: the output is the
        reconstruction an eavesdropper observes on the wire. ``state`` is the
        port's per-worker state of one worker, as ``init_state(seed, 1,
        device)`` makes it (every tensor keeps its leading worker dim of 1),
        and so is the returned state, which MUST be threaded into the next
        call for error feedback and warm-start Q to evolve as in training.
        Returns ``(synced, new_state, CommRecord)``."""
        comm = comm if comm is not None else SimComm(1)
        if comm.size() != 1:
            raise ValueError(f"sync_once runs one worker, got a comm of {comm.size()}")
        return self.sync(tree_map(lambda g: g[None], grads), state, comm)

    # ---- static accounting -----------------------------------------------
    def wire_bits_per_step(self) -> int:
        return sum(self.handler.leaf_wire_bits(pl) for pl in self.plans)

    def physical_bits_by_method(self) -> dict[str, int]:
        return {
            self.method: sum(self.handler.leaf_physical_bits(pl) for pl in self.plans)
        }

    def privacy_epsilon_per_step(self, delta: float = 1e-5) -> float:
        """Per-step DP epsilon under basic composition over every leaf's
        transmissions; ``inf`` as soon as ANY leaf ships deterministically.
        Compose across steps with :mod:`repro_torch.core.privacy.accounting`."""
        return sum(self.handler.leaf_epsilon(pl, delta) for pl in self.plans)

    def privacy_epsilon_kinds(self) -> tuple[str, ...]:
        """The kinds of the leaves' epsilon claims, sorted, each once."""
        kinds = {self.handler.leaf_epsilon_kind(pl) for pl in self.plans}
        return tuple(sorted(k for k in kinds if k))

    def privacy_budget(
        self, steps: int, *, delta: float = 1e-5, sampling_rate: float = 1.0
    ):
        """End-of-training :class:`~repro_torch.core.privacy.accounting.
        TrainingBudget` for a ``steps``-step run of this compressor."""
        from repro_torch.core.privacy.accounting import compose_training

        return compose_training(
            self.privacy_epsilon_per_step(delta),
            steps,
            delta=delta,
            sampling_rate=sampling_rate,
        )


class NoCompression(GradCompressor):
    """Vanilla distributed SGD: full-precision all-reduce (paper 'Original SGD')."""


class TopKCompressor(GradCompressor):
    """TopK-SGD driven over the whole tree; see :class:`TopKHandler`."""

    method = "topk"
    handler_cls = TopKHandler


class QSGDCompressor(GradCompressor):
    """QSGD baseline driven over the whole tree; see :class:`QSGDHandler`."""

    method = "qsgd"
    handler_cls = QSGDHandler

    def init_state(
        self, seed: int, n_workers: int, device="cuda", model=None
    ) -> dict[str, Any]:
        return {"key": int(seed), "step": 0}

    def sync(self, grads, state, comm, **kw):
        out, new_state, rec = super().sync(grads, state, comm, **kw)
        return out, self.next_host_state(new_state), rec

    def prng_seeds(self, state: dict[str, Any]) -> dict[str, int]:
        return {
            str(i): leaf_seed(state["key"], state["step"], i)
            for i, pl in enumerate(self.plans)
            if pl.route == "lowrank"
        }

    def next_host_state(self, state: dict[str, Any]) -> dict[str, Any]:
        # advance the stream: without it every sync redraws the same rounding
        return {**state, "step": state["step"] + 1}


def make_compressor(
    cfg: CompressorConfig, abstract_grads: Tree, stacked: Tree | None = None
) -> GradCompressor:
    # local imports avoid a cycle (powersgd/lq_sgd import this module)
    from repro_torch.core.lq_sgd import LQSGDCompressor
    from repro_torch.core.powersgd import PowerSGDCompressor

    if cfg.topology not in ("symmetric", "server"):
        raise ValueError(
            f"unknown topology {cfg.topology!r}; options: 'symmetric', 'server'"
        )
    # server drop-out needs the composite: it owns the step counter the
    # participation draw folds in and the per-worker state freezing
    server_dropout = cfg.topology == "server" and cfg.participation < 1.0
    # randomized codecs need the composite too: it owns the state's key
    # seed and step counter the per-(leaf, phase) generators derive from
    randomized = cfg.dp_epsilon > 0 or cfg.codec is not None
    if (
        cfg.policy not in (None, "uniform")
        or cfg.warmup_steps
        or cfg.schedule_decay
        or cfg.lazy_thresh > 0
        or server_dropout
        or randomized
    ):
        from repro_torch.core.composite import CompositeCompressor, PolicySchedule
        from repro_torch.core.policy import plan_auto, resolve_policies

        report = None
        if cfg.policy == "auto":
            # plan once; keep the report so a launcher prints the plan in force
            policies, report = plan_auto(abstract_grads, stacked, cfg=cfg)
        else:
            policies = resolve_policies(cfg, abstract_grads, stacked)
        schedule = PolicySchedule(
            warmup_steps=cfg.warmup_steps, decay=cfg.schedule_decay
        )
        comp = CompositeCompressor(
            cfg, abstract_grads, stacked, policies=policies, schedule=schedule
        )
        comp.plan_report = report
        return comp
    registry: dict[str, type[GradCompressor]] = {
        "none": NoCompression,
        "sgd": NoCompression,
        "topk": TopKCompressor,
        "qsgd": QSGDCompressor,
        "powersgd": PowerSGDCompressor,
        "lq_sgd": LQSGDCompressor,
    }
    if cfg.name not in registry:
        raise ValueError(
            f"unknown compressor {cfg.name!r}; options: {sorted(registry)}"
        )
    return registry[cfg.name](cfg, abstract_grads, stacked)
