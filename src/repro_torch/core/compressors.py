"""Gradient-compressor framework + the paper's non-low-rank baselines.

A compressor replaces the data-parallel gradient all-reduce:

    comp  = make_compressor(cfg, abstract_grads, stacked=...)
    state = comp.init_state(seed, n_workers, device)    # E, warm Q, counters
    g_bar, state, rec = comp.sync(grads, state, comm)   # comm: SimComm

Every per-worker tensor carries the workers as its leading dim: the grads
and the error feedback E are (N, *shape), the warm-start Q (N, m, r). The
synced gradients come back without it, since every worker holds the same
values after a sync, as the JAX package's vmap'd workers do.

Per-leaf routing: each leaf gets a :class:`LeafPlan` from its shape. Small
or 1-D tensors (biases, norms) take the raw path ("rank-1 tensors are
aggregated uncompressed", as in PowerSGD's reference implementation); the
rest take the method's path. Leaves are numbered in JAX flatten order
(:mod:`repro_torch.core.tree`): the number names the state keys, seeds the
warm-start Q and orders the fused buffers.

The method math lives in :class:`LeafGroupHandler` subclasses; a compressor
drives one handler over every leaf. The JAX package's composite routes
(per-leaf policies, warm-up, lazy aggregation, the server wire, the
randomized privacy codecs) are not ported yet: asking for one raises,
naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable, Iterable
from typing import Any

import numpy as np
import torch

from repro_torch.core.comm import CommRecord, SimComm
from repro_torch.core.low_rank import matricize_shape
from repro_torch.core.tree import Tree, flatten_with_paths, tree_leaves, tree_unflatten
from repro_torch.core.wire import SymmetricWire, as_wire

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
    "POLICY_METHODS",
]

# every method a LeafPolicy may name; 'raw' is the uncompressed f32 pmean
POLICY_METHODS = ("raw", "topk", "qsgd", "powersgd", "lq_sgd")


@dataclasses.dataclass(frozen=True)
class CompressorConfig:
    """Config shared by all compressors.

    The last six fields select the JAX package's composite routes. Only
    their defaults are ported: any other value makes :func:`make_compressor`
    raise, naming the ROADMAP item that ports the route."""

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
    # ---- composite routes (not ported yet) -------------------------------
    policy: str | None = None
    warmup_steps: int = 0
    lazy_thresh: float = 0.0
    topology: str = "symmetric"
    codec: str | None = None
    dp_epsilon: float = 0.0


@dataclasses.dataclass(frozen=True)
class LeafPolicy:
    """Per-tensor compression decision: which method ships this leaf, and
    with what knobs. Dedicated compressors use one uniform policy."""

    method: str = "lq_sgd"  # one of POLICY_METHODS
    rank: int = 1
    bits: int = 8
    bits_q: int | None = None  # factor-Q wire bits; None -> same as bits
    topk_ratio: float = 0.01

    def __post_init__(self):
        if self.method not in POLICY_METHODS:
            raise ValueError(
                f"unknown policy method {self.method!r}; options: {POLICY_METHODS}"
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
) -> tuple[LeafPlan, ...]:
    """One LeafPlan per leaf (anything with ``.shape`` and ``.dtype``), in
    JAX flatten order, under one uniform ``policy`` (by default powersgd at
    ``rank``)."""
    flat = flatten_with_paths(abstract_grads)
    if stacked is None:
        stacked_leaves = [False] * len(flat)
    else:
        stacked_leaves = tree_leaves(stacked)
        if len(stacked_leaves) != len(flat):
            raise ValueError("`stacked` tree does not match grads structure")
    policy = policy or LeafPolicy(method="powersgd", rank=rank)
    return tuple(
        _leaf_plan(path, leaf, policy, min_numel, bool(st))
        for (path, leaf), st in zip(flat, stacked_leaves)
    )


def leaf_generator(seed: int, step: int, leaf: int, device) -> torch.Generator:
    """The generator of one leaf at one step, derived from the state's seed
    (the counterpart of ``fold_in(fold_in(key, step), leaf)``: the port's
    own stream, mixed by numpy's SeedSequence)."""
    mixed = np.random.SeedSequence([seed, step, leaf]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(mixed[0]) >> 1)


def _pmean_raw(
    g: torch.Tensor, comm: SimComm | SymmetricWire, rec: CommRecord
) -> torch.Tensor:
    rec.add(g[0].numel() * 32, 1)  # f32 wire, ring all-reduce payload ~ numel
    return comm.pmean(g.float()).to(g.dtype)


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
    {str(i): new per-worker leaf state}."""

    method = "raw"
    namespaces: tuple[str, ...] = ()

    def __init__(self, cfg: CompressorConfig):
        self.cfg = cfg

    # ---- per-leaf state ---------------------------------------------------
    def init_leaf_state(
        self, seed: int, i: int, pl: LeafPlan, n_workers: int, device
    ) -> dict[str, torch.Tensor]:
        return {}

    # ---- the group sync ---------------------------------------------------
    def sync_raw(
        self, g: torch.Tensor, pl: LeafPlan, comm: SymmetricWire, rec: CommRecord
    ) -> torch.Tensor:
        return _pmean_raw(g, comm, rec)

    def sync_group(self, items, state, comm, rec):
        return {i: self.sync_raw(g, pl, comm, rec) for i, g, pl in items}, {}

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


class TopKHandler(LeafGroupHandler):
    """TopK-SGD with error feedback: keep each worker's top-k entries by
    magnitude of the error-corrected gradient, zero the rest; the dense
    masked tensor is averaged (the dense simulation of a sparse all-reduce)
    while the accounting charges k * (32-bit value + ceil(log2(numel))-bit
    index) per worker."""

    method = "topk"
    namespaces = ("err",)

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
        return {"err": torch.zeros((n_workers,) + pl.shape, device=device)}

    def sync_group(self, items, state, comm, rec):
        from repro_torch.core.codec import codec_phase, make_codec

        outs: dict[int, torch.Tensor] = {}
        new_err: dict[str, torch.Tensor] = {}
        comp, kepts, account = [], [], []
        for i, g, pl in items:
            if pl.route != "lowrank":
                outs[i] = self.sync_raw(g, pl, comm, rec)
                continue
            flat = (g.float() + state["err"][str(i)].float()).reshape(g.shape[0], -1)
            k = self._k(flat.shape[1], pl.policy.topk_ratio)
            idx = torch.topk(flat.abs(), k, dim=1).indices
            kept = flat * torch.zeros_like(flat).scatter_(1, idx, 1.0)
            new_err[str(i)] = (flat - kept).reshape(g.shape)
            comp.append((i, g, pl))
            kepts.append(kept.reshape(g.shape))
            account.append(k * (32 + self.index_bits(flat.shape[1])))
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


class QSGDHandler(LeafGroupHandler):
    """QSGD (Alistarh et al. 2017): stochastic uniform quantization, with one
    generator per leaf and step derived from the state's ``key`` seed and
    ``step`` counter (:func:`leaf_generator`)."""

    method = "qsgd"

    def _codec(self, bits: int):
        from repro_torch.core.codec import make_codec

        return make_codec("qsgd", bits=bits)

    def sync_group(self, items, state, comm, rec):
        from repro_torch.core.codec import codec_phase

        outs: dict[int, torch.Tensor] = {}
        comp = []
        for i, g, pl in items:
            if pl.route != "lowrank":
                outs[i] = self.sync_raw(g, pl, comm, rec)
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
                keys=[
                    leaf_generator(state["key"], state["step"], i, g.device)
                    for i, g, _ in sub
                ],
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
    def init_state(self, seed: int, n_workers: int, device="cuda") -> dict[str, Any]:
        """Per-worker state: every tensor has the leading worker dim."""
        state: dict[str, Any] = {ns: {} for ns in self.handler.namespaces}
        for i, pl in enumerate(self.plans):
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

    # ---- the sync op -----------------------------------------------------
    def sync(
        self, grads: Tree, state: dict[str, Any], comm: SimComm | SymmetricWire
    ) -> tuple[Tree, dict[str, Any], CommRecord]:
        """Per-worker grads (N, *shape) -> synced grads (*shape), new state
        and the round's :class:`CommRecord`."""
        rec = CommRecord()
        wire = as_wire(comm)
        wire.prepare(rec)
        leaves = tree_leaves(grads)
        if len(leaves) != len(self.plans):
            raise ValueError(f"{len(leaves)} grad leaves for {len(self.plans)} plans")
        for g, pl in zip(leaves, self.plans):
            if tuple(g.shape[1:]) != pl.shape or g.shape[0] != wire.size():
                raise ValueError(
                    f"{pl.path}: want ({wire.size()}, *{pl.shape}) per-worker "
                    f"grads, got {tuple(g.shape)}"
                )
        items = list(zip(range(len(leaves)), leaves, self.plans))
        outs, updates = self.handler.sync_group(items, state, wire, rec)
        out = [outs[i] for i in range(len(leaves))]
        return (
            tree_unflatten(self._structure, out),
            self._merge_state(state, updates),
            rec,
        )

    # ---- static accounting -----------------------------------------------
    def wire_bits_per_step(self) -> int:
        return sum(self.handler.leaf_wire_bits(pl) for pl in self.plans)

    def physical_bits_by_method(self) -> dict[str, int]:
        return {
            self.method: sum(self.handler.leaf_physical_bits(pl) for pl in self.plans)
        }


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

    def init_state(self, seed: int, n_workers: int, device="cuda") -> dict[str, Any]:
        return {"key": int(seed), "step": 0}

    def sync(self, grads, state, comm):
        out, new_state, rec = super().sync(grads, state, comm)
        # advance the stream: without it every sync redraws the same rounding
        return out, {**new_state, "step": state["step"] + 1}, rec


# composite route -> (config test, where the port of the route is planned)
_NOT_PORTED = (
    ("per-leaf policies", lambda c: c.policy not in (None, "uniform"), "item 10"),
    ("warm-up", lambda c: c.warmup_steps > 0, "item 10"),
    ("lazy aggregation", lambda c: c.lazy_thresh > 0, "item 11"),
    ("the server wire", lambda c: c.topology != "symmetric", "item 12"),
    ("randomized codecs", lambda c: c.codec is not None or c.dp_epsilon > 0, "item 13"),
)


def make_compressor(
    cfg: CompressorConfig, abstract_grads: Tree, stacked: Tree | None = None
) -> GradCompressor:
    # local imports avoid a cycle (powersgd/lq_sgd import this module)
    from repro_torch.core.lq_sgd import LQSGDCompressor
    from repro_torch.core.powersgd import PowerSGDCompressor

    for what, asked, item in _NOT_PORTED:
        if asked(cfg):
            raise NotImplementedError(
                f"{what} (the JAX package's composite compressor) is not ported "
                f"yet: ROADMAP Queue 1, {item}"
            )
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
