"""Mixture-of-Experts FFN with capacity-table dispatch (the JAX package's
``models/moe.py``).

Routing and dispatch are two steps here. :func:`route` takes the router:
logits in f32, softmax, the top k experts of each token (ties to the lower
index, as ``jax.lax.top_k`` orders them: a stable descending sort over the
E experts), their probabilities renormalised over the k, and the Switch
load-balance loss ``E * sum(mean(probs) * hits / (T * k))``. Given choices
(another run's, or the JAX package's), it keeps them and takes the weights
and the loss from its own probabilities. :func:`tables` (the JAX package's
``_dispatch_tables``) and the combine are deterministic in the choices:
assignments sorted by expert with a stable argsort, each one's rank within
its expert, an (E, C) table of token ids with T as the sentinel, ranks at
or past the capacity C (:func:`moe_capacity`) dropped.

Every step has a fixed shape and reads nothing on the host, so a CUDA graph
can hold it: hits are counted by a one-hot sum, the table is written by a
scatter with a distinct index for every assignment (a dropped one lands past
the table's end and is cut off), and the combine is a gather: each token
collects its k contributions in f32, in choice order, where the JAX
package scatter-adds them into a (T + 1, D) buffer. For k = 2 both sum two
terms onto zero, so they agree bit for bit and neither depends on the order
of atomics. The dispatch and the collect are each other's transposes (an
assignment and its table slot), so each is a gather in the backward too
(:class:`_SlotGather`). The expert products are ``torch.bmm``: the JAX
package computes them with ``einsum``, outside any Pallas kernel.

``moe_impl`` "global" routes all B*S tokens through one table, "batched"
each row through its own (capacity from S). The JAX package's
``_moe_constraint`` only pins the dispatch tensors to a TPU mesh's axes;
on one card it has nothing to do and is left out.

:func:`routing` records every MoE call's choices and router logits in call
order, or holds each call to given choices, so a comparison run (reference
mode) can route as the kernel run did.

Over a model axis (:func:`moe_forward`'s ``tp``) the experts split as the
JAX rules split them, each rank running its experts' slots of the same
table; the router runs on the layer's input as one process does, so the
load-balance loss is charged once.
"""

from __future__ import annotations

import contextlib
from collections.abc import Iterator
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.comm import copy_to_model, partial_product
from repro_torch.models.common import act_fn, dense_init
from repro_torch.models.mlp import init_mlp, mlp_forward

__all__ = [
    "moe_capacity",
    "init_moe",
    "route",
    "route_probs",
    "tables",
    "moe_forward",
    "routing",
    "Routing",
]

Params = dict[str, Any]


def moe_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: ``n_tokens * k / E * capacity_factor``, truncated,
    rounded up to a multiple of 8, at least 8."""
    c = int(n_tokens * cfg.experts_per_token / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def init_moe(
    gen: torch.Generator,
    cfg: ModelConfig,
    device,
    dtype: torch.dtype = torch.float32,
) -> Params:
    """The router and shared expert in f32; each (E, ., .) expert stack
    cast to ``dtype`` as soon as it is drawn, the same values as a cast
    after the init: at deepseek-v3's 256 experts a stack is 15 GB in f32,
    and three at once would not leave room on one card."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    p: Params = {
        "router": dense_init(gen, (d, e), device=device),
        "w_gate": dense_init(gen, (e, d, f), in_dim=d, device=device).to(dtype),
        "w_up": dense_init(gen, (e, d, f), in_dim=d, device=device).to(dtype),
        "w_down": dense_init(gen, (e, f, d), in_dim=f, device=device).to(dtype),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, d, f * cfg.n_shared_experts, device)
    return p


class Routing:
    """What :func:`routing` records (``calls``: per MoE call, its choices
    (R, T, k) and router logits (R, T, E) in f32) and, when ``held``, the
    choices each call in turn must take."""

    def __init__(self, held: list[torch.Tensor] | None = None):
        self.held = held
        self.calls: list[tuple[torch.Tensor, torch.Tensor]] = []

    def take(self) -> torch.Tensor | None:
        i = len(self.calls)
        if self.held is None:
            return None
        if i >= len(self.held):
            raise RuntimeError(f"routing holds {len(self.held)} calls, not {i + 1}")
        return self.held[i]

    def record(self, top_i: torch.Tensor, logits: torch.Tensor) -> None:
        self.calls.append((top_i.detach(), logits.detach()))

    @property
    def choices(self) -> list[torch.Tensor]:
        return [c for c, _ in self.calls]


_ACTIVE: list[Routing] = []


@contextlib.contextmanager
def routing(held: list[torch.Tensor] | None = None) -> Iterator[Routing]:
    """Record every MoE call's routing in this context; with ``held``, the
    choices of another run's calls in the same order, route each call as
    that run did (weights and loss from this run's own probabilities). The
    records are eager: a CUDA-graph replay runs no Python."""
    rec = Routing(held)
    _ACTIVE.append(rec)
    try:
        yield rec
    finally:
        _ACTIVE.remove(rec)


def route(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    choices: torch.Tensor | None = None,
    *,
    hits_first: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (R, T, D): R token sets of T -> (top_i (R, T, k) int64, weights
    (R, T, k) f32, aux (R,) f32, router logits (R, T, E) f32); see
    :func:`route_probs`."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    return (*route_probs(probs, cfg, choices, hits_first=hits_first), logits)


def route_probs(
    probs: torch.Tensor,
    cfg: ModelConfig,
    choices: torch.Tensor | None = None,
    *,
    hits_first: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router probabilities (R, T, E) -> (top_i, weights, aux). ``choices``
    (R, T, k) are kept as the top_i. The loss rounds as the JAX package's
    does: ``me * (hits / (T k))`` with ``hits_first`` (its global path),
    ``(me * hits) / (T k)`` without (its batched path)."""
    e, k = cfg.n_experts, cfg.experts_per_token
    if choices is None:
        top_i = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]
    else:
        top_i = choices.to(device=probs.device, dtype=torch.long)
    top_p = probs.gather(-1, top_i)
    weights = top_p / top_p.sum(-1, keepdim=True)
    t = probs.shape[1]
    # the mean over tokens as a contiguous sum / T: the order in which XLA's
    # CPU reduction adds a short row (a strided torch.mean adds otherwise)
    me = probs.transpose(1, 2).contiguous().sum(dim=-1) / t
    hits = _expert_counts(top_i.flatten(1), e).float()
    if hits_first:
        aux = e * torch.sum(me * (hits / (t * k)), dim=-1)
    else:
        aux = e * torch.sum(me * hits / (t * k), dim=-1)
    return top_i, weights, aux


def _expert_counts(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """(R, N) expert ids -> (R, E) counts, by a one-hot sum (no host read)."""
    experts = torch.arange(e, device=flat_e.device)
    return (flat_e[..., None] == experts).sum(dim=-2)


def _slots(top_i: torch.Tensor, e: int, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each assignment's table slot and each slot's assignment, per token set.

    top_i (R, T, k) -> (slot_of (R, T*k): e * cap + rank, or E*cap where the
    rank is past the capacity; assign_of (R, E*cap): the assignment t*k + j
    in that slot, or T*k where the slot is empty)."""
    r, t, k = top_i.shape
    n = t * k
    flat_e = top_i.reshape(r, n)
    order = torch.sort(flat_e, dim=-1, stable=True).indices
    sorted_e = flat_e.gather(-1, order)
    counts = _expert_counts(flat_e, e)
    starts = torch.cumsum(counts, dim=-1) - counts
    rank = torch.arange(n, device=top_i.device) - starts.gather(-1, sorted_e)
    kept = rank < cap
    # a distinct target for every assignment: a kept one its slot, a dropped
    # one a place past the table's E * cap slots, cut off below
    slot = sorted_e * cap + rank
    past = e * cap + torch.arange(n, device=top_i.device)
    assign = torch.full((r, e * cap + n), n, dtype=torch.long, device=top_i.device)
    assign.scatter_(-1, torch.where(kept, slot, past), order)
    assign_of = assign[:, : e * cap]
    slot = torch.where(kept, slot, torch.full_like(rank, e * cap))
    slot_of = torch.empty_like(slot).scatter_(-1, order, slot)
    return slot_of, assign_of


def tables(
    top_i: torch.Tensor, weights: torch.Tensor, cfg: ModelConfig, cap: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The capacity tables of R token sets from their choices and weights
    (R, T, k): (table (R, E, cap) of token ids, T where empty; wtab (R, E,
    cap) f32, the weight of each slot's assignment, 0 where empty)."""
    r, t, k = top_i.shape
    e = cfg.n_experts
    _, assign_of = _slots(top_i, e, cap)
    table = torch.where(assign_of < t * k, assign_of // k, t)
    w_pad = torch.cat([weights.reshape(r, t * k), weights.new_zeros(r, 1)], dim=1)
    wtab = w_pad.gather(1, assign_of)
    return table.reshape(r, e, cap), wtab.reshape(r, e, cap)


class _SlotGather(torch.autograd.Function):
    """``out[i] = src[index[i]]`` over rows, with row ``len(src)`` a zero row,
    where ``index`` hits every row of src at most once and ``inverse`` is
    its inverse (``len(out)`` where a row of src is not hit): the backward is
    the gather ``grad_src[j] = grad_out[inverse[j]]``, so no row is summed
    into by atomics."""

    @staticmethod
    def forward(ctx, src, index, inverse):
        ctx.save_for_backward(inverse)
        return _gather_rows(src, index)

    @staticmethod
    def backward(ctx, grad):
        (inverse,) = ctx.saved_tensors
        return _gather_rows(grad, inverse), None, None


def _gather_rows(src: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """src (R, N, D), index (R, M) in [0, N] -> (R, M, D), index N a zero row."""
    pad = torch.cat([src, src.new_zeros(src.shape[0], 1, src.shape[2])], dim=1)
    return pad.gather(1, index[..., None].expand(-1, -1, src.shape[2]))


def _moe_sets(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    act: str,
    hits_first: bool,
    data: Any = None,
    first: int = 0,
    split: Any = None,
    xe: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """x (R, T, D), R token sets of T, each with its own table -> (y in f32,
    aux (R,)). ``p``'s expert stacks may hold a block of E / M experts
    (``first`` .. ``first + E / M - 1``): the slots of the others' experts
    then come back zero. ``data`` (a ``core.comm.ModelComm``): the token
    sets are this rank's rows of sets split over its group, and each
    table is built from every rank's choices, gathered in rank order.
    ``split`` (a ``core.comm.ModelComm``, where the experts split over it):
    the router runs on ``x`` as it is, so the load-balance loss and its
    gradient are one process's on every rank, and the experts on ``xe``,
    the caller's ``copy_to_model`` of it; the combine weights pass a
    ``copy_to_model`` too (``tp.moe.w``), as each rank's gradient of them
    is its experts' part."""
    r, t, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    e_loc = p["w_gate"].shape[0]
    rec = _ACTIVE[-1] if _ACTIVE else None
    held = rec.take() if rec is not None else None
    top_i, weights, aux, logits = route(p, x, cfg, held, hits_first=hits_first)
    if rec is not None:
        rec.record(top_i, logits)
    if xe is not None:
        x = xe
    if split is not None:
        weights = copy_to_model(weights, split, "tp.moe.w")
    off = 0
    if data is not None and data.size > 1:
        off = data.rank * t
        top_i = data.all_gather(top_i, 1, "tp.moe.route")
    cap = moe_capacity(top_i.shape[1], cfg)
    slot_of, assign_of = _slots(top_i, e, cap)
    # this rank's slots and its tokens' assignments, in local numbering: an
    # assignment of another rank's token reads the zero row, a slot of
    # another rank's expert gives zero
    assign_of = assign_of[:, first * cap : (first + e_loc) * cap] - off * k
    assign_of = torch.where((assign_of >= 0) & (assign_of < t * k), assign_of, t * k)
    slot_of = slot_of[:, off * k : (off + t) * k] - first * cap
    slot_of = torch.where((slot_of >= 0) & (slot_of < e_loc * cap), slot_of, e_loc * cap)
    # dispatch: each slot's token, as the gather of its assignment's copy
    x_rep = x.repeat_interleave(k, dim=1)  # (R, T*k, D), assignment t*k + j
    xin = _SlotGather.apply(x_rep, assign_of, slot_of)  # (R, E*cap, D)
    xin = xin.reshape(r, e_loc, cap, d).transpose(0, 1).reshape(e_loc, r * cap, d)
    g = act_fn(act)(torch.bmm(xin, p["w_gate"].to(x.dtype)))
    u = torch.bmm(xin, p["w_up"].to(x.dtype))
    y_e = torch.bmm(g * u, p["w_down"].to(x.dtype))  # (E, R*cap, D)
    y_e = y_e.reshape(e_loc, r, cap, d).transpose(0, 1).reshape(r, e_loc * cap, d)
    # combine: every assignment collects its slot's output (zero if dropped)
    got = _SlotGather.apply(y_e, slot_of, assign_of).reshape(r, t, k, d)
    contrib = got.float() * weights[..., None]
    y = contrib[:, :, 0]
    for j in range(1, k):
        y = y + contrib[:, :, j]
    return y, aux


def moe_forward(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    act: str = "silu",
    *,
    tp: Any = None,
    pspec: Params | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y, the load-balance loss, f32 0-dim). "global" routes
    the B*S tokens through one table; "batched" each row through its own,
    the loss then the mean over rows.

    Expert-parallel (``tp``, a ``core.comm.ModelAxis``, with the layer's
    FFN specs ``pspec``): a rank holds the experts its ``w_gate`` / ``w_up``
    / ``w_down`` block gives it (E / M of them where E divides the model
    axis, else all) and the replicated router, so every model rank routes
    the same tokens alike and runs only its experts' slots; the shared
    expert splits as a dense MLP does. The partial sums of what splits
    (the routed combine, the shared expert's ``down``) go through one f32
    all-reduce over the model axis, each rounded to ``x``'s dtype after it
    as one process rounds them. The split parts take a ``copy_to_model``
    of ``x`` (``tp.moe.in``), the router and what does not split take
    ``x`` itself (:func:`_moe_sets`), so every replicated leaf of the FFN
    (the router, an expert stack or shared expert the axis does not split)
    receives its whole gradient on every rank. Where the batch's rows
    split over the data axis (``tp.data``, serving), the global table is
    built from every row's choices (``tp.moe.route``: a gather of the (T,
    k) expert ids), so a rank drops what one process drops; the
    load-balance loss is then over the rank's rows (serving discards it).
    A training step's ``ModelAxis`` has no data comm: each worker routes
    its own rows through its own table, as the JAX step's workers do."""
    b, s, d = x.shape
    e_split = pspec is not None and pspec["w_gate"][0] is not None
    sh_split = pspec is not None and "shared" in pspec
    sh_split = sh_split and pspec["shared"]["down"][0] is not None
    first = tp.comm.rank * p["w_gate"].shape[0] if e_split else 0
    split = tp.comm if e_split else None
    xc = x
    if e_split or sh_split:
        xc = copy_to_model(x, tp.comm, "tp.moe.in")
    xe = xc if e_split else None
    if cfg.moe_impl == "batched":
        y, aux = _moe_sets(p, x, cfg, act, False, first=first, split=split, xe=xe)
    elif cfg.moe_impl == "global":
        data = tp.data if tp is not None else None
        flat = x.reshape(1, b * s, d)
        xe = None if xe is None else xe.reshape(1, b * s, d)
        y, aux = _moe_sets(p, flat, cfg, act, True, data, first, split, xe)
        y = y.reshape(b, s, d)
    else:
        raise ValueError(f"moe_impl {cfg.moe_impl!r}: 'global' or 'batched'")
    shared = None
    if cfg.n_shared_experts:
        if sh_split:
            sp = p["shared"]
            h = act_fn(act)(xc @ sp["gate"].to(x.dtype)) * (xc @ sp["up"].to(x.dtype))
            shared = partial_product(h, sp["down"].to(x.dtype))
        else:
            shared = mlp_forward(p["shared"], x, act)
    if e_split and sh_split:
        both = tp.comm.all_reduce(torch.stack([y, shared]), "tp.moe.out")
        return both[0].to(x.dtype) + both[1].to(x.dtype), aux.mean()
    if e_split:
        y = tp.comm.all_reduce(y, "tp.moe.out")
    elif sh_split:
        shared = tp.comm.all_reduce(shared, "tp.moe.out")
    y = y.to(x.dtype)
    if shared is not None:
        y = y + shared.to(x.dtype)
    return y, aux.mean()
