"""Lazy aggregation: LAQ-style skip rounds over leaf groups.

LAQ (Sun et al. 2019, "Lazily Aggregated Quantized Gradients") skips a
worker's upload whenever its gradient *innovation*, the change since the
last round it communicated, is small, and reuses the stale aggregate. On
the symmetric wire there is no server, so the decision is collective:
every worker reads the same all-reduced innovation statistics, and a whole
method group of the :class:`~repro_torch.core.composite.CompositeCompressor`
either fires its collectives or applies its cached aggregate.

The criterion, per lazy leaf ``i`` with threshold ``tau_i``:

    x_i     = g_i + residual_i          # what compression would see
    innov_i = sum_workers ||x_i - ref_i||^2
    vote_i  = innov_i > tau_i^2 * sum_workers ||x_i||^2

where ``ref_i`` is ``x_i`` at the group's last fired round. The group
fires when any leaf votes, when ``stale >= max_stale`` or during warm-up.
All statistics ship in ONE psum of a (2n + 1,) f32 vector a worker, the
last slot carrying the force votes (64 bits a leaf + 32 a group, one
collective, charged statically every round), so ``fire`` is a function of
one reduced vector: the same on every worker by construction. The psum is
taken as a gather and a local sum in global worker order, so the vector,
and with it ``fire``, is the same bits however the workers are spread over
processes (an f32 all-reduce would sum in the ring's order).

On a skipped round nothing advances but the staleness counter: every
worker applies the cached aggregate, and the round's gradient is neither
applied nor banked into the error feedback. A fired round is the eager
round exactly.

Adaptive thresholds (``lazy_adaptive`` > 0, a cap): each group tracks an
EMA of its applied aggregate's squared magnitude and scales every squared
threshold by ``clip(peak / ema, 1, cap)``, so the skip rate ramps up as
the run converges.

On the server wire each worker decides alone (:func:`worker_decision`):
no collective, an (N,) decision, and only a one-flag contribution mask is
gathered.

Over a model axis (a ``(data, model)`` mesh) a rank holds a block of each
split leaf: its innovation and norm, and the adaptive drift, are partial
sums, which :func:`model_sum` completes over the model axis in rank order
(one all-gather a group, ``tp.lazy.stats`` / ``tp.lazy.drift``) before the
data-axis gather. Every rank of the mesh then computes the same ``fire``,
so no model rank issues a group's collectives while its neighbour skips
them.

State the composite adds (port layout: per-worker tensors lead with N):

    lazy_out[i]   cached synced aggregate, (*shape), the same on every worker
                  (no worker dim)
    lazy_ref[i]   x at the last fired round, (k, *shape)
    lazy_stale[m] skips in a row per method group: 0-dim int32 on the
                  symmetric wire, (k,) on the server wire; born AT the cap
    lazy_ema[m]   the adaptive drift tracker [ema, peak], (2,) f32

(k the workers a process holds: N with one process.) ``lazy_ref`` and the
server wire's ``lazy_stale`` are per-worker rows; the rest is shared, and
``lazy_out`` and ``lazy_ema`` (:data:`SHARED_NS`) carry no worker dim.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence
from typing import Any

import torch

from repro_torch.core.comm import CommRecord
from repro_torch.core.compressors import LeafPlan

__all__ = [
    "ADAPTIVE_BETA",
    "DECISION_BITS_PER_GROUP",
    "DECISION_BITS_PER_LEAF",
    "SERVER_DECISION_BITS_PER_GROUP",
    "LazyDecision",
    "ema_update",
    "group_adaptive_cap",
    "group_decision",
    "group_max_stale",
    "lazy_subset",
    "model_sum",
    "p_fire",
    "staleness_err",
    "tau_scale2",
    "worker_decision",
]

# innovation + norm, f32 each, per lazy leaf on the decision psum
DECISION_BITS_PER_LEAF = 64
# one f32 slot per group carrying the force votes (staleness cap, warm-up)
DECISION_BITS_PER_GROUP = 32
# server wire: the test is local; each worker ships one f32 contribution
# flag a group so the server knows who sent fresh payload
SERVER_DECISION_BITS_PER_GROUP = 32

# namespaces the lazy machinery adds to the composite state
OUT_NS, REF_NS, STALE_NS = "lazy_out", "lazy_ref", "lazy_stale"
EMA_NS = "lazy_ema"
PARAM_SHAPED_NS = (OUT_NS, REF_NS)
# the namespaces whose tensors carry no leading worker dim
SHARED_NS = (OUT_NS, EMA_NS)

# adaptive-LAQ drift tracker smoothing (per fired round)
ADAPTIVE_BETA = 0.9


def lazy_subset(plans: Sequence[LeafPlan], idxs: Sequence[int]) -> list[int]:
    """The lazily aggregated members of a method group (policy opt-in)."""
    return [i for i in idxs if plans[i].policy.lazy_thresh > 0]


def group_max_stale(plans: Sequence[LeafPlan], idxs: Sequence[int]) -> int:
    """The group's staleness cap: the tightest of its members' caps."""
    return min(plans[i].policy.max_stale for i in idxs)


def group_adaptive_cap(plans: Sequence[LeafPlan], idxs: Sequence[int]) -> float:
    """The group's adaptive cap: the tightest of its members' opted-in caps
    (0.0 = no member opted in, fixed thresholds)."""
    caps = [
        plans[i].policy.lazy_adaptive
        for i in idxs
        if plans[i].policy.lazy_adaptive > 0
    ]
    return min(caps) if caps else 0.0


def tau_scale2(ema: torch.Tensor, cap: float) -> torch.Tensor:
    """The squared-threshold scale ``clip(peak / ema, 1, cap)`` from the
    drift tracker ``[ema, peak]``; 1 before the first fired round."""
    e, peak = ema[0], ema[1]
    ratio = torch.where(e > 0, peak / torch.clamp(e, min=1e-30), 1.0)
    return torch.clamp(ratio, 1.0, cap)


def ema_update(
    ema: torch.Tensor, drift: torch.Tensor, fire: torch.Tensor
) -> torch.Tensor:
    """Advance ``[ema, peak]`` on a fired round (frozen on a skip). ``peak``
    is the running maximum of the smoothed drift."""
    e, peak = ema[0], ema[1]
    d = drift.float()
    new_e = torch.where(peak <= 0, d, ADAPTIVE_BETA * e + (1 - ADAPTIVE_BETA) * d)
    new_peak = torch.maximum(peak, new_e)
    return torch.where(fire, torch.stack([new_e, new_peak]), ema)


@dataclasses.dataclass
class LazyDecision:
    """One group's fire/skip decision for this round, on the device."""

    fire: torch.Tensor  # bool: 0-dim (symmetric) or (N,) (server)
    stale: torch.Tensor  # skips in a row BEFORE this round
    new_stale: torch.Tensor  # after: 0 on fire, +1 on skip

    def select(self, fresh: torch.Tensor, cached: torch.Tensor) -> torch.Tensor:
        fire = self.fire
        if fire.dim():  # one flag a worker, over the (N, ...) layout
            fire = fire.reshape(fire.shape + (1,) * (fresh.dim() - 1))
        return torch.where(fire, fresh, cached)


def model_sum(
    parts: Sequence[torch.Tensor], split: Sequence[bool], comm: Any, tag: str
) -> list[torch.Tensor]:
    """``parts`` (one a leaf, of one shape) with each split leaf's part, a
    block's partial sum, summed over the model axis ``comm`` (a
    ``ModelComm``; None: no axis) in rank order: one all-gather of them and
    a local sum, so every model rank holds the same bits. A whole leaf's
    part is the same on every rank and kept."""
    idx = [j for j, s in enumerate(split) if s]
    if comm is None or comm.size == 1 or not idx:
        return list(parts)
    mine = torch.stack([parts[j] for j in idx])[None]
    whole = comm.all_gather(mine, 0, tag).sum(0)
    out = list(parts)
    for j, v in zip(idx, whole.unbind(0)):
        out[j] = v
    return out


def _stats(xs, refs, split, model) -> tuple[list, list]:
    """Each leaf's per-worker innovation and norm, (k,) each, whole over a
    model axis (:func:`model_sum`)."""
    parts = [
        torch.stack([_sq_per_worker(x - r.float()), _sq_per_worker(x)])
        for x, r in zip(xs, refs)
    ]
    split = split if split is not None else [False] * len(parts)
    parts = model_sum(parts, split, model, "tp.lazy.stats")
    return [p[0] for p in parts], [p[1] for p in parts]


def _sq_per_worker(x: torch.Tensor) -> torch.Tensor:
    """Each worker's sum of squares of a (N, ...) tensor, (N,)."""
    return x.square().reshape(x.shape[0], -1).sum(1)


def _taus(threshs: Sequence[float], scale2, device) -> torch.Tensor:
    taus = torch.tensor([t * t for t in threshs], dtype=torch.float32, device=device)
    return taus if scale2 is None else taus * scale2


def _forced(stale, max_stale, force) -> torch.Tensor:
    forced = stale >= max_stale
    return forced if force is None else forced | force


def group_decision(
    xs: Sequence[torch.Tensor],
    refs: Sequence[torch.Tensor],
    threshs: Sequence[float],
    stale: torch.Tensor,
    max_stale: int,
    comm,
    rec: CommRecord,
    *,
    force: bool | torch.Tensor | None = None,
    tau_scale2: torch.Tensor | None = None,
    model: Any = None,
    split: Sequence[bool] | None = None,
) -> LazyDecision:
    """The collective skip test of one leaf group.

    ``xs`` are the (k, ...) error-corrected updates compression would see,
    ``refs`` the per-worker references of the last fired round, ``stale``
    the group's 0-dim counter. The staleness-cap and warm-up (``force``)
    votes ride the same psum as the statistics, so ``fire`` (a 0-dim bool
    tensor) is one value for all workers. The psum is a gather of every
    worker's statistics and a local sum over them in worker order (module
    doc). Charges the psum (64 bits a leaf + 32, one collective) to
    ``rec``'s static tier. ``tau_scale2`` scales every squared threshold
    (adaptive LAQ). ``model`` (a ``ModelComm``): ``xs[j]`` is a block where
    ``split[j]``, and its statistics are summed over the axis first."""
    n, n_workers = len(xs), xs[0].shape[0]
    innov, norms = _stats(xs, refs, split, model)
    forced = _forced(stale, max_stale, force)
    votes_in = forced.float().expand(n_workers)
    stats = comm.gather(torch.stack(innov + norms + [votes_in], dim=1)).sum(0)
    rec.add(DECISION_BITS_PER_LEAF * n + DECISION_BITS_PER_GROUP, 1)
    taus = _taus(threshs, tau_scale2, stats.device)
    votes = stats[:n] > taus * stats[n : 2 * n]
    fire = votes.any() | (stats[2 * n] > 0)
    new_stale = torch.where(fire, torch.zeros_like(stale), stale + 1)
    return LazyDecision(fire=fire, stale=stale, new_stale=new_stale)


def worker_decision(
    xs: Sequence[torch.Tensor],
    refs: Sequence[torch.Tensor],
    threshs: Sequence[float],
    stale: torch.Tensor,
    max_stale: int,
    *,
    force: bool | torch.Tensor | None = None,
    tau_scale2: torch.Tensor | None = None,
    model: Any = None,
    split: Sequence[bool] | None = None,
) -> LazyDecision:
    """The per-worker skip test of one leaf group on the server wire: each
    worker compares its own innovation with its own norm, with no
    data-axis collective. ``stale`` is the (k,) counter of this process's
    workers; ``fire`` a (k,) bool tensor, which may differ between workers.
    ``model`` and ``split`` as :func:`group_decision`'s: a worker's model
    ranks decide alike."""
    innov, norms = _stats(xs, refs, split, model)
    innov, norms = torch.stack(innov, 1), torch.stack(norms, 1)
    taus = _taus(threshs, tau_scale2, innov.device)
    fire = (innov > taus * norms).any(1) | _forced(stale, max_stale, force)
    new_stale = torch.where(fire, torch.zeros_like(stale), stale + 1)
    return LazyDecision(fire=fire, stale=stale, new_stale=new_stale)


# --------------------------------------------------------------------------
# the planner's static skip model (core/policy.py)
# --------------------------------------------------------------------------


def p_fire(lazy_thresh: float, max_stale: int, innovation_rate: float = 0.25) -> float:
    """Static fire-probability proxy: with a constant per-round relative
    innovation ``rho``, ``min(1, (rho / tau)^2)``, never below the
    staleness cap's floor ``1 / (max_stale + 1)``; 1 when eager."""
    if lazy_thresh <= 0:
        return 1.0
    floor = 1.0 / (max_stale + 1)
    return max(floor, min(1.0, (innovation_rate / lazy_thresh) ** 2))


def staleness_err(
    lazy_thresh: float, max_stale: int, innovation_rate: float = 0.25
) -> float:
    """Error-proxy penalty of acting on a stale aggregate: the forfeited
    innovation (bounded by the threshold) times the skip rate, halved."""
    p = p_fire(lazy_thresh, max_stale, innovation_rate)
    return 0.5 * min(lazy_thresh, 1.0) * (1.0 - p)
