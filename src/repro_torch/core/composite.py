"""Per-leaf compression policies: the composite compressor and schedules.

The paper's Algorithm 1 applies one ``(rank, b_p, b_q)`` setting to every
gradient tensor. :class:`CompositeCompressor` gives each leaf its own
:class:`~repro_torch.core.compressors.LeafPolicy`, groups leaves by method,
and drives each group through the SAME leaf-group handler the dedicated
compressors drive: one (fused) codec phase set per method and wire dtype a
step. A uniform-policy composite is therefore the dedicated compressor bit
for bit.

State: the handlers' namespaces (``err``, warm-start ``q``) merge into one
dict keyed by the global leaf index, with the composite's own ``step``
counter (a Python int, as QSGD's is: it seeds the generators of QSGD, of the
randomized codecs and of the server wire's participation draw) and a
``key`` seed where some group draws (``group_needs_prng``: QSGD, or an
LQ-SGD group with a ``dlog`` / ``lrq`` leaf). Per-worker tensors lead with
the worker dim, as everywhere in the port: the k workers a process holds
(all N with one process). Every process builds the same groups, plans and
schedule phases and makes the same draws, so the composite syncs across
ranks as one process does.

Schedules (:class:`PolicySchedule`):

* ``warmup_steps W``: while ``state['step'] < W`` every lossy leaf's output
  is the exact f32 mean (taken locally over a gather, off the accounted
  wire: the same bits at any world size) and its error feedback is held at
  zero. The
  compressed path still runs, so warm-start Q advances as in the JAX
  package. ``boundaries()`` includes W; the training loop rebuilds there
  with ``at_step(W)``, which drops the warm-up machinery.
* ``decay``: piecewise-constant ``(start_step, rank_cap, bits_cap)`` caps,
  applied by rebuilding at each boundary (``at_step``) and carrying the
  state across (``adapt_state``: error feedback kept, warm Q truncated).

Lazy aggregation (:mod:`repro_torch.core.lazy`): leaves whose policy sets
``lazy_thresh > 0`` form each method group's lazy subset, with one skip
decision a subset a step. On a skip the subset applies its cached
aggregate and no state advances but the staleness counter. Two dispatch
modes, bit-identical in every output and state tensor:

* ``cfg.lazy_mode = "elide"``: a Python branch on the decision, read on
  the host once per lazy group and step. A skipped round issues none of
  the group's kernels or gathers; only the decision psum remains.
* ``"gate"``: the group runs every round and ``torch.where`` selects on the
  device; no host read, so a captured step can hold it.

The accounting of a fired round is static, from the plans and handlers,
and is charged through ``CommRecord.add_gated`` on the decision.

Server topology (:mod:`repro_torch.core.wire`, ``cfg.topology='server'``):
each worker tests its OWN innovation (:func:`~repro_torch.core.lazy.
worker_decision`). A worker that does not contribute (no fire, or out of
the round) feeds the handler the reference the server holds for it, so the
handler's collectives run every round on substituted inputs; a one-flag
contribution mask is gathered, and its mean gates the byte accounting.
Per-worker state (``err``, ``lazy_ref``, ``lazy_stale``) freezes unless the
worker contributed; collective-derived state (warm Q, the drift EMA)
advances every round. There is no ``lazy_out`` cache on the server wire.

Over a ``(data, model)`` mesh of M > 1 (``sync(..., model=)``, a
``compressors.ModelSplit``) each rank holds its block of every split leaf's
gradient and of its param-shaped state (``err``, ``lazy_out``,
``lazy_ref``: :meth:`state_pspecs`, the JAX package's), while the plans,
policies and schedule phases are the whole leaves', as one process makes
them. Every group's handler syncs the blocks (``model=``), the warm-up's
exact mean and the server's freezes act on them elementwise, and the lazy
statistics and drift of a split leaf are summed over the model axis before
any decision (``core/lazy.py:model_sum``), so every rank of the mesh fires
alike. The server wire's flags are indexed by data row, so every model rank
of a row acts on its row's flags.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Sequence
from typing import Any

import torch

from repro_torch.core import lazy as lazy_mod
from repro_torch.core.comm import CommRecord, SimComm
from repro_torch.core.compressors import (
    CompressorConfig,
    GradCompressor,
    LeafGroupHandler,
    LeafPolicy,
    QSGDHandler,
    TopKHandler,
    _numel,
    build_plans,
    check_across_ranks,
    per_worker,
    state_dtype,
)
from repro_torch.core.tree import Tree, flatten_with_paths, tree_leaves, tree_unflatten
from repro_torch.core.wire import PARTICIPATION_FLAG_BITS, SymmetricWire

__all__ = ["CompositeCompressor", "PolicySchedule", "handler_for"]


def handler_for(method: str, cfg: CompressorConfig) -> LeafGroupHandler:
    """Handler registry: one leaf-group handler instance per policy method."""
    from repro_torch.core.lq_sgd import LQSGDHandler
    from repro_torch.core.powersgd import PowerSGDHandler

    registry = {
        "raw": LeafGroupHandler,
        "topk": TopKHandler,
        "qsgd": QSGDHandler,
        "powersgd": PowerSGDHandler,
        "lq_sgd": LQSGDHandler,
    }
    if method not in registry:
        raise ValueError(
            f"unknown policy method {method!r}; options: {sorted(registry)}"
        )
    return registry[method](cfg)


@dataclasses.dataclass(frozen=True)
class PolicySchedule:
    """Step-indexed policy switching (module docstring)."""

    warmup_steps: int = 0
    decay: tuple[tuple[int, int | None, int | None], ...] = ()

    def boundaries(self) -> list[int]:
        """Steps at which the training loop rebuilds the compressor: every
        decay start, and the end of warm-up."""
        b = {int(s) for s, _, _ in self.decay}
        if self.warmup_steps > 0:
            b.add(int(self.warmup_steps))
        return sorted(b)

    def policy_at(self, step: int, pol: LeafPolicy) -> LeafPolicy:
        """The policy in force at ``step`` after every decay cap whose start
        has passed. Caps clamp, never raise."""
        rank, bits, bits_q = pol.rank, pol.bits, pol.bits_q
        for s, rank_cap, bits_cap in sorted(self.decay):
            if step < s:
                break
            if rank_cap is not None:
                rank = min(rank, int(rank_cap))
            if bits_cap is not None:
                bits = min(bits, int(bits_cap))
                if bits_q is not None:
                    bits_q = min(bits_q, int(bits_cap))
        if (rank, bits, bits_q) == (pol.rank, pol.bits, pol.bits_q):
            return pol
        return dataclasses.replace(pol, rank=rank, bits=bits, bits_q=bits_q)


def _as_gate_would(v: torch.Tensor, old: torch.Tensor | None, ns: str, k: str):
    """A fired elide round's update ``v`` of state ``old``, in the dtype
    ``torch.where`` gives it in gate mode. A skip keeps ``old``, so every
    update needs one."""
    if old is None:
        raise ValueError(
            f"lazy_mode='elide' needs every handler update to have a cached "
            f"slot for the skip branch; {ns!r} key {k!r} is not in the state "
            f"(use lazy_mode='gate' for this handler)"
        )
    return v.to(torch.promote_types(v.dtype, old.dtype))


class CompositeCompressor(GradCompressor):
    """Per-leaf policy compressor: groups leaves by method, drives one
    handler per group and merges the state namespaces (module docstring)."""

    # the auto-planner's report rows when make_compressor planned this one
    plan_report: list[dict] | None = None

    def __init__(
        self,
        cfg: CompressorConfig,
        abstract_grads: Tree,
        stacked: Tree | None = None,
        *,
        policies: Sequence[LeafPolicy] | Callable[[str, Any], LeafPolicy],
        schedule: PolicySchedule | None = None,
    ):
        if cfg.lazy_mode not in ("elide", "gate"):
            raise ValueError(
                f"unknown lazy_mode {cfg.lazy_mode!r}; options: 'elide', 'gate'"
            )
        self.cfg = cfg
        self._structure = abstract_grads
        self._stacked = stacked
        if callable(policies):
            flat = flatten_with_paths(abstract_grads)
            policies = [policies(path, leaf) for path, leaf in flat]
        self.policies = list(policies)
        self.plans = build_plans(
            abstract_grads,
            cfg.rank,
            cfg.min_compress_numel,
            stacked,
            policies=self.policies,
        )
        self.schedule = schedule or PolicySchedule()
        # leaf groups in flatten order; handlers in first-occurrence order
        self.groups: dict[str, list[int]] = {}
        for i, pl in enumerate(self.plans):
            self.groups.setdefault(pl.policy.method, []).append(i)
        self.handlers = {m: handler_for(m, cfg) for m in self.groups}
        # per-group lazy subsets (policy opt-in; empty == fully eager)
        self.lazy_groups = {
            m: lz
            for m, idxs in self.groups.items()
            if (lz := lazy_mod.lazy_subset(self.plans, idxs))
        }

    # ---- state -----------------------------------------------------------
    def init_state(
        self, seed: int, n_workers: int, device="cuda", model=None
    ) -> dict[str, Any]:
        """The composite's state: see the module doc; with ``model`` (a
        ``ModelSplit``) the param-shaped tensors are this rank's blocks."""
        plans = self.plans
        if model is not None:
            plans = [model.block_plan(i, pl) for i, pl in enumerate(plans)]
        state: dict[str, Any] = {"step": 0}
        for m, h in self.handlers.items():
            for ns in h.namespaces:
                state.setdefault(ns, {})
            # per group: a randomized codec may reach only some leaves
            if h.group_needs_prng([self.plans[i] for i in self.groups[m]]):
                state.setdefault("key", int(seed))
        for m, idxs in self.groups.items():
            h = self.handlers[m]
            for i in idxs:
                leaf = h.init_leaf_state(seed, i, plans[i], n_workers, device)
                for ns, v in leaf.items():
                    state[ns][str(i)] = v
        # ---- lazy aggregation ---------------------------------------------
        # the server wire has no group skip, hence no cached aggregate: a
        # stale worker's cache is its reference (lazy_ref)
        sd = state_dtype(self.cfg)
        server = self.cfg.topology == "server"
        for m, lz in self.lazy_groups.items():
            if not server:
                state.setdefault(lazy_mod.OUT_NS, {})
            state.setdefault(lazy_mod.REF_NS, {})
            state.setdefault(lazy_mod.STALE_NS, {})
            for i in lz:
                shape = plans[i].shape
                if not server:
                    out = torch.zeros(shape, dtype=sd, device=device)
                    state[lazy_mod.OUT_NS][str(i)] = out
                ref = torch.zeros((n_workers,) + shape, dtype=sd, device=device)
                state[lazy_mod.REF_NS][str(i)] = ref
            # the counter starts AT the cap: round 0 always fires, so the
            # cached aggregate is never applied before it exists
            cap = lazy_mod.group_max_stale(self.plans, lz)
            stale_shape = (n_workers,) if server else ()
            state[lazy_mod.STALE_NS][m] = torch.full(
                stale_shape, cap, dtype=torch.int32, device=device
            )
            if lazy_mod.group_adaptive_cap(self.plans, lz) > 0:
                ema = torch.zeros(2, dtype=torch.float32, device=device)
                state.setdefault(lazy_mod.EMA_NS, {})[m] = ema
        return state

    def privacy_epsilon_per_step(self, delta: float = 1e-5) -> float:
        return sum(
            self.handlers[pl.policy.method].leaf_epsilon(pl, delta)
            for pl in self.plans
        )

    def privacy_epsilon_kinds(self) -> tuple[str, ...]:
        kinds = {
            self.handlers[pl.policy.method].leaf_epsilon_kind(pl) for pl in self.plans
        }
        return tuple(sorted(k for k in kinds if k))

    def _has_err(self, i: int, state: dict[str, Any]) -> bool:
        """Does leaf ``i`` carry error feedback? (Its innovation variable is
        then the error-corrected update ``g + err``.)"""
        h = self.handlers[self.plans[i].policy.method]
        return "err" in h.namespaces and str(i) in state.get("err", {})

    def _param_shaped_namespaces(self) -> tuple[str, ...]:
        out: list[str] = []
        for h in self.handlers.values():
            out += [ns for ns in h.param_shaped if ns not in out]
        if self.lazy_groups:
            out += lazy_mod.PARAM_SHAPED_NS
        return tuple(out)

    # ---- the sync op -----------------------------------------------------
    def _lossy(self, pl) -> bool:
        """Does this leaf's sync lose information against the exact f32
        mean? (lq_sgd quantizes its raw-route leaves too.)"""
        if pl.policy.method == "raw":
            return False
        return pl.route == "lowrank" or pl.policy.method == "lq_sgd"

    def graph_refusal(self) -> str | None:
        # groups that draw because of their leaves' codecs (not QSGD's own)
        drawing = [
            m
            for m, h in self.handlers.items()
            if not h.needs_prng
            and h.group_needs_prng([self.plans[i] for i in self.groups[m]])
        ]
        if drawing:
            return (
                f"the randomized codecs (dlog, lrq) of the {', '.join(drawing)} "
                "group draw from per-(leaf, phase) generators that no graph "
                "registers yet (ROADMAP Queue 1, item 20, the graphed composite)"
            )
        return (
            "the composite compressor's lazy groups, server participation "
            "draw and schedules are not captured yet (ROADMAP Queue 1, item "
            "20, the graphed composite)"
        )

    def sync(
        self,
        grads: Tree,
        state: dict[str, Any],
        comm: SimComm | SymmetricWire,
        *,
        participation_mask: torch.Tensor | None = None,
        donate: bool = False,
        model: Any = None,
    ) -> tuple[Tree, dict[str, Any], CommRecord]:
        """As :meth:`GradCompressor.sync`, but always functional: the lazy
        and warm-up paths read the old error feedback after the groups'
        syncs, so ``donate`` is taken for the step's interface and the
        state is not donated yet (ROADMAP item 20, the graphed composite).
        ``model``: the gradients and param-shaped state are this rank's
        blocks over a model axis (module doc)."""
        del donate
        rec = CommRecord()
        leaves = tree_leaves(grads)
        wire = self._make_wire(comm, state, leaves[0].device, participation_mask)
        # the participation sideband is gathered (and charged) once a round
        check_across_ranks(self, wire)
        wire.prepare(rec)
        tp = model if model is not None and model.size > 1 else None
        self._check_grads(leaves, wire.local_size(), tp)
        server = wire.kind == "server"
        outs: dict[int, torch.Tensor] = {}
        updates: dict[str, dict] = {}
        warmup = self.schedule.warmup_steps
        warm = state["step"] < warmup if warmup > 0 else None
        for m, idxs in self.groups.items():
            lz = set(self.lazy_groups.get(m, ()))
            parts = []
            eager = [i for i in idxs if i not in lz]
            if eager:
                items = [(i, leaves[i], self.plans[i]) for i in eager]
                h = self.handlers[m]
                parts.append(h.sync_group(items, state, wire, rec, model=tp))
            if lz:
                sync_lazy = self._sync_lazy_server if server else self._sync_lazy
                lazy_idxs = self.lazy_groups[m]
                parts.append(
                    sync_lazy(m, lazy_idxs, leaves, state, wire, rec, warm, tp)
                )
            for o, upd in parts:
                outs.update(o)
                for ns, sub in upd.items():
                    updates.setdefault(ns, {}).update(sub)
        # ---- schedule: full-precision warm-up ----------------------------
        if warm:
            for i, pl in enumerate(self.plans):
                if self._lossy(pl):
                    g = leaves[i]
                    outs[i] = wire.exact_mean(g.float()).to(g.dtype)
            # hold error feedback at zero while warm: the compressed path's
            # residual was never applied, so recycling it would inject a
            # phantom correction at step W
            for k, v in updates.get("err", {}).items():
                updates["err"][k] = torch.zeros_like(v)
        updates = self._freeze_inactive(updates, state, wire)
        self._charge_downlink(rec, wire)
        new_state = self._merge_state(state, updates)
        new_state["step"] = state["step"] + 1
        out = [outs[i] for i in range(len(leaves))]
        return tree_unflatten(self._structure, out), new_state, rec

    def _lazy_inputs(self, idxs, leaves, state):
        """Each lazy leaf's innovation variable x, the update compression
        would see (``g + err`` for an error-feedback leaf), and its error
        feedback (None without one)."""
        xs, errs = [], []
        for i in idxs:
            x = leaves[i].float()
            e = state["err"][str(i)].float() if self._has_err(i, state) else None
            xs.append(x if e is None else x + e)
            errs.append(e)
        return xs, errs

    def _tau_scale2(self, m, idxs, state):
        cap = lazy_mod.group_adaptive_cap(self.plans, idxs)
        if cap <= 0:
            return None
        return lazy_mod.tau_scale2(state[lazy_mod.EMA_NS][m], cap)

    def _model_stats(self, idxs, model) -> dict[str, Any]:
        """The lazy decisions' model-axis arguments for leaves ``idxs``."""
        if model is None:
            return {}
        return {"model": model.comm, "split": [model.dims[i] is not None for i in idxs]}

    def _drift(self, idxs, outs, model) -> torch.Tensor:
        """The squared magnitude of a group's applied aggregate, each split
        leaf's block sum completed over the model axis."""
        parts = [outs[j].float().square().sum() for j in range(len(idxs))]
        if model is not None:
            split = [model.dims[i] is not None for i in idxs]
            parts = lazy_mod.model_sum(parts, split, model.comm, "tp.lazy.drift")
        return sum(parts)

    def _fired_accounting(self, m: str, idxs: list[int]) -> tuple[int, int]:
        """The bits and collectives the group's handler sync charges on a
        fired round: static, from the plans and the handler."""
        h, plans = self.handlers[m], [self.plans[i] for i in idxs]
        return sum(h.leaf_wire_bits(pl) for pl in plans), h.group_collectives(plans)

    def _sync_lazy(self, m, idxs, leaves, state, comm, rec, warm, model=None):
        """One method group's lazy subset on the symmetric wire: the
        collective skip decision, the handler sync dispatched on it, and the
        cached aggregate on a skip (LAQ-faithful: a skipped round's gradient
        is neither applied nor banked, and only ``lazy_stale`` advances)."""
        sd = state_dtype(self.cfg)
        h = self.handlers[m]
        xs, _ = self._lazy_inputs(idxs, leaves, state)
        ref = {str(i): state[lazy_mod.REF_NS][str(i)] for i in idxs}
        dec = lazy_mod.group_decision(
            xs,
            list(ref.values()),
            [self.plans[i].policy.lazy_thresh for i in idxs],
            state[lazy_mod.STALE_NS][m],
            lazy_mod.group_max_stale(self.plans, idxs),
            comm,
            rec,
            force=warm,
            tau_scale2=self._tau_scale2(m, idxs, state),
            **self._model_stats(idxs, model),
        )
        items = [(i, leaves[i], self.plans[i]) for i in idxs]
        cached = {i: state[lazy_mod.OUT_NS][str(i)] for i in idxs}
        if self.cfg.lazy_mode == "gate":
            sub = CommRecord()
            o, upd = h.sync_group(items, state, comm, sub, model=model)
            rec.add_gated(sub.bits_sent, sub.n_collectives, dec.fire)
            rec.add_phys(sub.phys_bits)  # the group shipped, whatever fired
            # handler state advances only on a fired round
            for ns, subd in upd.items():
                for k in subd:
                    if k in state.get(ns, {}):
                        subd[k] = dec.select(subd[k], state[ns][k])
            sel_outs = [dec.select(o[i].float(), cached[i].float()) for i in idxs]
        else:
            bits, n = self._fired_accounting(m, idxs)
            rec.add_gated(bits, n, dec.fire)
            if bool(dec.fire):  # the one host read of the decision
                sub = CommRecord()
                o, upd = h.sync_group(items, state, comm, sub, model=model)
                rec.add_phys(sub.phys_bits)
                for ns, subd in upd.items():
                    for k, v in subd.items():
                        subd[k] = _as_gate_would(v, state.get(ns, {}).get(k), ns, k)
                sel_outs = [o[i].float() for i in idxs]
            else:  # skipped: no kernel, no gather; only the counter moves
                outs = {i: c.float().to(leaves[i].dtype) for i, c in cached.items()}
                return outs, {lazy_mod.STALE_NS: {m: dec.new_stale}}
        outs, new_out, new_ref = {}, {}, {}
        for i, x, sel in zip(idxs, xs, sel_outs):
            k = str(i)
            outs[i] = sel.to(leaves[i].dtype)
            new_out[k] = sel.to(sd)
            new_ref[k] = dec.select(x, ref[k].float()).to(sd)
        upd[lazy_mod.OUT_NS] = new_out
        upd[lazy_mod.REF_NS] = new_ref
        upd[lazy_mod.STALE_NS] = {m: dec.new_stale}
        if lazy_mod.group_adaptive_cap(self.plans, idxs) > 0:
            # drift: the squared magnitude of the applied aggregate
            drift = self._drift(idxs, sel_outs, model)
            ema = lazy_mod.ema_update(state[lazy_mod.EMA_NS][m], drift, dec.fire)
            upd[lazy_mod.EMA_NS] = {m: ema}
        return outs, upd

    def _sync_lazy_server(self, m, idxs, leaves, state, wire, rec, warm, model=None):
        """One method group's lazy subset on the server wire: a per-worker
        decision, substitution of what the server already holds for a
        worker that does not contribute, and the handler's collectives
        every round (module docstring). ``lazy_stale`` resets on
        contribution, not on fire: a dropped-out worker's fire never
        reached the server."""
        sd = state_dtype(self.cfg)
        h = self.handlers[m]
        xs, errs = self._lazy_inputs(idxs, leaves, state)
        dec = lazy_mod.worker_decision(
            xs,
            [state[lazy_mod.REF_NS][str(i)] for i in idxs],
            [self.plans[i].policy.lazy_thresh for i in idxs],
            state[lazy_mod.STALE_NS][m],
            lazy_mod.group_max_stale(self.plans, idxs),
            force=warm,
            tau_scale2=self._tau_scale2(m, idxs, state),
            **self._model_stats(idxs, model),
        )
        contrib = dec.fire & wire.active()
        # the server learns who shipped fresh payload: one f32 flag a worker
        flags = wire.all_gather(contrib.float())
        rec.add(lazy_mod.SERVER_DECISION_BITS_PER_GROUP, 1)
        p_round = flags.mean()
        items = []
        for i, e in zip(idxs, errs):
            # a worker that does not contribute feeds what the server holds
            # for it, ``ref - err``, so the handler's ``g + err`` rebuilds ref
            sub = state[lazy_mod.REF_NS][str(i)].float()
            sub = sub if e is None else sub - e
            g_eff = torch.where(per_worker(contrib, sub), leaves[i].float(), sub)
            items.append((i, g_eff, self.plans[i]))
        sub_rec = CommRecord()
        o, upd = h.sync_group(items, state, wire, sub_rec, model=model)
        rec.add(0, sub_rec.n_collectives)
        rec.add_phys(sub_rec.phys_bits)
        rec.add_gated(sub_rec.bits_sent, 0, p_round)
        # per-worker namespaces freeze for non-contributors
        for ns, subd in upd.items():
            if ns not in h.param_shaped:
                continue
            for k, v in subd.items():
                old = state.get(ns, {}).get(k)
                if old is not None:
                    subd[k] = torch.where(per_worker(contrib, v), v, old.to(v.dtype))
        outs, new_ref = {}, {}
        for i, x in zip(idxs, xs):
            k = str(i)
            outs[i] = o[i].to(leaves[i].dtype)
            ref = state[lazy_mod.REF_NS][k].float()
            new_ref[k] = torch.where(per_worker(contrib, x), x, ref).to(sd)
        upd[lazy_mod.REF_NS] = new_ref
        stale = dec.stale
        upd[lazy_mod.STALE_NS] = {
            m: torch.where(contrib, torch.zeros_like(stale), stale + 1)
        }
        if lazy_mod.group_adaptive_cap(self.plans, idxs) > 0:
            # the aggregate refreshes every server round, and so does the EMA
            drift = self._drift(idxs, [o[i] for i in idxs], model)
            fire = torch.ones((), dtype=torch.bool, device=p_round.device)
            ema = lazy_mod.ema_update(state[lazy_mod.EMA_NS][m], drift, fire)
            upd[lazy_mod.EMA_NS] = {m: ema}
        return outs, upd

    # ---- static accounting -----------------------------------------------
    def _group_decision_bits(self, lz: list[int]) -> int:
        """One lazy group's decision sideband: the innovation psum (64 a leaf
        and the force slot), or on the server wire the contribution flag."""
        if self.cfg.topology == "server":
            return lazy_mod.SERVER_DECISION_BITS_PER_GROUP
        return (
            lazy_mod.DECISION_BITS_PER_LEAF * len(lz)
            + lazy_mod.DECISION_BITS_PER_GROUP
        )

    def model_replicated_bits(self, model: Any, skipped: Sequence[str] = ()) -> int:
        """:meth:`GradCompressor.model_replicated_bits` over every group's
        handler, but the lazy groups in ``skipped``, which an elided round
        did not ship."""
        return sum(
            self.handlers[pl.policy.method].leaf_replicated_bits(pl, model.kind(i, pl))
            for i, pl in enumerate(self.plans)
            if not any(i in self.lazy_groups.get(m, ()) for m in skipped)
        )

    def decision_bits_per_step(self) -> int:
        """The skip-decision sideband, sent every round."""
        return sum(self._group_decision_bits(lz) for lz in self.lazy_groups.values())

    def wire_bits_per_step(self) -> int:
        """Wire bits of a round where every group fires: the eager figure
        plus the decision sideband."""
        return (
            sum(
                self.handlers[pl.policy.method].leaf_wire_bits(pl)
                for pl in self.plans
            )
            + self.decision_bits_per_step()
        )

    def group_p_fire(self, m: str, innovation_rate: float = 0.25) -> float:
        """Static fire-probability proxy of method group ``m``'s lazy subset
        (1.0 without one); the tightest member threshold dominates."""
        lz = self.lazy_groups.get(m)
        if not lz:
            return 1.0
        thresh = min(self.plans[i].policy.lazy_thresh for i in lz)
        return lazy_mod.p_fire(
            thresh, lazy_mod.group_max_stale(self.plans, lz), innovation_rate
        )

    def expected_wire_bits_per_step(self, innovation_rate: float = 0.25) -> float:
        """The planner model's expectation: eager leaves in full, each lazy
        subset at its ``p_fire``, the decision sideband always; on the
        server wire every payload scaled by the participation rate, plus
        the participation flag."""
        server = self.cfg.topology == "server"
        part = self.cfg.participation if server else 1.0
        total = float(self.decision_bits_per_step())
        if server and part < 1.0:
            total += float(PARTICIPATION_FLAG_BITS)
        for i, pl in enumerate(self.plans):
            m = pl.policy.method
            p = (
                self.group_p_fire(m, innovation_rate)
                if i in self.lazy_groups.get(m, ())
                else 1.0
            )
            total += p * part * self.handlers[m].leaf_wire_bits(pl)
        return total

    def warmup_extra_bits(self) -> int:
        """The f32 traffic of a warm step's exact mean beside the compressed
        wire (not charged to the CommRecord); 0 when W == 0."""
        if self.schedule.warmup_steps <= 0:
            return 0
        return sum(_numel(pl.shape) * 32 for pl in self.plans if self._lossy(pl))

    def _bits_by_method(self, leaf_bits) -> dict[str, int]:
        out: dict[str, int] = {}
        for pl in self.plans:
            m = pl.policy.method
            out[m] = out.get(m, 0) + leaf_bits(self.handlers[m], pl)
        for m, lz in self.lazy_groups.items():
            out[m] = out.get(m, 0) + self._group_decision_bits(lz)
        return out

    def wire_bits_by_method(self) -> dict[str, int]:
        """Static wire accounting per policy method; a lazy group's decision
        sideband goes to its method, so the split sums to
        ``wire_bits_per_step``."""
        return self._bits_by_method(lambda h, pl: h.leaf_wire_bits(pl))

    def physical_bits_by_method(self) -> dict[str, int]:
        """Per-method bits a round where every group fires moves (operand
        sizes, not the semantic wire); the decision psum is physically the
        (2n + 1,) f32 vector its accounting charges."""
        return self._bits_by_method(lambda h, pl: h.leaf_physical_bits(pl))

    # ---- schedule phases -------------------------------------------------
    def at_step(self, step: int) -> CompositeCompressor:
        """The composite in force for the schedule phase containing
        ``step``: decay caps applied, and the warm-up dropped once
        ``step >= W``. ``self`` when nothing changes."""
        pols = [self.schedule.policy_at(step, p) for p in self.policies]
        sched = self.schedule
        if sched.warmup_steps and step >= sched.warmup_steps:
            sched = dataclasses.replace(sched, warmup_steps=0)
        if pols == self.policies and sched == self.schedule:
            return self
        return CompositeCompressor(
            self.cfg, self._structure, self._stacked, policies=pols, schedule=sched
        )

    def adapt_state(self, state: dict[str, Any]) -> dict[str, Any]:
        """Carry the state across a phase boundary: error feedback and
        counters as they are; warm-start Q truncated to the new rank."""
        new = dict(state)
        if "q" in state:
            new["q"] = {
                k: v[..., : self.plans[int(k)].eff_rank] for k, v in state["q"].items()
            }
        return new
