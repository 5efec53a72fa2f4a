"""PowerSGD (Vogels et al., NeurIPS 2019), the paper's primary baseline.

Warm-started single power iteration with error feedback:

    G' = G + E ;  P = G'Q ;  allreduce(P) ;  P^ = orth(P)
    Q  = G'^T P^ ;  allreduce(Q) ;  G^ = P^ Q^T ;  E = G' - G^

:class:`PowerSGDHandler` ships both factor phases through
:func:`repro_torch.core.codec.codec_phase` with the f32 codec; LQ-SGD
subclasses it and swaps in the b-bit log-quant codec: the control flow is
shared, only the codec differs. A stacked (L, n, m) leaf is compressed per
layer, which is per-layer PowerSGD in an unrolled network.

Per worker (leading dim N): G, E and G' are (N, [L,] n, m), Q is (N, [L,]
m, r) and identical on every worker (it comes from the same seed and then
from a collective), so mean_i(G_i' Q) = mean(G') Q makes the P all-reduce
exact in expectation; E stays per worker; after the sync every worker holds
the same G^, returned once.

Over a model axis (``model``, a ``compressors.ModelSplit``) a rank holds a
block of a split leaf's G and E, and the whole warm-start Q:

* a column-split G (n, m/M): P = G Q_block is a partial, summed over the
  model axis in f32, so P is whole and the same on every model rank, which
  each orthonormalizes alike; Q = G^T P^ is the rank's block of rows,
  quantized on the model-wide scale, and after the Q phase the blocks are
  gathered over the model axis into the next warm-start Q;
* a row-split G (n/M, m): P is the rank's block of rows, quantized on the
  model-wide scale and orthonormalized with its dot products and norms
  summed over the model axis (``low_rank.orthonormalize_split``); Q =
  G_block^T P^_block is a partial, summed over the model axis. A leaf cut
  on any dim but its last is row-split so: an MoE expert stack (E, D, F)
  cut on E, matricized (E*D, F), holds E/M experts' rows; a (cb, V, d)
  codebook table cut on V holds a block of every codebook's rows.

A factor whole on every model rank is quantized and shipped over the data
axis by each model rank alike. Each product is taken one worker at a time,
as in one process. The model-axis sums of a phase go in one all-reduce.
"""

from __future__ import annotations

import torch

from repro_torch.core.codec import WireCodec, codec_phase, make_codec
from repro_torch.core.compressors import (
    PHASE_STREAMS,
    GradCompressor,
    LeafGroupHandler,
    LeafPlan,
    _group_by,
    _numel,
    donates,
    error_corrected,
    leaf_generator,
    state_dtype,
)
from repro_torch.core.low_rank import (
    _sum_parts,
    matricize_shape,
    orthonormalize,
    orthonormalize_split,
    power_iter_p,
    power_iter_q,
    reconstruct,
)

__all__ = ["PowerSGDCompressor", "PowerSGDHandler"]


def _instance_shape(pl: LeafPlan) -> tuple[int, ...]:
    """A leaf's matricized shape, (L, n, m) for a stack of L layers."""
    return ((pl.shape[0],) if pl.stacked else ()) + pl.mat_shape


def _gather_parts(parts: list[torch.Tensor], comm) -> list[torch.Tensor]:
    """Each (..., m/M, r) block of ``parts`` gathered over ``comm`` into the
    whole (..., m, r), rank-major on the row dim, in one all-gather."""
    flat = torch.cat([p.reshape(-1) for p in parts])
    g = comm.all_gather(flat[None], 0, "tp.q.gather")  # (M, total)
    out, off = [], 0
    for p in parts:
        blocks = g[:, off : off + p.numel()].reshape((comm.size,) + p.shape)
        out.append(torch.cat(blocks.unbind(0), dim=-2))
        off += p.numel()
    return out


def _donate_q(q_old: torch.Tensor, q_new: torch.Tensor) -> torch.Tensor:
    """The new warm-start Q written into the old one, which holds every
    worker's copy: the same memory expanded over the workers (as
    ``init_leaf_state`` makes it) or one row a worker (as a restored
    checkpoint holds it)."""
    if q_old.stride(0) == 0:
        q_old[0].copy_(q_new)
    else:
        q_old.copy_(q_new.expand_as(q_old))
    return q_old


class PowerSGDHandler(LeafGroupHandler):
    """Low-rank power-iteration sync over a leaf group (f32 factor wire)."""

    method = "powersgd"
    namespaces = ("err", "q")
    param_shaped = ("err",)

    # ---- the factor wire (overridden by LQ-SGD) --------------------------
    def _leaf_codec(self, pl: LeafPlan, bits: int) -> WireCodec:
        return make_codec("float32")

    def _leaf_bits_p(self, pl: LeafPlan) -> int:
        return 32

    def _leaf_bits_q(self, pl: LeafPlan) -> int:
        return 32

    def _codec_p(self, pl: LeafPlan) -> WireCodec:
        return self._leaf_codec(pl, self._leaf_bits_p(pl))

    def _codec_q(self, pl: LeafPlan) -> WireCodec:
        return self._leaf_codec(pl, self._leaf_bits_q(pl))

    def _raw_needs_key(self, pl: LeafPlan) -> bool:
        """Does this leaf's raw route draw? (LQ-SGD quantizes raw leaves
        too, so a randomized codec reaches them.)"""
        return False

    def group_needs_prng(self, plans):
        for pl in plans:
            if pl.route == "lowrank":
                if self._codec_p(pl).requires_key or self._codec_q(pl).requires_key:
                    return True
            elif self._raw_needs_key(pl):
                return True
        return False

    @staticmethod
    def _leaf_key(state, i: int, phase: str, device) -> torch.Generator:
        """Leaf ``i``'s generator of one phase ('p', 'q' or 'raw') at the
        state's step: the JAX package's ``fold_in(fold_in(base, i), phase)``,
        each on a stream of its own (``PHASE_STREAMS``)."""
        return leaf_generator(
            state["key"], state["step"], i, device, stream=PHASE_STREAMS[phase]
        )

    # ---- state -----------------------------------------------------------
    def init_leaf_state(self, seed, i, pl, n_workers, device):
        """Zero E per worker and a warm-start Q from the seed and the leaf
        index, the same on every worker. The draw is the port's own: a run
        held to the JAX package imports that package's Q
        (:func:`repro_torch.weights.compressor_state_from_jax`)."""
        if pl.route != "lowrank":
            return {}
        q_shape = _instance_shape(pl)[:-2] + (pl.mat_shape[1], pl.eff_rank)
        if torch.device(device).type == "meta":  # shapes only (no draw)
            q = torch.empty(q_shape, device=device)
        else:
            gen = leaf_generator(seed, 0, i, device)
            q = torch.randn(q_shape, generator=gen, device=device)
        sd = state_dtype(self.cfg)
        return {
            "err": torch.zeros((n_workers,) + pl.shape, dtype=sd, device=device),
            "q": q.expand((n_workers,) + q_shape),
        }

    # ---- one collective phase, sub-grouped by wire codec ------------------
    def _phase(self, xs, flags, codecs, comm, rec, keys=None, split=None):
        """Ship one factor phase; leaves sub-group by codec (equal knobs
        compare equal, so a uniform group stays ONE fused collective).
        ``keys(j)`` gives the generator of the j-th tensor, for the codecs
        that draw; ``split[j]`` the ``codec.ModelBlock`` where the j-th is
        a block of a factor split over a model axis (``codec.codec_phase``)."""
        out: list = [None] * len(xs)
        split = split if split is not None else [None] * len(xs)
        for codec, idxs in _group_by(range(len(xs)), lambda j: codecs[j]):
            ks = [keys(j) for j in idxs] if codec.requires_key else None
            res = codec_phase(
                [xs[j] for j in idxs],
                [flags[j] for j in idxs],
                codec,
                comm,
                rec,
                avg_mode=self.cfg.avg_mode,
                wire=self.cfg.wire_accounting,
                fuse=self.cfg.fuse_collectives,
                keys=ks,
                split=[split[j] for j in idxs],
            )
            for j, r in zip(idxs, res):
                out[j] = r
        return out

    # ---- the group sync ---------------------------------------------------
    def _keys(self, comp, state, phase: str):
        """The j-th compressed leaf's generator of ``phase``, made when a
        codec that draws asks for it."""
        return lambda j: self._leaf_key(state, comp[j][0], phase, comp[j][1].device)

    def sync_group(self, items, state, comm, rec, *, donate=False, model=None):
        outs: dict[int, torch.Tensor] = {}
        new_err: dict[str, torch.Tensor] = {}
        new_q: dict[str, torch.Tensor] = {}
        comp = []
        for i, g, pl in items:
            split = model.block(i, pl.shape) if model is not None else None
            if pl.route == "lowrank":
                comp.append((i, g, pl))
            elif self._raw_needs_key(pl):
                key = self._leaf_key(state, i, "raw", g.device)
                outs[i] = self.sync_raw(g, pl, comm, rec, key=key, split=split)
            else:
                outs[i] = self.sync_raw(g, pl, comm, rec, split=split)
        if not comp:
            return outs, {"err": new_err, "q": new_q}
        flags = [pl.stacked for _, _, pl in comp]
        kinds = [model.kind(i, pl) if model else None for i, _, pl in comp]
        mc = model.comm if model is not None else None
        # ---- P phase ----
        g_efs, ps = [], []
        in_place = [donates(state["err"][str(i)], donate) for i, _, _ in comp]
        for (i, g, pl), inp, kind in zip(comp, in_place, kinds):
            if pl.stacked:
                shp = (g.shape[0], g.shape[1]) + matricize_shape(g.shape[2:])
            else:
                shp = (g.shape[0],) + matricize_shape(g.shape[1:])
            g_ef = error_corrected(g, state["err"][str(i)], shp, inp)
            g_efs.append(g_ef)  # Alg.1 l.4
            q = state["q"][str(i)]
            if kind == "col":  # the Q rows of this rank's columns
                m_loc = shp[-1]
                q = q.narrow(-2, mc.rank * m_loc, m_loc)
            ps.append(power_iter_p(g_ef, q))  # Alg.1 l.10
        col = [j for j, kind in enumerate(kinds) if kind == "col"]
        if col:  # partial P's: summed over the model axis
            for j, p in zip(col, _sum_parts([ps[j] for j in col], mc, "tp.p")):
                ps[j] = p
        codecs_p = [self._codec_p(pl) for _, _, pl in comp]
        # a row-split leaf's P rows: the leaf's dims but its last, cut alike
        split_p = [
            model.block(i, pl.shape[:-1] + (pl.eff_rank,)) if kind == "row" else None
            for (i, _, pl), kind in zip(comp, kinds)
        ]
        ps = self._phase(
            ps, flags, codecs_p, comm, rec, self._keys(comp, state, "p"), split_p
        )
        # ---- orthonormalize + Q phase ----
        row = [j for j, kind in enumerate(kinds) if kind == "row"]
        p_hats = [  # Alg.1 l.11
            None if kind == "row" else orthonormalize(p) for p, kind in zip(ps, kinds)
        ]
        if row:
            for j, p_hat in zip(row, orthonormalize_split([ps[j] for j in row], mc)):
                p_hats[j] = p_hat
        qs = [power_iter_q(g_ef, p_hat) for g_ef, p_hat in zip(g_efs, p_hats)]
        if row:  # partial Q's: summed over the model axis
            for j, q in zip(row, _sum_parts([qs[j] for j in row], mc, "tp.q")):
                qs[j] = q
        codecs_q = [self._codec_q(pl) for _, _, pl in comp]
        # a column-split leaf's Q rows: its last dim, a block of them
        split_q = [
            model.block(i, _instance_shape(pl)[:-2] + (pl.shape[-1], pl.eff_rank), -2)
            if kind == "col"
            else None
            for (i, _, pl), kind in zip(comp, kinds)
        ]
        qs = self._phase(
            qs, flags, codecs_q, comm, rec, self._keys(comp, state, "q"), split_q
        )
        # ---- the next warm-start Q: a column-split leaf's blocks gathered ----
        q_next = list(qs)
        if col:
            for j, q in zip(col, _gather_parts([qs[j] for j in col], mc)):
                q_next[j] = q
        # ---- reconstruct + error feedback ----
        for (i, g, pl), g_ef, p_hat, q_new, q_full, inp in zip(
            comp, g_efs, p_hats, qs, q_next, in_place
        ):
            g_hat = reconstruct(p_hat, q_new)  # Alg.1 l.19
            # in g_ef's own memory: the residual is the new error feedback,
            # and a 1B-parameter model's per-worker f32 copies are 16 GB
            g_res = g_ef.sub_(g_hat).reshape(g.shape)
            if inp:  # g_ef was the old error feedback: donated, updated
                new_err[str(i)] = state["err"][str(i)]
                new_q[str(i)] = _donate_q(state["q"][str(i)], q_full)
            else:
                new_err[str(i)] = g_res.to(state_dtype(self.cfg))  # Alg.1 l.20
                new_q[str(i)] = q_full.expand((g.shape[0],) + q_full.shape)
            outs[i] = g_hat.reshape(g.shape[1:]).to(g.dtype)
        return outs, {"err": new_err, "q": new_q}

    # ----------------------------------------------------------- accounting
    def leaf_wire_bits(self, pl):
        if pl.route != "lowrank":
            return self.raw_wire_bits(pl, _numel(pl.shape))
        cp, cq = self._codec_p(pl), self._codec_q(pl)
        n, m = pl.mat_shape
        r = pl.eff_rank
        n_layers = pl.shape[0] if pl.stacked else 1
        return (
            cp.wire_bits(n_layers * n * r)
            + cp.scale_bits(n_layers)  # P (+ scales)
            + cq.wire_bits(n_layers * m * r)
            + cq.scale_bits(n_layers)  # Q (+ scales)
        )

    def leaf_replicated_bits(self, pl, kind):
        """A column-split leaf's P and a row-split leaf's Q are whole on
        every model rank, and so is every scale (the model-wide max); a
        whole leaf is shipped whole by each."""
        if pl.route != "lowrank":
            return self.raw_replicated_bits(pl, kind)
        if kind is None:
            return self.leaf_wire_bits(pl)
        cp, cq = self._codec_p(pl), self._codec_q(pl)
        n, m = pl.mat_shape
        r = pl.eff_rank
        n_layers = pl.shape[0] if pl.stacked else 1
        scales = cp.scale_bits(n_layers) + cq.scale_bits(n_layers)
        if kind == "col":
            return scales + cp.wire_bits(n_layers * n * r)
        return scales + cq.wire_bits(n_layers * m * r)

    def raw_replicated_bits(self, pl, kind) -> int:
        return super().leaf_replicated_bits(pl, kind)

    def group_collectives(self, plans):
        from repro_torch.core.codec import phase_collectives

        comp = [pl for pl in plans if pl.route == "lowrank"]
        n = super().group_collectives(plans)
        for codec_of in (self._codec_p, self._codec_q):  # the P and Q phases
            for codec, sub in _group_by(comp, codec_of):
                n += phase_collectives(
                    len(sub),
                    codec,
                    wire=self.cfg.wire_accounting,
                    fuse=self.cfg.fuse_collectives,
                )
        return n

    def leaf_epsilon(self, pl, delta: float = 1e-5) -> float:
        """Both factor phases spend (or the raw route does): a leaf ships in
        the clear, at an infinite spend, unless both are randomized."""
        if pl.route == "lowrank":
            eps_p = self._codec_p(pl).epsilon_per_use(delta)
            return eps_p + self._codec_q(pl).epsilon_per_use(delta)
        return super().leaf_epsilon(pl, delta)

    def leaf_physical_bits(self, pl):
        if pl.route != "lowrank" or self.cfg.wire_accounting != "psum_sim":
            return self.leaf_wire_bits(pl)
        # psum_sim ships both factors' codes as f32 (scale pmaxes as they are)
        cp, cq = self._codec_p(pl), self._codec_q(pl)
        n, m = pl.mat_shape
        r = pl.eff_rank
        n_layers = pl.shape[0] if pl.stacked else 1
        return (
            n_layers * n * r * 32
            + cp.scale_bits(n_layers)
            + n_layers * m * r * 32
            + cq.scale_bits(n_layers)
        )


class PowerSGDCompressor(GradCompressor):
    """Low-rank gradient compression with error feedback + warm start."""

    method = "powersgd"
    handler_cls = PowerSGDHandler
