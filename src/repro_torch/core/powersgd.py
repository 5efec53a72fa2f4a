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
"""

from __future__ import annotations

import torch

from repro_torch.core.codec import WireCodec, codec_phase, make_codec
from repro_torch.core.compressors import (
    GradCompressor,
    LeafGroupHandler,
    LeafPlan,
    _group_by,
    _numel,
    leaf_generator,
)
from repro_torch.core.low_rank import (
    orthonormalize,
    power_iter_p,
    power_iter_q,
    reconstruct,
)

__all__ = ["PowerSGDCompressor", "PowerSGDHandler"]


def _instance_shape(pl: LeafPlan) -> tuple[int, ...]:
    """A leaf's matricized shape, (L, n, m) for a stack of L layers."""
    return ((pl.shape[0],) if pl.stacked else ()) + pl.mat_shape


class PowerSGDHandler(LeafGroupHandler):
    """Low-rank power-iteration sync over a leaf group (f32 factor wire)."""

    method = "powersgd"
    namespaces = ("err", "q")

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

    # ---- state -----------------------------------------------------------
    def init_leaf_state(self, seed, i, pl, n_workers, device):
        """Zero E per worker and a warm-start Q from the seed and the leaf
        index, the same on every worker. The draw is the port's own: a run
        held to the JAX package imports that package's Q
        (:func:`repro_torch.weights.compressor_state_from_jax`)."""
        if pl.route != "lowrank":
            return {}
        gen = leaf_generator(seed, 0, i, device)
        q_shape = _instance_shape(pl)[:-2] + (pl.mat_shape[1], pl.eff_rank)
        q = torch.randn(q_shape, generator=gen, device=device)
        return {
            "err": torch.zeros((n_workers,) + pl.shape, device=device),
            "q": q.expand((n_workers,) + q_shape),
        }

    # ---- one collective phase, sub-grouped by wire codec ------------------
    def _phase(self, xs, flags, codecs, comm, rec):
        """Ship one factor phase; leaves sub-group by codec (equal knobs
        compare equal, so a uniform group stays ONE fused collective)."""
        out: list = [None] * len(xs)
        for codec, idxs in _group_by(range(len(xs)), lambda j: codecs[j]):
            res = codec_phase(
                [xs[j] for j in idxs],
                [flags[j] for j in idxs],
                codec,
                comm,
                rec,
                avg_mode=self.cfg.avg_mode,
                wire=self.cfg.wire_accounting,
                fuse=self.cfg.fuse_collectives,
            )
            for j, r in zip(idxs, res):
                out[j] = r
        return out

    # ---- the group sync ---------------------------------------------------
    def sync_group(self, items, state, comm, rec):
        outs: dict[int, torch.Tensor] = {}
        new_err: dict[str, torch.Tensor] = {}
        new_q: dict[str, torch.Tensor] = {}
        comp = []
        for i, g, pl in items:
            if pl.route == "lowrank":
                comp.append((i, g, pl))
            else:
                outs[i] = self.sync_raw(g, pl, comm, rec)
        if not comp:
            return outs, {"err": new_err, "q": new_q}
        flags = [pl.stacked for _, _, pl in comp]
        # ---- P phase ----
        g_efs, ps = [], []
        for i, g, pl in comp:
            shp = (g.shape[0],) + _instance_shape(pl)
            g_ef = g.float().reshape(shp) + state["err"][str(i)].float().reshape(shp)
            g_efs.append(g_ef)  # Alg.1 l.4
            ps.append(power_iter_p(g_ef, state["q"][str(i)]))  # Alg.1 l.10
        ps = self._phase(ps, flags, [self._codec_p(pl) for _, _, pl in comp], comm, rec)
        # ---- orthonormalize + Q phase ----
        p_hats = [orthonormalize(p) for p in ps]  # Alg.1 l.11
        qs = [power_iter_q(g_ef, p_hat) for g_ef, p_hat in zip(g_efs, p_hats)]
        qs = self._phase(qs, flags, [self._codec_q(pl) for _, _, pl in comp], comm, rec)
        # ---- reconstruct + error feedback ----
        for (i, g, pl), g_ef, p_hat, q_new in zip(comp, g_efs, p_hats, qs):
            g_hat = reconstruct(p_hat, q_new)  # Alg.1 l.19
            new_err[str(i)] = (g_ef - g_hat).reshape(g.shape)  # Alg.1 l.20
            new_q[str(i)] = q_new.expand((g.shape[0],) + q_new.shape)
            outs[i] = g_hat.reshape(pl.shape).to(g.dtype)
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
