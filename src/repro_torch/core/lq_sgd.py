"""LQ-SGD: the paper's Algorithm 1 (PowerSGD + logarithmic quantization).

The control flow of :class:`~repro_torch.core.powersgd.PowerSGDHandler`,
the same group sync, with the factor wire swapped from f32 to the b-bit
log-quantized :class:`~repro_torch.core.codec.LogQuantCodec` (paper Eq. 5/6):

    scale  = pmax_i max|x_i|                       (shared quantization grid)
    codes  = round( log1p(a|x|/s) / log1p(a) * L ) (signed b-bit integers)
    wire   = all_gather(packed codes)  or  psum-simulated ring all-reduce
    mean   = dequant(mean(codes))                  ["paper", Alg.1 literal]
           | mean(dequant(codes))                  ["dequant_then_mean"]

On the card the encode is a Triton kernel (b=8 codes, or the fused b<=4
encode + nibble pack) and so is the dequant, which takes the f32 mean of
gathered codes in the paper's mode. ``bits`` sets the P phase, ``bits_q``
the Q phase (the paper allows b_p != b_q). A stacked leaf quantizes with a
scale per layer.

Non-low-rank leaves (biases, norms) are log-quantized to b bits too before
their all-reduce: that is what reconciles the paper's Table-I LQ-SGD sizes
(3 MB vs PowerSGD 14 MB, the full 32/b on everything). Their mean is taken
over dequantized values: a mean of log-domain codes over a sign-mixed small
tensor is badly biased (a quasi-geometric mean).

Randomized wire: ``cfg.codec`` or a leaf's ``LeafPolicy.codec`` swaps
``log`` for its randomized relatives (``dlog`` with a calibrated DP budget,
``lrq`` layered; :mod:`repro_torch.core.codec`), and a DP budget without a
codec picks ``dlog``. The wire format and bits stay ``log``'s; the rounding
draws from per-(leaf, phase) generators
(:class:`~repro_torch.core.powersgd.PowerSGDHandler`).
"""

from __future__ import annotations

from repro_torch.core.codec import (
    WireCodec,
    codec_phase,
    make_codec,
    phase_collectives,
)
from repro_torch.core.compressors import GradCompressor, _numel
from repro_torch.core.powersgd import PowerSGDHandler

__all__ = ["LQSGDCompressor", "LQSGDHandler"]


class LQSGDHandler(PowerSGDHandler):
    """PowerSGD control flow over a log-quantized wire."""

    method = "lq_sgd"

    def _leaf_codec(self, pl, bits: int) -> WireCodec:
        """The log-quant family member of one leaf: ``pl.policy.codec``, else
        ``cfg.codec``, else ``dlog`` where the leaf has a DP budget and
        ``log`` where it has none; the privacy knobs from the same pair."""
        eps = pl.policy.dp_epsilon or self.cfg.dp_epsilon
        name = pl.policy.codec or self.cfg.codec or ("dlog" if eps > 0 else "log")
        knobs: dict = dict(bits=bits, alpha=self.cfg.alpha)
        if name == "dlog":
            knobs.update(dp_epsilon=eps, dp_delta=self.cfg.dp_delta)
        elif name == "lrq":
            knobs.update(n_layers=min(self.cfg.lrq_layers, max(1, bits - 1)))
        return make_codec(name, **knobs)

    def _leaf_bits_p(self, pl) -> int:
        return pl.policy.bits

    def _leaf_bits_q(self, pl) -> int:
        return pl.policy.eff_bits_q

    def _raw_codec(self, pl) -> WireCodec:
        return self._leaf_codec(pl, pl.policy.bits)

    def _raw_needs_key(self, pl) -> bool:
        return self._raw_codec(pl).requires_key

    def sync_raw(self, g, pl, comm, rec, *, key=None, split=None):
        codec = self._raw_codec(pl)
        out = codec_phase(
            [g.float()],
            [False],
            codec,
            comm,
            rec,
            avg_mode="dequant_then_mean",
            wire=self.cfg.wire_accounting,
            fuse=False,
            keys=[key] if codec.requires_key else None,
            split=[split],
        )[0]
        return out.to(g.dtype)

    def raw_replicated_bits(self, pl, kind) -> int:
        # a split raw leaf's codes go in blocks; its scale is whole
        if kind is None:
            return self.leaf_wire_bits(pl)
        return self._raw_codec(pl).scale_bits(1)

    def raw_collectives(self, pl) -> int:
        return phase_collectives(
            1, self._raw_codec(pl), wire=self.cfg.wire_accounting, fuse=False
        )

    def raw_wire_bits(self, pl, numel: int) -> int:
        codec = self._raw_codec(pl)
        return codec.wire_bits(numel) + codec.scale_bits(1)

    def leaf_epsilon(self, pl, delta: float = 1e-5) -> float:
        if pl.route == "lowrank":
            return super().leaf_epsilon(pl, delta)
        return self._raw_codec(pl).epsilon_per_use(delta)

    def leaf_epsilon_kind(self, pl) -> str | None:
        # the P, Q and raw codecs differ only in bits, which no kind reads
        return self._raw_codec(pl).epsilon_kind

    def leaf_physical_bits(self, pl):
        if pl.route == "lowrank" or self.cfg.wire_accounting != "psum_sim":
            return super().leaf_physical_bits(pl)
        # quantized raw leaves under psum_sim: codes ride the psum as f32
        return _numel(pl.shape) * 32 + self._raw_codec(pl).scale_bits(1)


class LQSGDCompressor(GradCompressor):
    """The paper's LQ-SGD driven over the whole tree."""

    method = "lq_sgd"
    handler_cls = LQSGDHandler
