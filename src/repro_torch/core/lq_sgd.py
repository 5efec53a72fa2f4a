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

Only the deterministic ``log`` codec is ported; its randomized relatives
(``dlog``, ``lrq``) wait for the privacy-codec slice.
"""

from __future__ import annotations

from repro_torch.core.codec import WireCodec, codec_phase, make_codec
from repro_torch.core.compressors import GradCompressor, _numel
from repro_torch.core.powersgd import PowerSGDHandler

__all__ = ["LQSGDCompressor", "LQSGDHandler"]


class LQSGDHandler(PowerSGDHandler):
    """PowerSGD control flow over a log-quantized wire."""

    method = "lq_sgd"

    def _leaf_codec(self, pl, bits: int) -> WireCodec:
        return make_codec("log", bits=bits, alpha=self.cfg.alpha)

    def _leaf_bits_p(self, pl) -> int:
        return pl.policy.bits

    def _leaf_bits_q(self, pl) -> int:
        return pl.policy.eff_bits_q

    def _raw_codec(self, pl) -> WireCodec:
        return self._leaf_codec(pl, pl.policy.bits)

    def sync_raw(self, g, pl, comm, rec):
        out = codec_phase(
            [g.float()],
            [False],
            self._raw_codec(pl),
            comm,
            rec,
            avg_mode="dequant_then_mean",
            wire=self.cfg.wire_accounting,
            fuse=False,
        )[0]
        return out.to(g.dtype)

    def raw_wire_bits(self, pl, numel: int) -> int:
        codec = self._raw_codec(pl)
        return codec.wire_bits(numel) + codec.scale_bits(1)

    def leaf_epsilon(self, pl, delta: float = 1e-5) -> float:
        if pl.route == "lowrank":
            return super().leaf_epsilon(pl, delta)
        return self._raw_codec(pl).epsilon_per_use(delta)

    def leaf_physical_bits(self, pl):
        if pl.route == "lowrank" or self.cfg.wire_accounting != "psum_sim":
            return super().leaf_physical_bits(pl)
        # quantized raw leaves under psum_sim: codes ride the psum as f32
        return _numel(pl.shape) * 32 + self._raw_codec(pl).scale_bits(1)


class LQSGDCompressor(GradCompressor):
    """The paper's LQ-SGD driven over the whole tree."""

    method = "lq_sgd"
    handler_cls = LQSGDHandler
