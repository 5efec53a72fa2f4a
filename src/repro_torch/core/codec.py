"""The wire-codec layer: every compressor's quantize -> pack -> collective
-> dequantize pipeline, and the KV cache's stored bytes.

A :class:`WireCodec` turns a normalized float tensor into the exact array
that is shipped or stored (``encode``), recovers code values from those
bytes (``decode``) and maps (possibly averaged) codes back to values
(``expand``). ``wire_bits`` reports the byte size of the encoded array: b <= 4
codes are nibble-packed two per int8 byte, so accounting and array bytes
agree.

Codecs are built through a registry: :func:`make_codec` resolves a name
(``available_codecs()`` lists them) and checks knobs against the codec's
dataclass fields. Registered here:

* ``float32`` :class:`Float32Codec`: identity f32 wire (PowerSGD factors,
  TopK's dense-simulated sparse payload);
* ``log`` :class:`LogQuantCodec`: the paper's Eq. 5/6 log-quantizer; its
  encode and expand go through the Triton kernels on a CUDA tensor;
* ``qsgd`` :class:`QSGDCodec`: stochastic uniform quantization (Alistarh
  et al. 2017); the b <= 4 pack goes through the Triton pack kernel.

The randomized privacy codecs (``dlog``, ``lrq``) are not ported yet.

PRNG contract: a codec declares ``requires_key``. A randomized codec needs
the keyword-only ``key`` (a ``torch.Generator`` on the tensor's device) in
``codes``/``encode``; a deterministic one rejects it, since a key silently
unused would make a run look reproducible when it is not.

Privacy contract: ``epsilon_per_use(delta)`` is the per-message DP epsilon
under the Gaussian-mechanism convention of
:mod:`repro_torch.core.privacy.accounting`; ``inf`` for every codec ported
so far, since none injects calibrated noise.

:func:`codec_phase` is the one collective primitive the compressors share:
it scales (pmax), encodes, ships (ONE fused flat gather with ``fuse=True``,
else one gather per tensor), decodes and averages a list of tensors whose
leading dim is the workers (:mod:`repro_torch.core.comm`).
"""

from __future__ import annotations

import ast
import dataclasses
import math
from collections.abc import Callable, Sequence
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.comm import CommRecord, SimComm
from repro_torch.core.quantization import LogQuantConfig, code_dtype, f32_div
from repro_torch.core.wire import SymmetricWire, as_wire

__all__ = [
    "WireCodec",
    "Float32Codec",
    "LogQuantCodec",
    "QSGDCodec",
    "register_codec",
    "make_codec",
    "available_codecs",
    "codec_phase",
    "pack_nibbles",
    "unpack_nibbles",
    "packed_wire_bits",
]


# --------------------------------------------------------------------------
# the codec registry: all construction goes through make_codec
# --------------------------------------------------------------------------

_CODEC_REGISTRY: dict[str, type] = {}


def register_codec(name: str) -> Callable[[type], type]:
    """Class decorator: register a WireCodec subclass under ``name``."""

    def deco(cls: type) -> type:
        if name in _CODEC_REGISTRY:
            raise ValueError(
                f"codec {name!r} already registered "
                f"({_CODEC_REGISTRY[name].__name__})"
            )
        _CODEC_REGISTRY[name] = cls
        cls.codec_name = name
        return cls

    return deco


def available_codecs() -> tuple[str, ...]:
    """Registered codec names, sorted."""
    return tuple(sorted(_CODEC_REGISTRY))


def _parse_codec_spec(spec: str) -> tuple[str, dict[str, Any]]:
    """'name' or 'name:knob=value,knob=value' -> (name, knobs). Values parse
    as Python literals where they can ('4' -> 4) and stay strings otherwise."""
    name, _, rest = spec.partition(":")
    knobs: dict[str, Any] = {}
    if rest:
        for item in rest.split(","):
            k, sep, v = item.partition("=")
            if not sep or not k:
                raise ValueError(
                    f"bad codec spec item {item!r} in {spec!r}; "
                    "expected 'name:knob=value,...'"
                )
            try:
                knobs[k.strip()] = ast.literal_eval(v.strip())
            except (ValueError, SyntaxError):
                knobs[k.strip()] = v.strip()
    return name.strip(), knobs


def make_codec(spec: str, **knobs: Any) -> WireCodec:
    """Build a codec from a registered name, with knobs inline in ``spec``
    ('log:bits=4') and/or as keywords (keywords win). Knob names are checked
    against the codec's dataclass fields."""
    name, inline = _parse_codec_spec(spec)
    cls = _CODEC_REGISTRY.get(name)
    if cls is None:
        raise ValueError(
            f"unknown codec {name!r}; available: {', '.join(available_codecs())}"
        )
    merged = {**inline, **knobs}
    accepted = {f.name for f in dataclasses.fields(cls) if f.init}
    unknown = sorted(set(merged) - accepted)
    if unknown:
        raise ValueError(
            f"codec {name!r} does not accept knob(s) {unknown}; "
            f"accepted: {sorted(accepted)}"
        )
    return cls(**merged)


# --------------------------------------------------------------------------
# bit packing: two 4-bit two's-complement codes per int8 byte
# --------------------------------------------------------------------------


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """Signed codes in [-8, 7] (any shape) -> 1-D int8, byte i = c[2i] | c[2i+1]<<4.

    An odd count pads with a zero code."""
    flat = codes.reshape(-1).to(torch.int32)
    if flat.numel() % 2:
        flat = F.pad(flat, (0, 1))
    lo, hi = flat[0::2], flat[1::2]
    return ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.uint8).view(torch.int8)


def unpack_nibbles(packed: torch.Tensor, numel: int) -> torch.Tensor:
    """Packed int8 (..., nbytes) -> signed int32 codes (..., numel)."""
    v = packed.to(torch.int32) & 0xFF
    lo = ((v & 0xF) ^ 8) - 8  # sign-extend a 4-bit two's-complement nibble
    hi = (((v >> 4) & 0xF) ^ 8) - 8
    codes = torch.stack([lo, hi], dim=-1)
    return codes.reshape(packed.shape[:-1] + (-1,))[..., :numel]


def packed_wire_bits(numel: int, bits: int) -> int:
    """Exact bits of the encoded array: nibble-packed int8 for b<=4, int8
    for b<=8, int16 above, matching the containers ``encode`` emits."""
    if bits <= 4:
        return ((numel + 1) // 2) * 8
    if bits <= 8:
        return numel * 8
    return numel * 16


# --------------------------------------------------------------------------
# codecs
# --------------------------------------------------------------------------


class WireCodec:
    """Protocol: what a compressor or a cache needs to ship a tensor as codes.

    ``codes``   normalized values -> integer (or identity float) codes, same
                shape;
    ``encode``  normalized values -> the 1-D wire array (packed for b<=4);
    ``decode``  wire array (..., nbytes|numel) -> float codes (..., numel);
    ``expand``  (possibly averaged) float codes -> normalized values;
    ``wire_bits``  exact bits of ``encode``'s output for ``numel`` elements;
    ``scale_bits`` bits of the scale sideband (0 when ``needs_scale`` is False).
    """

    bits: int = 32
    needs_scale: bool = True
    requires_key: bool = False
    codec_name: str = ""

    def codes(
        self, x: torch.Tensor, *, key: torch.Generator | None = None
    ) -> torch.Tensor:
        raise NotImplementedError

    def encode(
        self, x: torch.Tensor, *, key: torch.Generator | None = None
    ) -> torch.Tensor:
        raise NotImplementedError

    def decode(self, wire: torch.Tensor, numel: int) -> torch.Tensor:
        raise NotImplementedError

    def expand(self, codes: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def wire_bits(self, numel: int) -> int:
        raise NotImplementedError

    def scale_bits(self, n_scales: int) -> int:
        return 32 * n_scales if self.needs_scale else 0

    def epsilon_per_use(self, delta: float = 1e-5) -> float:
        """Per-message DP epsilon at ``delta``: ``inf``, no guarantee."""
        return math.inf

    def _check_key(self, key: torch.Generator | None) -> None:
        if self.requires_key and key is None:
            raise ValueError(
                f"{type(self).__name__} is randomized (requires_key=True) and "
                "needs a generator: call codes/encode with key=..."
            )
        if not self.requires_key and key is not None:
            raise ValueError(
                f"{type(self).__name__} is deterministic (requires_key=False) "
                "and rejects a generator, which would be silently unused"
            )


@register_codec("float32")
@dataclasses.dataclass(frozen=True)
class Float32Codec(WireCodec):
    """Identity f32 wire: 'codes' are the values themselves."""

    bits: int = 32
    needs_scale: bool = False

    def codes(self, x, *, key=None):
        self._check_key(key)
        return x.float()

    def encode(self, x, *, key=None):
        self._check_key(key)
        return x.float().reshape(-1)

    def decode(self, wire, numel):
        return wire.float()

    def expand(self, codes):
        return codes

    def wire_bits(self, numel):
        return numel * 32


@register_codec("log")
@dataclasses.dataclass(frozen=True)
class LogQuantCodec(WireCodec):
    """Paper Eq. 5/6 log-quantizer.

    ``codes``, ``encode`` and ``expand`` go through
    ``repro_torch.kernels.ops``: on a CUDA tensor the Triton kernels (b=8
    encode, fused b<=4 encode + pack, the dequant that expands integer or
    averaged codes), on a CPU tensor their plain versions."""

    bits: int = 8
    alpha: float = 10.0
    needs_scale: bool = True

    @property
    def _cfg(self) -> LogQuantConfig:
        return LogQuantConfig(bits=self.bits, alpha=self.alpha)

    def codes(self, x, *, key=None):
        from repro_torch.kernels import ops  # ops -> ref -> codec: import late

        self._check_key(key)
        return ops.log_quantize(x, 1.0, bits=self.bits, alpha=self.alpha)

    def encode(self, x, *, key=None):
        self._check_key(key)
        if self.bits <= 4:
            from repro_torch.kernels import ops

            # one fused pass: quantize + nibble-pack, so the int8 codes never
            # round-trip through device memory between two launches
            return ops.log_quantize_pack(x, 1.0, bits=self.bits, alpha=self.alpha)
        return self.codes(x).reshape(-1)

    def decode(self, wire, numel):
        if self.bits <= 4:
            return unpack_nibbles(wire, numel).float()
        return wire.float()

    def expand(self, codes):
        from repro_torch.kernels import ops

        return ops.log_dequantize(codes, 1.0, bits=self.bits, alpha=self.alpha)

    def wire_bits(self, numel):
        return packed_wire_bits(numel, self.bits)


@register_codec("qsgd")
@dataclasses.dataclass(frozen=True)
class QSGDCodec(WireCodec):
    """QSGD stochastic uniform quantization: E[expand(codes(x))] = x.

    Needs a generator per call (per tensor, per step; one draw covers every
    worker of a (N, ...) tensor). The draws are the port's own: they cannot
    reproduce ``jax.random``, so the codec is held to the reference
    statistically, and its wire bits exactly. Its rounding noise has bounded
    support, so ``epsilon_per_use`` stays ``inf``: no (epsilon, delta) claim
    under the Gaussian accountant."""

    bits: int = 8
    needs_scale: bool = True
    requires_key = True

    @property
    def levels(self) -> int:
        return (1 << (self.bits - 1)) - 1

    def codes(self, x, *, key=None):
        self._check_key(key)
        x = x.float()
        y = x.abs() * self.levels
        lo = torch.floor(y)
        rnd = torch.rand(x.shape, generator=key, device=x.device)
        q = (lo + (rnd < (y - lo)).float()) * torch.sign(x)
        q = torch.clamp(q, -self.levels, self.levels)
        return q.to(code_dtype(self.bits))

    def encode(self, x, *, key=None):
        c = self.codes(x, key=key)
        if self.bits <= 4:
            from repro_torch.kernels import ops

            return ops.pack_nibbles(c)
        return c.reshape(-1)

    def decode(self, wire, numel):
        if self.bits <= 4:
            return unpack_nibbles(wire, numel).float()
        return wire.float()

    def expand(self, codes):
        return f32_div(codes.float(), self.levels)

    def wire_bits(self, numel):
        return packed_wire_bits(numel, self.bits)


# --------------------------------------------------------------------------
# the shared collective phase
# --------------------------------------------------------------------------


def _local_absmax(x: torch.Tensor, stacked: bool) -> torch.Tensor:
    """Each worker's max |x| of a (N, ...) tensor: (N,), or (N, L, 1, ...)
    per layer when the leaf is a stack of L layers."""
    if stacked:
        return x.abs().amax(dim=tuple(range(2, x.dim())), keepdim=True)
    return x.abs().reshape(x.shape[0], -1).amax(1)


def _encode_workers(
    codec: WireCodec, x: torch.Tensor, key: torch.Generator | None
) -> torch.Tensor:
    """Each worker's wire array of a (N, ...) tensor, as (N, nbytes|numel),
    in one encode. Where two codes share a byte and a worker's count is odd,
    each worker's row gets a zero pad value first, so no byte straddles two
    workers; it encodes as the zero pad code the per-worker encode adds."""
    rows = x.reshape(x.shape[0], -1)
    if codec.bits <= 4 and rows.shape[1] % 2:
        rows = F.pad(rows, (0, 1))
    wire = codec.encode(rows.contiguous(), key=key)
    return wire.reshape(x.shape[0], -1)


def codec_phase(
    xs: Sequence[torch.Tensor],
    stacked_flags: Sequence[bool],
    codec: WireCodec,
    comm: SimComm | SymmetricWire,
    rec: CommRecord,
    *,
    avg_mode: str = "paper",
    wire: str = "allgather_codes",
    fuse: bool = False,
    keys: Sequence[torch.Generator | None] | None = None,
    account_bits: Sequence[int] | None = None,
) -> list[torch.Tensor]:
    """Ship a list of (N, ...) per-worker tensors through one collective phase.

    Every tensor is scaled against the pmax'd max |x| of each instance (per
    layer for a stacked leaf), encoded by ``codec``, gathered (ONE fused
    flat gather when ``fuse=True``, else one per tensor), decoded and
    averaged:

      avg_mode='paper'             expand(mean(codes))   [Alg. 1 literal]
      avg_mode='dequant_then_mean' mean(expand(codes))

    ``wire='psum_sim'`` simulates the ring all-reduce with a pmean over
    float codes instead of gathering wire bytes.

    ``rec`` is charged each worker's actual bits of every encoded array plus
    32 per scale, unless ``account_bits`` overrides the payload (TopK's
    sparse accounting over a dense simulation). Collective counts include
    the scale pmax: one when fused, else one per tensor. Returns the synced
    tensors, one per input, in the input's per-worker shape (no worker dim):
    every worker holds the same values.
    """
    n = len(xs)
    if n == 0:
        return []
    keys = list(keys) if keys is not None else [None] * n
    xs = [x.float() for x in xs]
    wt = as_wire(comm)

    # ---- shared quantization grid: per-instance global max ---------------
    if codec.needs_scale:
        local = [_local_absmax(x, st) for x, st in zip(xs, stacked_flags)]
        if fuse:
            gmax = wt.fused_pmax(local)
        else:
            gmax = [wt.pmax(m) for m in local]
        rec.add(0, 1 if fuse else n)
        safes = [torch.where(s > 0, s, torch.ones_like(s)) for s in gmax]
        xn = [x / s for x, s in zip(xs, safes)]  # tensor divisor: IEEE division
        n_scales = [s.numel() for s in safes]
    else:
        safes = [None] * n
        xn = xs
        n_scales = [0] * n

    def _rescale(val, safe):
        return val if safe is None else val * safe

    # ---- simulated ring all-reduce over codes ----------------------------
    if wire == "psum_sim":
        outs = []
        for i, (x, safe, key, ns) in enumerate(zip(xn, safes, keys, n_scales)):
            c = codec.codes(x, key=key)
            numel = x[0].numel()
            payload = (
                account_bits[i] if account_bits is not None else codec.wire_bits(numel)
            )
            rec.add(payload + codec.scale_bits(ns), 1)
            if avg_mode == "paper":
                val = codec.expand(wt.pmean(c.float()))
            else:
                val = wt.pmean(codec.expand(c.float()))
            outs.append(_rescale(val, safe))
        return outs
    if wire != "allgather_codes":
        raise ValueError(f"unknown wire mode {wire!r}")

    # ---- exact wire: encode -> (fused) all-gather -> decode --------------
    wires = [_encode_workers(codec, x, key) for x, key in zip(xn, keys)]
    for i, (w, ns) in enumerate(zip(wires, n_scales)):
        payload = (
            account_bits[i]
            if account_bits is not None
            else w[0].numel() * w.element_size() * 8
        )
        rec.add(payload + codec.scale_bits(ns), 0)
    if fuse:
        gathered = wt.fused_all_gather(wires)
        rec.n_collectives += 1
    else:
        gathered = [wt.all_gather(w) for w in wires]
        rec.n_collectives += n

    outs = []
    for g, x, safe in zip(gathered, xs, safes):
        codes = codec.decode(g, x[0].numel()).reshape(x.shape)
        if avg_mode == "paper":
            val = codec.expand(wt.average(codes))
        else:
            val = wt.average(codec.expand(codes))
        outs.append(_rescale(val, safe))
    return outs
