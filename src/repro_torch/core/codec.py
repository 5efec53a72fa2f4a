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
  et al. 2017); the b <= 4 pack goes through the Triton pack kernel;
* ``dlog`` :class:`DitheredLogQuantCodec`: the log grid with stochastic
  (dithered) rounding, unbiased in the value domain, and at
  ``dp_epsilon > 0`` Gaussian noise calibrated to a per-use DP budget
  (arXiv 2304.13545: the quantizer's randomness is the privacy mechanism);
* ``lrq`` :class:`LayeredRandQuantCodec`: layered randomized quantization
  (arXiv 2312.07060): each element is rounded on one of ``n_layers``
  nested coarsenings of the log grid, drawn per use; the wire format and
  bits are ``log``'s.

The randomized log codecs compute their codes in plain torch, as the JAX
package computes them in jnp outside any Pallas kernel, in two parts: the
draws from the generator (``draws``: the Gaussian noise, the uniform ``u``,
lrq's layer index) and a deterministic transform of them
(``noised_codes``), which a test can feed the JAX package's own draws.
Their b <= 4 pack and their expand are the Triton kernels'. Their
zero-noise configurations are ``log`` outright.

PRNG contract: a codec declares ``requires_key``. A randomized codec needs
the keyword-only ``key`` (a ``torch.Generator`` on the tensor's device, or
a :class:`WorkerRows`) in ``codes``/``encode``; a deterministic one rejects
it, since a key silently unused would make a run look reproducible when it
is not. Every draw goes through :func:`draw`: a plain generator draws
values of the tensor's shape; a :class:`WorkerRows` draws every worker's
values of the (N, ...) tensor and keeps this process's rows, so a worker's
bits depend on the seed, step, leaf, phase and its global index, never on
how many workers share its process. Where the tensor is a rank's block of
one split over a model axis (:class:`ModelBlock`), the draw covers the
whole tensor too and keeps the block, so the codes are one process's.

Privacy contract: ``privacy_sigma()`` is the std of the injected noise in
normalized units (0.0 when deterministic) and ``epsilon_per_use(delta)``
the per-message DP epsilon under the Gaussian-mechanism convention of
:mod:`repro_torch.core.privacy.accounting` (``inf`` without a guarantee).
``epsilon_kind`` labels the claim: 'calibrated' (noise sized from a
requested budget), 'gaussian_equiv' (a proxy from the noise variance) or
None.

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
from repro_torch.core.quantization import (
    LogQuantConfig,
    code_dtype,
    f32_div,
    log_compress,
    log_expand,
)
from repro_torch.core.wire import SymmetricWire, as_wire

__all__ = [
    "WireCodec",
    "Float32Codec",
    "LogQuantCodec",
    "QSGDCodec",
    "DitheredLogQuantCodec",
    "LayeredRandQuantCodec",
    "value_unbiased_round",
    "ModelBlock",
    "WorkerRows",
    "draw",
    "draw_values",
    "register_codec",
    "make_codec",
    "available_codecs",
    "codec_phase",
    "phase_collectives",
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
# the draws of the randomized codecs
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelBlock:
    """This rank's block of a per-worker tensor split over a model axis:
    ``comm`` (a ``core.comm.ModelComm``), the whole tensor's per-worker
    shape ``view`` and the dim of ``view`` the axis cuts. ``view`` unflattens
    a dim where the axis cuts one of its factors (the rows of a (cb, V, d)
    leaf's P factor, split on V, are a block of every codebook's), so the
    block is ``view`` narrowed to the rank's 1/M of ``dim``, flattened back
    to the block's own shape."""

    comm: Any
    view: tuple[int, ...]
    dim: int

    @property
    def size(self) -> int:
        return self.comm.size

    def max(self, x: torch.Tensor, tag: str) -> torch.Tensor:
        return self.comm.max(x, tag)

    def cut(self, whole: torch.Tensor) -> torch.Tensor:
        """The rank's block of ``whole``: leading dims, then ``view``."""
        n = self.view[self.dim] // self.comm.size
        lead = whole.dim() - len(self.view)
        return whole.narrow(lead + self.dim, self.comm.rank * n, n)


@dataclasses.dataclass(frozen=True)
class WorkerRows:
    """A codec key over a process's share of a tensor: ``gen`` draws the
    values of all ``n`` workers of the whole (N, ...) tensor, as one process
    holding every worker and the whole tensor draws them, and the process
    keeps ``rows`` and, over a model axis, its ``block``."""

    gen: torch.Generator
    rows: slice
    n: int
    block: ModelBlock | None = None


def worker_key(
    key: torch.Generator | None, comm, block: ModelBlock | None = None
) -> Any:
    """``key`` over ``comm``'s workers: as it is where the process holds all
    of them and the whole tensor, else a :class:`WorkerRows` of its rows
    and ``block``."""
    if key is None or (comm.local_size() == comm.size() and block is None):
        return key
    return WorkerRows(key, comm.workers(), comm.size(), block)


def draw_values(kind: str, shape, gen: torch.Generator, device, high: int = 0):
    """One draw from ``gen``: 'rand' (uniform [0, 1)), 'randn' or 'randint'
    (in [0, high))."""
    if kind == "rand":
        return torch.rand(shape, generator=gen, device=device)
    if kind == "randn":
        return torch.randn(shape, generator=gen, device=device)
    return torch.randint(0, high, shape, generator=gen, device=device)


def draw(kind: str, x: torch.Tensor, key, high: int = 0) -> torch.Tensor:
    """A :func:`draw_values` of ``x``'s shape from ``key``; over a
    :class:`WorkerRows` ``x`` leads with this process's workers, and the
    draw covers all N of them (the one-process stream) before keeping the
    rows; with a ``block`` it covers the whole tensor and keeps the block
    (one draw a call, freed once cut)."""
    if not isinstance(key, WorkerRows):
        return draw_values(kind, tuple(x.shape), key, x.device, high)
    if key.block is None:
        shape = (key.n,) + tuple(x.shape[1:])
        return draw_values(kind, shape, key.gen, x.device, high)[key.rows]
    whole = draw_values(kind, (key.n,) + key.block.view, key.gen, x.device, high)
    return key.block.cut(whole[key.rows]).reshape(x.shape)


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
    epsilon_kind: str | None = None
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

    def privacy_sigma(self) -> float:
        """Std of the injected noise in normalized units: none."""
        return 0.0

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

    Needs a key per call (per tensor, per step; one draw covers every
    worker of a (N, ...) tensor, :func:`draw`). The draws are the port's
    own: they cannot reproduce ``jax.random``, so the codec is held to the
    reference statistically, and its wire bits exactly. Its rounding noise
    has bounded support, so ``epsilon_per_use`` stays ``inf``: no (epsilon,
    delta) claim under the Gaussian accountant."""

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
        rnd = draw("rand", x, key)
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


def value_unbiased_round(
    q: torch.Tensor,
    step: torch.Tensor | float,
    levels: int,
    alpha: float,
    u: torch.Tensor,
) -> torch.Tensor:
    """Round continuous log-domain codes ``q`` onto the multiples of ``step``
    (clipped at +-levels), up with probability ``p`` where ``u < p``: unbiased
    in the VALUE domain, E[log_expand(c / L)] = log_expand(q / L).

    Dithering in the log domain would be biased through the convex expand
    map, so ``p`` is taken between the two candidate reconstruction values
    v0, v1: p = (v - v0) / (v1 - v0). ``u`` holds uniform [0, 1) draws of
    q's shape; the arithmetic is the JAX package's ``_value_unbiased_round``
    op for op, so the same draws give the same codes."""
    g0 = torch.floor(q / step) * step
    g1 = torch.clamp(g0 + step, -levels, levels)
    g0 = torch.clamp(g0, -levels, levels)
    v0 = log_expand(f32_div(g0, levels), alpha)
    v1 = log_expand(f32_div(g1, levels), alpha)
    # == x up to f32 error; recomputed so noise added to x stays consistent
    v = log_expand(f32_div(q, levels), alpha)
    p = torch.clamp((v - v0) / torch.clamp(v1 - v0, min=1e-12), 0.0, 1.0)
    return torch.where(u < p, g1, g0)


class _RandomizedLogCodec(LogQuantCodec):
    """The log grid with randomized rounding: ``codes`` is the deterministic
    ``noised_codes`` of ``draws`` from the generator. Without a key (the
    zero-noise configuration, which rejects one) it is ``log`` outright."""

    def draws(
        self, x: torch.Tensor, key: torch.Generator | WorkerRows
    ) -> tuple[torch.Tensor | None, torch.Tensor | None, torch.Tensor | None]:
        """``(noise, u, layer)`` for ``x``, each of x's shape or None, in
        that order from ``key`` (:func:`draw`)."""
        raise NotImplementedError

    def noised_codes(
        self,
        x: torch.Tensor,
        noise: torch.Tensor | None,
        u: torch.Tensor | None,
        layer: torch.Tensor | None,
    ) -> torch.Tensor:
        """The codes of f32 ``x`` given the draws: deterministic."""
        raise NotImplementedError

    def codes(self, x, *, key=None):
        self._check_key(key)
        if key is None:  # zero noise: exactly the deterministic codec
            return super().codes(x)
        x = x.float()
        return self.noised_codes(x, *self.draws(x, key))

    def encode(self, x, *, key=None):
        self._check_key(key)
        if key is None:
            return super().encode(x)
        # the fused encode + pack kernel is deterministic: the randomized
        # codes come from plain torch, their pack from the nibble kernel
        c = self.codes(x, key=key)
        if self.bits <= 4:
            from repro_torch.kernels import ops

            return ops.pack_nibbles(c)
        return c.reshape(-1)


@register_codec("dlog")
@dataclasses.dataclass(frozen=True)
class DitheredLogQuantCodec(_RandomizedLogCodec):
    """Dithered log-quantizer with an optional per-use DP budget (arXiv
    2304.13545: quantization randomness as the privacy mechanism).

    ``log``'s wire format, packing and ``wire_bits``. With ``dither=True``
    codes are stochastically rounded, unbiased in the value domain (over
    generators, E[expand(codes(x))] = x). With ``dp_epsilon > 0``, Gaussian
    noise of std ``accounting.gaussian_sigma(dp_epsilon, dp_delta)`` is added
    to the normalized value before rounding; quantization is
    post-processing, so the (dp_epsilon, dp_delta) guarantee survives it per
    use. A noised ``|x| > 1`` saturates at +-levels.

    The zero-noise configuration (``dither=False, dp_epsilon=0``) rejects a
    key and is the ``log`` codec bit for bit."""

    dither: bool = True
    dp_epsilon: float = 0.0
    dp_delta: float = 1e-5

    def __post_init__(self):
        if self.dp_epsilon < 0:
            raise ValueError(f"dp_epsilon must be >= 0, got {self.dp_epsilon}")
        if not 0.0 < self.dp_delta < 1.0:
            raise ValueError(f"dp_delta must be in (0, 1), got {self.dp_delta}")

    @property
    def requires_key(self) -> bool:
        return bool(self.dither or self.dp_epsilon > 0)

    @property
    def epsilon_kind(self) -> str | None:
        return "calibrated" if self.dp_epsilon > 0 else None

    def privacy_sigma(self) -> float:
        if self.dp_epsilon <= 0:
            return 0.0
        # a late import: privacy/__init__ imports the harness, which imports
        # the compressors, which import this module
        from repro_torch.core.privacy.accounting import gaussian_sigma

        return gaussian_sigma(self.dp_epsilon, self.dp_delta)

    def epsilon_per_use(self, delta: float = 1e-5) -> float:
        del delta  # calibrated against self.dp_delta, not the caller's
        return self.dp_epsilon if self.dp_epsilon > 0 else math.inf

    def draws(self, x, key):
        noise = u = None
        if self.dp_epsilon > 0:
            noise = draw("randn", x, key)
        if self.dither:
            u = draw("rand", x, key)
        return noise, u, None

    def noised_codes(self, x, noise, u, layer=None):
        lv = self._cfg.levels
        if noise is not None:
            x = x + self.privacy_sigma() * noise
        q = log_compress(x, self.alpha) * lv
        if self.dither:
            c = value_unbiased_round(q, 1.0, lv, self.alpha, u)
        else:  # noise only: the noised value rounded half to even
            c = torch.round(q)
        return torch.clamp(c, -lv, lv).to(code_dtype(self.bits))


@register_codec("lrq")
@dataclasses.dataclass(frozen=True)
class LayeredRandQuantCodec(_RandomizedLogCodec):
    """Layered randomized quantizer (arXiv 2312.07060).

    Each element draws one of ``n_layers`` nested coarsenings of the log
    grid (layer j keeps the codes that are multiples of 2^j) and is rounded
    onto it, unbiased in the value domain. Coarser layers add more rounding
    noise, so the mixture widens the output distribution, while every code
    stays a valid b-bit code: ``log``'s wire format and bits, and the
    receiver needs none of the sender's draws.

    ``epsilon_per_use`` is a Gaussian-equivalent proxy from the mixture's
    rounding-noise variance (``epsilon_kind='gaussian_equiv'``): the noise
    has bounded support, so it is a comparison heuristic, not a calibrated
    guarantee. The zero-noise configuration (``n_layers=1, dither=False``)
    is the ``log`` codec bit for bit."""

    n_layers: int = 2
    dither: bool = True

    def __post_init__(self):
        if not 1 <= self.n_layers <= self.bits - 1:
            raise ValueError(
                f"n_layers must be in [1, bits-1] = [1, {self.bits - 1}], "
                f"got {self.n_layers}"
            )
        if self.n_layers > 1 and not self.dither:
            raise ValueError(
                "n_layers > 1 requires dither=True: deterministic rounding "
                "on a random layer is biased"
            )

    @property
    def requires_key(self) -> bool:
        return bool(self.n_layers > 1 or self.dither)

    @property
    def epsilon_kind(self) -> str | None:
        return "gaussian_equiv" if self.requires_key else None

    def privacy_sigma(self) -> float:
        """Worst-case rounding-noise std in normalized log-domain units:
        layer j contributes a Bernoulli variance <= (2^j / 2)^2 code units,
        averaged over the uniform layer draw."""
        if not self.requires_key:
            return 0.0
        var_codes = sum(4.0**j for j in range(self.n_layers)) / (4.0 * self.n_layers)
        return math.sqrt(var_codes) / self._cfg.levels

    def epsilon_per_use(self, delta: float = 1e-5) -> float:
        from repro_torch.core.privacy.accounting import gaussian_epsilon

        return gaussian_epsilon(self.privacy_sigma(), delta)

    def draws(self, x, key):
        layer = None
        if self.n_layers > 1:
            layer = draw("randint", x, key, high=self.n_layers)
        u = draw("rand", x, key)
        return None, u, layer

    def noised_codes(self, x, noise, u, layer):
        lv = self._cfg.levels
        q = log_compress(x, self.alpha) * lv
        step = 1.0 if layer is None else torch.exp2(layer.float())
        c = value_unbiased_round(q, step, lv, self.alpha, u)
        return torch.clamp(c, -lv, lv).to(code_dtype(self.bits))


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
    workers; it encodes as the zero pad code the per-worker encode adds (a
    randomized codec's codes are padded instead)."""
    rows = x.reshape(x.shape[0], -1)
    if codec.bits <= 4 and rows.shape[1] % 2:
        if codec.requires_key:
            # a draw may give a zero pad value a nonzero code (dlog's noise):
            # pad the codes with the zero code instead
            from repro_torch.kernels import ops

            codes = F.pad(codec.codes(rows, key=key), (0, 1))
            return ops.pack_nibbles(codes.contiguous()).reshape(x.shape[0], -1)
        rows = F.pad(rows, (0, 1))
    wire = codec.encode(rows.contiguous(), key=key)
    return wire.reshape(x.shape[0], -1)


def phase_collectives(n: int, codec: WireCodec, *, wire: str, fuse: bool) -> int:
    """The collectives one :func:`codec_phase` over ``n`` tensors issues:
    the scale pmax (one fused, else one a tensor) and the payload (a psum a
    tensor under ``psum_sim``, else one fused gather or one a tensor)."""
    if n == 0:
        return 0
    scales = (1 if fuse else n) if codec.needs_scale else 0
    return scales + (n if wire == "psum_sim" or not fuse else 1)


def _model_max(local: list[torch.Tensor], split: Sequence[Any]) -> list[torch.Tensor]:
    """``local`` with every split tensor's maxima replaced by their max over
    its model group: one all-reduce for all of them (they share a group)."""
    idx = [j for j, c in enumerate(split) if c is not None]
    if not idx:
        return local
    flat = torch.cat([local[j].reshape(-1) for j in idx])
    parts = split[idx[0]].max(flat, "tp.scale").split([local[j].numel() for j in idx])
    out = list(local)
    for j, part in zip(idx, parts):
        out[j] = part.reshape(local[j].shape)
    return out


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
    split: Sequence[ModelBlock | None] | None = None,
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

    ``keys`` are the tensors' generators, for a codec that draws; over a
    comm whose process holds k < N workers each draws all N workers' values
    and keeps the process's rows (:func:`worker_key`).

    ``rec`` is charged each worker's actual bits of every encoded array plus
    32 per scale, unless ``account_bits`` overrides the payload (TopK's
    sparse accounting over a dense simulation). Collective counts include
    the scale pmax: one when fused, else one per tensor. ``rec.phys_bits``
    is charged what each worker actually encodes (codes as shipped, f32
    codes under ``psum_sim``) plus 32 per scale.

    ``split[i]``, a :class:`ModelBlock` (None: whole), says that tensor i is
    this rank's block of a tensor split over a model axis: its scale is the
    max over the axis too (one model-axis all-reduce for all such tensors,
    before the data-axis pmax), its draws are the whole tensor's cut to the
    block (:func:`draw`), the data-axis collectives carry the rank's block,
    and ``rec``'s static tier is charged the whole tensor's payload (the JAX
    package's accounting), ``phys_bits`` the block's. Returns the synced
    tensors, one per input, in the input's per-worker shape (no worker dim):
    every worker holds the same values.
    """
    n = len(xs)
    if n == 0:
        return []
    wt = as_wire(comm)
    split = list(split) if split is not None else [None] * n
    whole = [1 if c is None else c.size for c in split]  # blocks of the tensor
    # a process of k < N workers draws all N workers' values, keeps its rows;
    # a rank's block of a model-split tensor draws the whole, keeps its block
    keys = (
        [worker_key(k, wt, blk) for k, blk in zip(keys, split)]
        if keys is not None
        else [None] * n
    )
    xs = [x.float() for x in xs]

    # ---- shared quantization grid: per-instance global max ---------------
    if codec.needs_scale:
        local = [_local_absmax(x, st) for x, st in zip(xs, stacked_flags)]
        local = _model_max(local, split)
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
                account_bits[i]
                if account_bits is not None
                else codec.wire_bits(numel * whole[i])
            )
            rec.add(payload + codec.scale_bits(ns), 1)
            rec.add_phys(numel * 32 + codec.scale_bits(ns))
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
    for i, (w, x, ns) in enumerate(zip(wires, xs, n_scales)):
        shipped = w[0].numel() * w.element_size() * 8
        if account_bits is not None:
            payload = account_bits[i]
        elif whole[i] > 1:
            payload = codec.wire_bits(x[0].numel() * whole[i])
        else:
            payload = shipped
        rec.add(payload + codec.scale_bits(ns), 0)
        rec.add_phys(shipped + codec.scale_bits(ns))
    if fuse:
        gathered = wt.fused_all_gather(wires)
        rec.n_collectives += 1
    else:
        gathered = [wt.all_gather(w) for w in wires]
        rec.n_collectives += n

    outs = []
    for g, x, safe in zip(gathered, xs, safes):
        # the gather holds all N workers; x, this process's k of them
        codes = codec.decode(g, x[0].numel()).reshape(g.shape[:1] + x.shape[1:])
        if avg_mode == "paper":
            val = codec.expand(wt.average(codes))
        else:
            val = wt.average(codec.expand(codes))
        outs.append(_rescale(val, safe))
    return outs
