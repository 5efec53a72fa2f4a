"""Wire topologies: how one compressor sync round moves bytes.

Handlers talk to the network through a *wire* that exposes the
:class:`~repro_torch.core.comm.SimComm` surface plus the one decision the
topology owns: how gathered per-worker payloads are aggregated.

* :class:`SymmetricWire`: the all-reduce among peers; ``average`` is the
  plain mean over the worker dim.
* :class:`ServerWire`: a parameter-server round simulated on the same
  collectives (the gather stands in for the workers' uploads, the
  aggregate every worker computes for the server's broadcast, charged as
  ``CommRecord.down_bits``). Each worker takes part in a round with
  probability ``participation``; the server averages with participation
  weights, or per element over the nonzero contributions
  (``agg='sparsity'``, FedDropoutAvg).

The scale phase stays a pmax over ALL workers either way: the shared
quantization grid must not move when a worker sits a round out.

The participation draw is the port's own: one ``torch.Generator`` a round,
on the device, seeded from ``(seed, step)``, gives the (N,) flags of every
worker (the JAX package folds the step and each worker's index into a PRNG
key, which the port cannot reproduce). Every process makes the whole draw,
with no collective, and its workers act on their rows of it
(``ServerWire.active``), so a round's flags do not depend on how the
workers are spread over ranks. A caller may give the round's (N,) flags
instead (``mask``), as the parity tests do with the JAX package's draws.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from repro_torch.core.comm import CommRecord, SimComm

__all__ = [
    "PARTICIPATION_FLAG_BITS",
    "ServerWire",
    "SymmetricWire",
    "as_wire",
    "participation_draw",
]

# uplink sideband of one participation round: each worker ships one f32
# flag into the weights gather
PARTICIPATION_FLAG_BITS = 32

# spawn key of the participation stream, apart from the leaves' streams
_PARTICIPATION_STREAM = 0x5E7


class SymmetricWire:
    """All-reduce among peers: the identity wrapper over a comm."""

    kind = "symmetric"

    def __init__(self, comm: SimComm):
        self.comm = comm

    @property
    def world(self) -> int:
        return self.comm.world

    def size(self) -> int:
        return self.comm.size()

    def local_size(self) -> int:
        return self.comm.local_size()

    def workers(self) -> slice:
        return self.comm.workers()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return self.comm.gather(x)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self.comm.psum(x)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        return self.comm.pmean(x)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self.comm.pmax(x)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return self.comm.all_gather(x)

    def fused_all_gather(self, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        return self.comm.fused_all_gather(xs)

    def fused_pmax(self, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        return self.comm.fused_pmax(xs)

    def prepare(self, rec: CommRecord) -> None:
        """Once-per-round sideband; the symmetric wire has none."""
        return None

    def average(self, stacked: torch.Tensor) -> torch.Tensor:
        """Aggregate gathered per-worker payloads (leading worker dim)."""
        return stacked.mean(0)

    def exact_mean(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`pmean`'s value taken locally over a gather, so it is
        SimComm's bit for bit at any world size (the warm-up's exact mean,
        off the accounted wire)."""
        return self.gather(x).mean(0)


def participation_draw(
    seed: int, step: int, n_workers: int, participation: float, device
) -> torch.Tensor:
    """The (N,) bool participation flags of round ``step``: one uniform
    draw a worker from a generator seeded by ``(seed, step)``, below
    ``participation``. The same arguments give the same flags."""
    seq = np.random.SeedSequence([seed, step], spawn_key=(_PARTICIPATION_STREAM,))
    mixed = int(seq.generate_state(1, np.uint64)[0]) >> 1
    gen = torch.Generator(device=device).manual_seed(mixed)
    return torch.rand(n_workers, generator=gen, device=device) < participation


def _per_worker(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return w.reshape((-1,) + (1,) * (like.dim() - 1))


class ServerWire(SymmetricWire):
    """Parameter-server round: per-worker participation + weighted average.

    ``participation`` is each worker's per-round probability of uploading
    (1.0 = everyone). ``agg``: ``'participation'`` divides by the number of
    participants; ``'sparsity'`` divides each element by its count of
    nonzero contributions, so sparse uploads (TopK) do not dilute each
    other. ``seed`` and ``step`` seed the round's draw; ``mask``, an (N,)
    bool tensor, gives the round's flags instead. ``device`` is where the
    draw is made. Over a comm whose process holds k of the N workers,
    :meth:`active` gives their k rows of the (N,) flags, and
    :meth:`prepare` gathers those into the (N,) weights."""

    kind = "server"

    def __init__(
        self,
        comm: SimComm,
        *,
        participation: float = 1.0,
        agg: str = "participation",
        seed: int = 0,
        step: int = 0,
        mask: torch.Tensor | None = None,
        device="cuda",
    ):
        super().__init__(comm)
        if not 0.0 < participation <= 1.0:
            raise ValueError(f"participation must be in (0, 1], got {participation}")
        if agg not in ("participation", "sparsity"):
            raise ValueError(
                f"unknown agg {agg!r}; options: 'participation', 'sparsity'"
            )
        if mask is not None and tuple(mask.shape) != (comm.size(),):
            raise ValueError(
                f"want a ({comm.size()},) participation mask, got {tuple(mask.shape)}"
            )
        self.participation = float(participation)
        self.agg = agg
        self.seed = int(seed)
        self.step = int(step)
        self.device = torch.device(device) if mask is None else mask.device
        self._flags = None if mask is None else mask.to(torch.bool)
        self._weights: torch.Tensor | None = None

    def _masking(self) -> bool:
        return self.participation < 1.0

    def active(self) -> torch.Tensor:
        """This process's workers' participation flags for the round, (k,)
        bool: their rows of every worker's (N,) flags, which each process
        derives whole (the draw needs no collective)."""
        if self._flags is None:
            n = self.size()
            if self._masking():
                self._flags = participation_draw(
                    self.seed, self.step, n, self.participation, self.device
                )
            else:
                self._flags = torch.ones(n, dtype=torch.bool, device=self.device)
        return self._flags[self.workers()]

    def prepare(self, rec: CommRecord) -> None:
        """Gather the round's participation flags (the server must learn who
        showed up: each worker ships its own) and charge the 32-bit
        sideband, once per sync."""
        if not self._masking() or self._weights is not None:
            return
        self._weights = self.all_gather(self.active().float())
        rec.add(PARTICIPATION_FLAG_BITS, 1)

    def weights(self) -> torch.Tensor | None:
        """Gathered per-worker participation weights, (N,) f32; ``None``
        when everyone participates (the plain mean)."""
        if self._masking() and self._weights is None:
            raise RuntimeError(
                "ServerWire.prepare(rec) must run before weighted aggregation: "
                "the participation gather is charged there"
            )
        return self._weights

    def average(self, stacked: torch.Tensor) -> torch.Tensor:
        w = self.weights()
        if self.agg == "sparsity":
            mask = (stacked != 0).float()
            if w is not None:
                mask = mask * _per_worker(w, stacked)
            denom = torch.clamp(mask.sum(0), min=1.0)
            return (stacked * mask).sum(0) / denom
        if w is None:
            return stacked.mean(0)
        wb = _per_worker(w, stacked)
        return (stacked * wb).sum(0) / torch.clamp(w.sum(), min=1.0)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """Participation-weighted mean of psum-shaped traffic (raw f32
        leaves, ``psum_sim``, the warm-up's exact mean): each worker scales
        its term by its own flag, and the denominator comes from the
        gathered weights; still one collective, and ``comm.pmean`` at full
        participation."""
        w = self.weights()
        if w is None:
            return self.comm.pmean(x)
        mine = _per_worker(self.active().to(x.dtype), x)
        return self.psum(x * mine) / torch.clamp(w.sum(), min=1.0).to(x.dtype)

    def exact_mean(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weights()
        if w is None:
            return super().exact_mean(x)
        g = self.gather(x)
        weighted = g * _per_worker(w.to(x.dtype), g)
        return weighted.sum(0) / torch.clamp(w.sum(), min=1.0).to(x.dtype)


def as_wire(
    comm: SimComm | SymmetricWire,
    *,
    topology: str = "symmetric",
    participation: float = 1.0,
    agg: str = "participation",
    seed: int = 0,
    step: int = 0,
    mask: torch.Tensor | None = None,
    device="cuda",
) -> SymmetricWire:
    """Wrap a bare comm in the requested wire; pass a wire through (so
    nested calls cannot wrap twice)."""
    if isinstance(comm, SymmetricWire):
        return comm
    if topology == "symmetric":
        return SymmetricWire(comm)
    if topology == "server":
        return ServerWire(
            comm,
            participation=participation,
            agg=agg,
            seed=seed,
            step=step,
            mask=mask,
            device=device,
        )
    raise ValueError(
        f"unknown wire topology {topology!r}; options: 'symmetric', 'server'"
    )
