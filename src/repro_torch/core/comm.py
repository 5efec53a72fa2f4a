"""Collectives over simulated workers + wire-byte accounting.

One card runs all N data-parallel workers: every per-worker tensor carries
the workers as its leading dimension, as ``jax.vmap(..., axis_name=...)``
does for the JAX package's collectives. :class:`SimComm` gives the
reference's collective semantics on that layout:

* ``pmax`` / ``psum`` / ``pmean`` reduce over dim 0 and return ONE tensor
  without the worker dim: the value every worker holds after the collective;
* ``all_gather`` returns the stacked (N, ...) tensor, which is what every
  worker holds after the gather (one copy serves them all).

Byte accounting is static (plain Python ints from shapes), as in the JAX
package, so tables never need device work. A ``torch.distributed`` backend
of the same surface is the multi-GPU slice's work.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import torch

__all__ = ["CommRecord", "SimComm"]


@dataclasses.dataclass
class CommRecord:
    """Accumulated wire accounting for one sync call (per worker, bits).

    ``add`` is the static tier every eager compressor uses; ``add_down``
    charges the server's broadcast (the server wire). The JAX package's
    gated tier (``add_gated``, lazy aggregation) is not ported yet."""

    bits_sent: int = 0  # payload each worker puts on the wire
    n_collectives: int = 0
    down_bits: int = 0  # server->worker broadcast payload (server wire)

    def add(self, bits: int, n: int = 1) -> None:
        self.bits_sent += int(bits)
        self.n_collectives += n

    def add_gated(self, bits: int, n: int, gate) -> None:
        raise NotImplementedError(
            "gated accounting belongs to lazy aggregation, which is not ported "
            "yet (ROADMAP Queue 1, item 11)"
        )

    def add_down(self, bits: int) -> None:
        self.down_bits += int(bits)


class SimComm:
    """N simulated workers on a leading dimension of every per-worker tensor.

    With ``record=True`` every gathered tensor is kept in ``gathered``, in
    the order of the gathers (a fused gather records its one flat buffer),
    so a run's exact wire can be compared with another's."""

    def __init__(self, n_workers: int, *, record: bool = False):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self.n_workers = n_workers
        self.gathered: list[torch.Tensor] | None = [] if record else None

    def size(self) -> int:
        return self.n_workers

    def _check(self, x: torch.Tensor) -> None:
        if x.dim() == 0 or x.shape[0] != self.n_workers:
            raise ValueError(
                f"want a leading worker dim of {self.n_workers}, got {tuple(x.shape)}"
            )

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        return x.sum(0)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        return x.mean(0)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        return x.amax(0)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every worker's ``x[w]`` -> the stacked (N, ...) tensor."""
        self._check(x)
        if self.gathered is not None:
            self.gathered.append(x)
        return x

    def fused_all_gather(self, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """ONE gather of every (N, ...) payload in ``xs``, concatenated flat
        per worker; returns per-input (N, numel) slices. All inputs share a
        dtype (one wire phase = one code dtype)."""
        if not xs:
            return []
        if len({x.dtype for x in xs}) != 1:
            raise ValueError(
                "fused_all_gather requires a single dtype; got "
                f"{[str(x.dtype) for x in xs]}"
            )
        n = self.n_workers
        g = self.all_gather(torch.cat([x.reshape(n, -1) for x in xs], dim=1))
        sizes = [x[0].numel() for x in xs]
        return list(torch.split(g, sizes, dim=1))

    def fused_pmax(self, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """ONE pmax over every (N, ...) tensor in ``xs``; per-input shapes
        without the worker dim. Scale reductions are f32 by contract."""
        if not xs:
            return []
        bad = [str(x.dtype) for x in xs if x.dtype != torch.float32]
        if bad:
            raise ValueError(
                "fused_pmax requires float32 inputs (scale reductions are f32 "
                f"by contract); got {bad}"
            )
        n = self.n_workers
        m = self.pmax(torch.cat([x.reshape(n, -1) for x in xs], dim=1))
        parts = torch.split(m, [x[0].numel() for x in xs])
        return [p.reshape(x.shape[1:]) for p, x in zip(parts, xs)]
