"""Wire topologies: how one compressor sync round moves bytes.

Handlers talk to the network through a *wire* that exposes the
:class:`~repro_torch.core.comm.SimComm` surface plus the one decision the
topology owns: how gathered per-worker payloads are aggregated.
:class:`SymmetricWire` is the all-reduce among peers: ``average`` is the
plain mean over the worker dim. The parameter-server wire (participation
draws, weighted aggregation, the downlink tier) is not ported yet.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from repro_torch.core.comm import CommRecord, SimComm

__all__ = ["SymmetricWire", "as_wire"]


class SymmetricWire:
    """All-reduce among peers: the identity wrapper over a comm."""

    kind = "symmetric"

    def __init__(self, comm: SimComm):
        self.comm = comm

    def size(self) -> int:
        return self.comm.size()

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


def as_wire(
    comm: SimComm | SymmetricWire, *, topology: str = "symmetric"
) -> SymmetricWire:
    """Wrap a bare comm in the requested wire; pass a wire through."""
    if isinstance(comm, SymmetricWire):
        return comm
    if topology == "symmetric":
        return SymmetricWire(comm)
    if topology == "server":
        raise NotImplementedError(
            "the server wire is not ported yet (ROADMAP Queue 1, item 12)"
        )
    raise ValueError(
        f"unknown wire topology {topology!r}; options: 'symmetric', 'server'"
    )
