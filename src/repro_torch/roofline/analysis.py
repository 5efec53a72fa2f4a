"""Roofline terms of a dry-run record: the port's counterpart of the JAX
package's ``roofline/analysis.py``, on the H100 cluster's constants.

    compute    = FLOPs a card / PEAK_FLOPS_BF16
    memory     = bytes a card / HBM_BW
    collective = model-axis wire a card / NVLINK_BW
                 + data-axis wire a card / IB_BW

The FLOPs and bytes are one rank's, counted from the ops its step runs
(``roofline/fake_trace.py``); the bytes are the unfused eager traffic, an
upper bound where the JAX package reads XLA's post-fusion "bytes
accessed". There is no HLO to parse: the collectives are the comms' own
books (``core/comm.py``: each tag's calls, bytes out and op), which stand
where ``parse_collectives`` reads the compiled module, and each is charged
with the JAX package's ring conventions (:func:`_wire_bytes`). The JAX
package charges every collective to one ICI link; the port's mesh has two
fabrics, so the model axis (the 8 cards of a node) is charged to a card's
NVLink rate and the data axis (across nodes) to its InfiniBand port, and
both parts are reported.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.roofline import hw

__all__ = [
    "CollectiveStats",
    "collective_stats",
    "model_flops",
    "RooflineReport",
]


@dataclasses.dataclass
class CollectiveStats:
    counts: dict[str, int]  # calls per op kind
    out_bytes: dict[str, int]  # sum of output bytes per op kind
    wire_bytes: int  # ring-model per-device payload

    def total_out(self) -> int:
        return sum(self.out_bytes.values())


def _wire_bytes(op: str, nbytes: int) -> int:
    """Per-device wire payload under a ring model (the JAX package's).

    all-reduce: 2x payload (reduce-scatter + all-gather phases);
    all-gather: output bytes (each device forwards ~(N-1)/N of the output);
    reduce-scatter: output is 1/N of the reduced tensor; wire ~= N*out ~ in;
      only the output shape is seen, so out*2 is charged as a lower-ish
      bound;
    all-to-all / collective-permute: payload once.
    """
    if op == "all-reduce":
        return 2 * nbytes
    if op == "all-gather":
        return nbytes
    if op == "reduce-scatter":
        return 2 * nbytes
    return nbytes


def collective_stats(book: dict[str, Any] | None) -> CollectiveStats:
    """A comm's books over a step (``fake_trace.count``'s per axis: each
    tag's calls, bytes out and op) as per-op counts, output bytes and
    ring-model wire bytes."""
    counts: dict[str, int] = {}
    out_bytes: dict[str, int] = {}
    wire = 0
    book = book or {"calls": {}}
    for tag, n in book["calls"].items():
        op, nbytes = book["ops"][tag], book["bytes"][tag]
        counts[op] = counts.get(op, 0) + n
        out_bytes[op] = out_bytes.get(op, 0) + nbytes
        wire += _wire_bytes(op, nbytes)
    return CollectiveStats(counts, out_bytes, wire)


def model_flops(n_params_active: int, tokens: int) -> float:
    """6·N·D (dense): pass the active parameters for MoE."""
    return 6.0 * n_params_active * tokens


def _add(a: dict[str, int], b: dict[str, int]) -> dict[str, int]:
    return {k: a.get(k, 0) + b.get(k, 0) for k in sorted({*a, *b})}


@dataclasses.dataclass
class RooflineReport:
    flops_per_device: float
    bytes_per_device: float
    model_axis: CollectiveStats  # within a node: NVLink
    data_axis: CollectiveStats  # across nodes: InfiniBand
    chips: int

    compute_s: float = 0.0
    memory_s: float = 0.0
    model_collective_s: float = 0.0
    data_collective_s: float = 0.0
    collective_s: float = 0.0

    def __post_init__(self):
        self.compute_s = self.flops_per_device / hw.PEAK_FLOPS_BF16
        self.memory_s = self.bytes_per_device / hw.HBM_BW
        self.model_collective_s = self.model_axis.wire_bytes / hw.NVLINK_BW
        self.data_collective_s = self.data_axis.wire_bytes / hw.IB_BW
        self.collective_s = self.model_collective_s + self.data_collective_s

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        m, d = self.model_axis, self.data_axis
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_wire_bytes": m.wire_bytes + d.wire_bytes,
            "collective_counts": _add(m.counts, d.counts),
            "collective_out_bytes": _add(m.out_bytes, d.out_bytes),
            "model_axis_wire_bytes": m.wire_bytes,
            "model_axis_counts": m.counts,
            "data_axis_wire_bytes": d.wire_bytes,
            "data_axis_counts": d.counts,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "model_collective_s": self.model_collective_s,
            "data_collective_s": self.data_collective_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "chips": self.chips,
        }
