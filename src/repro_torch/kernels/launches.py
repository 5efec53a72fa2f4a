"""Launch counts of the hand-written kernels: the launches that ran on the card.

Each kernel wrapper carries a ``launches`` integer and calls :func:`count`
with itself where it launches its kernel. An eager launch runs at once and
is counted at once. While a CUDA graph is being captured nothing runs: under
:func:`recording` (what ``repro_torch.graphs`` opens around a capture) the
launch goes into the capture's record instead, and :func:`replayed` adds
that record to the counts once per replay of the graph. A capture outside
:func:`recording`, such as a graph built only to time a kernel, counts
nothing, at capture or at replay.

The bookkeeping is plain Python over any object with a ``launches``
attribute, so the tests hold it on the CPU.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from collections.abc import Iterator

import torch

__all__ = ["count", "recording", "replayed"]

# the record of the capture in progress under ``recording``, else None
_record: Counter | None = None


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def count(wrapper) -> None:
    """One launch by ``wrapper``: counted, or written into the open record."""
    if _record is not None:
        _record[wrapper] += 1
    elif not _capturing():
        wrapper.launches += 1


@contextlib.contextmanager
def recording() -> Iterator[Counter]:
    """Inside the block, :func:`count` writes into the yielded record (a
    ``Counter`` of wrapper -> launches) and counts nothing."""
    global _record
    if _record is not None:
        raise RuntimeError("a capture is already being recorded")
    _record = Counter()
    try:
        yield _record
    finally:
        _record = None


def replayed(record: Counter, times: int = 1) -> None:
    """Add ``times`` replays of a recorded capture to the counts."""
    for wrapper, n in record.items():
        wrapper.launches += n * times
