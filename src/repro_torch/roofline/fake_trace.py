"""Counters of one step traced over fake tensors: the port's counterpart
of what the JAX dry run reads off its compiled module.

The JAX dry run compiles one rank's step for the production mesh and
reads ``cost_analysis()`` (FLOPs, bytes accessed), ``memory_analysis()``
(argument, output, temporary bytes) and the collectives of its HLO. The
port has no compiler: ``launch/dryrun.py`` runs one rank's step eagerly
inside :func:`fake_mode` (``FakeTensorMode``: every tensor has a shape, a
dtype and a device, and no memory), and :func:`count` reads four counts
off the ops that run, in one dispatch mode (:class:`StepCounter`):

* **FLOPs**: ``torch.utils.flop_counter``'s formulas, the ones
  ``FlopCounterMode`` applies (2·M·N·K a product, the backward's too).
* **Bytes**: the bytes every ``aten`` op reads and writes, each tensor
  input plus each output at its own size, with views, aliases and
  allocations (``empty``) free. This is the unfused eager traffic: an upper
  bound of the HBM bytes, where XLA's post-fusion "bytes accessed" keeps
  a fused chain's intermediates in registers. Tensors on the ``meta``
  device (shapes a step reads a layout from) count nowhere.
* **Peak live bytes**: the same dispatch mode over storages (not
  ``torch.distributed._tools.mem_tracker.MemTracker``, whose interface is
  private and differs between PyTorch releases): each storage an op
  returns is counted live from its first appearance until it is freed (a
  weak reference's callback), on top of the tensors passed in ``live``
  (the step's arguments); the peak is the largest sum. It counts storage
  bytes as they are, without the caching allocator's rounding or a
  library's workspaces.
* **Collectives by axis**: the comms' own books (``core/comm.py``:
  ``ModelComm`` and ``DistComm`` keep each tag's calls, bytes out, bytes
  sent and op), as the difference over the block.

The fake process group (``launch/mesh.py:init_fake_distributed``) returns
every collective at once, so a rank's step runs alone. A value read on the
host (``.item()``) raises under fake tensors, as it would break a CUDA
graph's capture; a kernel's wrapper refuses a fake CUDA tensor
(``kernels/ops.py``), so a trace runs the plain versions
(``ops.reference_mode()``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections.abc import Iterable, Iterator
from typing import Any

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["TraceCounts", "fake_mode", "count", "StepCounter", "book_diff"]

_aten = torch.ops.aten
# ops that move no bytes though their schema is not a view: allocations
# whose values are never read, and views written without an alias
_FREE = {
    _aten.empty.memory_format,
    _aten.empty_strided.default,
    _aten.empty_like.default,
    _aten.new_empty.default,
    _aten.new_empty_strided.default,
    _aten._unsafe_view.default,
    _aten.lift_fresh.default,
}


@dataclasses.dataclass
class TraceCounts:
    """What :func:`count` read off a block: ``flops``, ``bytes`` (the
    unfused eager traffic), ``arg_bytes`` (live at entry: the tensors
    passed in), ``peak_bytes`` (the most live at once), ``end_bytes`` (live
    at exit) and ``collectives`` (axis -> the comms' books over the
    block, summed)."""

    flops: int = 0
    bytes: int = 0
    arg_bytes: int = 0
    peak_bytes: int = 0
    end_bytes: int = 0
    collectives: dict[str, dict[str, Any]] = dataclasses.field(default_factory=dict)


def fake_mode() -> FakeTensorMode:
    """The fake-tensor mode a dry run traces in (a real tensor met inside
    it, a module's constant, is taken as a fake one)."""
    return FakeTensorMode(allow_non_fake_inputs=True)


def _tensors(xs: Any) -> list[torch.Tensor]:
    """The tensors among ``xs`` (an op's arguments or outputs: tensors, and
    lists or tuples of them) that hold memory, not the ``meta`` device's
    shape-only ones, which a step may make to read a layout."""
    out = []
    for x in xs if isinstance(xs, (list, tuple)) else (xs,):
        if isinstance(x, torch.Tensor):
            if x.device.type != "meta":
                out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(_tensors(x))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """One dispatch mode for the three counts of the ops that run:

    * ``flops``: ``torch.utils.flop_counter``'s formula of each op (the
      registry ``FlopCounterMode`` reads; tests hold the two equal);
    * ``bytes``: each ``aten`` op's tensor inputs and outputs at their own
      sizes, views and the ops of ``_FREE`` counting nothing;
    * ``live`` / ``peak``: the storages alive, every storage an op returns
      and those :meth:`track` is given counted from their first
      appearance until they are freed (a weak reference's callback)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._refs: dict[int, weakref.ref] = {}
        self._moves: dict[Any, bool] = {}

    def track(self, t: torch.Tensor) -> None:
        if t.device.type == "meta":
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs:
            return
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)

        def freed(_, key=key, n=n):
            self.live -= n
            self._refs.pop(key, None)

        self._refs[key] = weakref.ref(st, freed)

    def _moves_bytes(self, func) -> bool:
        moves = self._moves.get(func)
        if moves is None:
            moves = func.namespace == "aten" and not func.is_view
            moves = self._moves[func] = moves and func not in _FREE
        return moves

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        outs = _tensors(out)
        if self._moves_bytes(func):
            moved = _tensors(args) + _tensors(list(kwargs.values())) + outs
            self.bytes += sum(_nbytes(t) for t in moved)
        for t in outs:
            self.track(t)
        return out


def book_diff(after: dict[str, Any], before: dict[str, Any]) -> dict[str, Any]:
    """The books ``after`` less ``before`` (two ``stats()``), tags with
    no call in between dropped."""
    out = {"calls": {}, "bytes": {}, "sent": {}, "ops": {}}
    for tag, n in after["calls"].items():
        calls = n - before["calls"].get(tag, 0)
        if calls:
            out["calls"][tag] = calls
            out["ops"][tag] = after["ops"][tag]
            for k in ("bytes", "sent"):
                out[k][tag] = after[k][tag] - before[k].get(tag, 0)
    return out


def _merge(books: list[dict[str, Any]]) -> dict[str, Any]:
    out = {"calls": {}, "bytes": {}, "sent": {}, "ops": {}}
    for b in books:
        for tag in b["calls"]:
            out["ops"][tag] = b["ops"][tag]
            for k in ("calls", "bytes", "sent"):
                out[k][tag] = out[k].get(tag, 0) + b[k][tag]
    return out


@contextlib.contextmanager
def count(
    live: Iterable[torch.Tensor] = (), comms: dict[str, list[Any]] | None = None
) -> Iterator[TraceCounts]:
    """Inside a :func:`fake_mode` block: the yielded :class:`TraceCounts`
    is filled in when the block ends. ``live`` are the tensors alive at
    entry that the block reads (the step's arguments); ``comms`` maps an
    axis name to the comms whose books count for it (each comm once)."""
    comms = comms or {}
    counts = TraceCounts()
    seen: set[int] = set()
    by_axis = {}
    for axis, cs in comms.items():
        by_axis[axis] = [c for c in cs if id(c) not in seen and not seen.add(id(c))]
    before = {axis: [c.stats() for c in cs] for axis, cs in by_axis.items()}
    counter = StepCounter()
    for t in live:
        counter.track(t)
    counts.arg_bytes = counter.live
    with counter:
        yield counts
    counts.flops = counter.flops
    counts.bytes = counter.bytes
    counts.peak_bytes = counter.peak
    counts.end_bytes = counter.live
    for axis, cs in by_axis.items():
        diffs = [book_diff(c.stats(), b) for c, b in zip(cs, before[axis])]
        counts.collectives[axis] = _merge(diffs)
