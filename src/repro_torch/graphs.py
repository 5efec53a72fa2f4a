"""CUDA graphs of the port's steps: its counterpart of ``jax.jit`` over a step.

The JAX package jits a decode step or an attack step and runs the loop over
it as one ``lax.scan``, so a step costs one dispatch. Eager PyTorch
dispatches every kernel from the host, and a small-batch decode step or a
vmapped double backward then waits on the host most of the time. A
:class:`StepGraph` captures one step into a ``torch.cuda.CUDAGraph`` and
replays it:

* the first step runs eagerly, on a side stream, as the warm-up. It is a
  real step (a Mamba-2 decode updates its SSM state in place, so an extra
  step would move the state), and it compiles and loads every kernel the
  step launches;
* then one step is captured, after the warm-up's freed blocks are
  returned to the device (``torch.cuda.empty_cache``: the graph's private
  pool cannot reuse them, so a large step would otherwise hold two peaks).
  The step reads and writes only tensors that exist before the capture
  (parameters, caches, and the caller's static buffers for tokens,
  positions, counters and outputs), in place, so every replay works on
  the same addresses;
* the remaining steps are replays, with no host read between them.

Python's garbage collector is run before the warm-up and before the
capture and held off while each runs (:func:`collected`): a collection in
the middle of a capture can run the destructor of an older graph that a
reference cycle kept alive, a CUDA call that invalidates the capture (seen
after a graphed training run: ``tests/test_torch_cuda.py``).

A graph bakes in the ``ops.reference_mode()`` setting of its capture, so a
:class:`StepGraph` keeps one graph per setting and never replays a graph
under the other. Kernel launches are counted at replay
(``repro_torch.kernels.launches``). A capture or replay that fails raises;
there is no eager fallback. On the CPU callers run the same step eagerly.

A training step that syncs its gradients through a compressor is a
:class:`SyncStepGraph`: a :class:`StepGraph` bound to the state it updates
in place, which leaves to the host what a replay cannot do (reseeding the
compressor's per-leaf generators, advancing its host counters, keeping a
recording comm's gathers).
"""

from __future__ import annotations

import contextlib
import gc
import time
from collections.abc import Callable, Iterator, Sequence
from typing import Any

import torch

from repro_torch.core.tree import tree_leaves
from repro_torch.kernels import launches, ops

__all__ = ["use_graph", "collected", "StepGraph", "SyncStepGraph"]


def use_graph(graph: bool | None, device: torch.device | str) -> bool:
    """Resolve a caller's ``graph`` argument: None means a graph on CUDA and
    eager steps elsewhere; True where the device is not CUDA raises; False
    is eager, which only comparisons ask for."""
    device = torch.device(device)
    if graph is None:
        return device.type == "cuda"
    if graph and device.type != "cuda":
        raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
    return bool(graph)


@contextlib.contextmanager
def collected() -> Iterator[None]:
    """Collect Python's garbage now and hold the collector off inside the
    block (it is switched back on after, if it was on)."""
    gc.collect()
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


class StepGraph:
    """Runs ``step()``, a function of no arguments that updates tensors on
    ``device`` in place, as CUDA-graph replays (see the module doc).
    ``generators`` are the ``torch.Generator`` s the step draws from, other
    than the device's default one: each is registered with every graph, so
    a replay draws what the same eager step would."""

    def __init__(
        self,
        step: Callable[[], None],
        device: torch.device | str,
        *,
        generators: Sequence[torch.Generator] = (),
    ):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {self.device}")
        self.step = step
        self.generators = tuple(generators)
        # reference mode at capture -> (graph, its launch record)
        self._graphs: dict[bool, tuple[torch.cuda.CUDAGraph, object]] = {}
        self._warmed: set[bool] = set()  # the modes whose warm-up step ran
        self.capture_s = 0.0  # host seconds spent capturing, summed

    @property
    def captured(self) -> bool:
        """Whether the graph of the current reference mode is captured."""
        return ops.in_reference_mode() in self._graphs

    def run(self, n: int) -> None:
        """``n`` steps: replays of this mode's graph; before its capture,
        the first step of the mode is the eager warm-up, and the next one is
        captured and replayed (``run(1)`` a step warms up, then captures)."""
        if n <= 0:
            return
        mode = ops.in_reference_mode()
        if mode not in self._graphs:
            if mode not in self._warmed:
                self._warm_up()
                self._warmed.add(mode)
                n -= 1
                if n == 0:
                    return
            self._graphs[mode] = self._capture()
        graph, record = self._graphs[mode]
        for _ in range(n):
            graph.replay()
        launches.replayed(record, n)

    def _warm_up(self) -> None:
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with collected(), torch.cuda.stream(side):
            self.step()
        current.wait_stream(side)

    def _capture(self):
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        with collected():
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            with launches.recording() as record, torch.cuda.graph(graph):
                self.step()
            self.capture_s += time.perf_counter() - t0
        return graph, record


def _tensors(state: Any) -> list[Any]:
    """A state's tensors, its host numbers aside."""
    return [x for x in tree_leaves(state) if not isinstance(x, bool | int | float)]


class SyncStepGraph:
    """A training step over a gradient compressor
    (``core.compressors.GradCompressor``) as :class:`StepGraph` replays,
    bound to ``state``, the tree of every tensor the step updates in place
    (parameters, optimizer state, compressor state).

    ``body(gens)`` runs one step and returns the new state, which must hold
    the bound tensors (else it raises: a replay could not update a state
    it did not capture). ``gens`` (leaf -> ``torch.Generator``, or None for
    a deterministic compressor) are the generators the compressor's sync
    draws from in place of its per-step ones; they are registered with the
    graph, and :meth:`run` reseeds them on the host before each step
    (``compressor.prng_seeds``), so a replay draws what the eager step
    draws. Where ``comm`` records its gathers (``SimComm`` or ``DistComm``
    with ``record=True``; an NCCL ``DistComm``'s collectives are captured
    with the step, after the warm-up has created its communicator),
    each step's gathers are kept as the eager step's are: the capture's
    are the graph's static outputs, which every replay overwrites, so
    after each replay ``comm.gathered`` gets copies of them."""

    def __init__(
        self,
        body: Callable[[dict[str, torch.Generator] | None], Any],
        device: torch.device | str,
        compressor: Any,
        state: Any,
        comp_state: dict[str, Any],
        comm: Any = None,
    ):
        self.compressor = compressor
        self.comm = comm
        self.bound = _tensors(state)
        dev = torch.device(device)
        gens = {k: torch.Generator(device=dev) for k in compressor.prng_seeds(comp_state)}
        self.gens = gens
        bound = self.bound  # the body holds these, not this object

        def step() -> None:
            if not _same(_tensors(body(gens or None)), bound):
                raise RuntimeError("a graphed step must update its state in place")

        self.graph = StepGraph(step, dev, generators=list(gens.values()))
        # reference mode -> its capture's gathers, the graph's outputs
        self._static_gathers: dict[bool, list[torch.Tensor]] = {}

    def binds(self, state: Any) -> bool:
        """Whether ``state`` holds the tensors this graph updates."""
        return _same(_tensors(state), self.bound)

    def run(self, comp_state: dict[str, Any]) -> dict[str, Any]:
        """One step from ``comp_state`` (the bound compressor state with
        this step's host numbers); returns it with them advanced."""
        for k, seed in self.compressor.prng_seeds(comp_state).items():
            self.gens[k].manual_seed(seed)
        gathered = getattr(self.comm, "gathered", None)
        n0 = len(gathered) if gathered is not None else 0
        capturing = not self.graph.captured
        self.graph.run(1)
        if gathered is not None and self.graph.captured:
            mode = ops.in_reference_mode()
            if capturing:
                self._static_gathers[mode] = gathered[n0:]
                del gathered[n0:]
            gathered.extend(t.clone() for t in self._static_gathers[mode])
        return self.compressor.next_host_state(comp_state)


def _same(a: list[Any], b: list[Any]) -> bool:
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))
