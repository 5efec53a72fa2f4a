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
* then one step is captured. The step reads and writes only tensors that
  exist before the capture (parameters, caches, and the caller's static
  buffers for tokens, positions, counters and outputs), in place, so
  every replay works on the same addresses;
* the remaining steps are replays, with no host read between them.

A graph bakes in the ``ops.reference_mode()`` setting of its capture, so a
:class:`StepGraph` keeps one graph per setting and never replays a graph
under the other. Kernel launches are counted at replay
(``repro_torch.kernels.launches``). A capture or replay that fails raises;
there is no eager fallback. On the CPU callers run the same step eagerly.
"""

from __future__ import annotations

import time
from collections.abc import Callable, Sequence

import torch

from repro_torch.kernels import launches, ops

__all__ = ["use_graph", "StepGraph"]


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
        self.capture_s = 0.0  # host seconds spent capturing, summed

    def run(self, n: int) -> None:
        """``n`` steps: replays of this mode's graph, or, before its
        capture, one eager warm-up step, the capture and ``n - 1`` replays."""
        if n <= 0:
            return
        mode = ops.in_reference_mode()
        if mode not in self._graphs:
            self._warm_up()
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
        with torch.cuda.stream(side):
            self.step()
        current.wait_stream(side)

    def _capture(self):
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        with launches.recording() as record:
            with torch.cuda.graph(graph):
                self.step()
        self.capture_s += time.perf_counter() - t0
        return graph, record
