"""The asynchronous training runtime: the JAX package's ``train/runtime.py``.

The reference :class:`~repro_torch.train.trainer.Trainer` blocks the host
on every piece of host work. :class:`AsyncRunner` runs the same step and
changes only when the host waits, never the math (it equals ``Trainer``
bit for bit):

* **Prefetch.** A daemon thread builds the numpy batches of the coming
  steps and pins them; the step copies its batch to the card without
  blocking the host (``train/step.py``).
* **Deferred metrics.** Logged metrics stay device tensors and are read one
  log interval late, in one transfer, when the device has moved on.
* **Background checkpoints.** A device-side copy of the state (one buffer
  per dtype) is made on the main stream and a CUDA event recorded after
  it; the writer thread waits for that event, then reads the copy on a
  stream of its own and writes it (``checkpoint/io.py``), while the next
  steps update the parameters in place.
* **Gradient accumulation** is the step's ``accum_steps``
  (``RuntimeConfig.microbatch``).

Over several ranks (``comm=``, a ``DistComm``) the prefetch thread keeps
the rank's rows of each global batch, every rank submits a checkpoint
(``AsyncCheckpointer.submit`` gathers the per-worker rows on the main
thread) and rank 0 alone writes it and prints, as in ``Trainer``.

:func:`run_schedule` threads ONE runner through the compression schedule's
phases (end of warm-up, each decay boundary): history and clock carry over,
and a restored checkpoint skips the phases it has finished, so a warm-Q
truncation is never applied twice.
"""

from __future__ import annotations

import dataclasses
import math
import queue
import sys
import threading
import time
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.io import AsyncCheckpointer
from repro_torch.core.tree import Tree, tree_leaves, tree_unflatten
from repro_torch.train.trainer import (
    WORKER_ROWS,
    TrainerConfig,
    checkpoint_due,
    format_metrics,
    is_rank0,
    local_rows,
    start_step_of,
)

__all__ = ["RuntimeConfig", "AsyncRunner", "run_schedule", "snapshot"]


@dataclasses.dataclass
class RuntimeConfig(TrainerConfig):
    microbatch: int = 1  # gradient-accumulation factor (1 = off)
    prefetch: int = 2  # batches built ahead of the step that needs them


class _Prefetcher:
    """``batch_fn(i)`` for the coming steps on a daemon thread, cut to this
    process's rows (``comm``), each array pinned when there is a card (so
    the step's copy need not block); a bounded queue bounds the staged
    batches."""

    def __init__(
        self,
        batch_fn: Callable[[int], Any],
        start: int,
        stop: int,
        depth: int = 2,
        comm: Any = None,
    ):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._err: BaseException | None = None
        pin = torch.cuda.is_available()

        def stage(b: dict[str, Any]) -> dict[str, Any]:
            out = {}
            for k, v in b.items():
                t = torch.from_numpy(np.ascontiguousarray(v))
                out[k] = t.pin_memory() if pin else t
            return out

        def work() -> None:
            try:
                for i in range(start, stop):
                    if self._stop.is_set():
                        return
                    b = stage(local_rows(batch_fn(i), comm))
                    while not self._stop.is_set():
                        try:
                            self._q.put(b, timeout=0.1)
                            break
                        except queue.Full:
                            continue
            except Exception as e:  # raised again by get()
                self._err = e

        self._thread = threading.Thread(
            target=work, name="batch-prefetch", daemon=True
        )
        self._thread.start()

    def get(self) -> Any:
        while True:
            try:
                return self._q.get(timeout=0.5)
            except queue.Empty:
                if self._err is not None:
                    raise RuntimeError("batch prefetch failed") from self._err
                if not self._thread.is_alive():
                    raise RuntimeError(
                        "batch prefetch thread exited without producing the "
                        "requested batch"
                    ) from None

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10)


def snapshot(state: Tree) -> Callable[[], Tree]:
    """A copy of ``state`` made now on the device, one flat buffer per
    dtype, before the next step updates the parameters in place; returns
    the thunk the writer thread calls for the host tree. On a card the
    thunk waits for the copy's event and reads it on a side stream."""
    leaves = tree_leaves(state)
    groups: dict[tuple[torch.dtype, torch.device], list[int]] = {}
    for i, x in enumerate(leaves):
        if isinstance(x, torch.Tensor):
            groups.setdefault((x.dtype, x.device), []).append(i)
    with torch.no_grad():
        packed = {
            key: torch.cat([leaves[i].detach().reshape(-1) for i in idxs])
            for key, idxs in groups.items()
        }
    shapes = [tuple(x.shape) if isinstance(x, torch.Tensor) else None for x in leaves]
    # Python numbers (a compressor's step counter) are taken by value now
    values = [None if isinstance(x, torch.Tensor) else x for x in leaves]
    events = {}
    for dtype, dev in packed:
        if dev.type == "cuda" and dev not in events:
            events[dev] = torch.cuda.Event()
            events[dev].record(torch.cuda.current_stream(dev))

    def materialize() -> Tree:
        host = {}
        for (dtype, dev), buf in packed.items():
            if dev.type == "cuda":
                side = torch.cuda.Stream(dev)
                side.wait_event(events[dev])
                with torch.cuda.stream(side):
                    host[dtype, dev] = buf.to("cpu")
            else:
                host[dtype, dev] = buf.clone()
        out = list(values)
        for key, idxs in groups.items():
            flat, off = host[key], 0
            for i in idxs:
                n = math.prod(shapes[i])
                out[i] = flat[off : off + n].reshape(shapes[i])
                off += n
        return tree_unflatten(state, out)

    return materialize


class AsyncRunner:
    """:class:`~repro_torch.train.trainer.Trainer` with the async behaviours
    of the module doc: the same ``run(state, start_step=None)``, history,
    resume from ``state["step"]`` and checkpoint grid."""

    def __init__(
        self,
        step_fn: Callable,
        batch_fn: Callable[[int], Any],
        cfg: RuntimeConfig,
        *,
        comm: Any = None,
        shards: Any = None,
    ):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.cfg = cfg
        self.comm = comm
        self.shards = shards  # a checkpoint.io.ModelShards over a model axis
        self.history: list[dict[str, float]] = []
        self.host_s = 0.0  # main-thread seconds blocked (cf. Trainer.host_s)
        self._t0: float | None = None

    def _emit(self, step: int, metrics: dict[str, Any], t_log: float) -> None:
        th = time.time()
        keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
        # ONE transfer for the tensors of the dict
        fetched = torch.stack([metrics[k] for k in keys]).tolist() if keys else []
        m = {k: float(v) for k, v in metrics.items()}
        m.update(zip(keys, fetched))
        m["step"] = step
        m["wall_s"] = round(t_log - self._t0, 2)
        self.history.append(m)
        if self.cfg.verbose and is_rank0(self.comm):
            print(format_metrics(step, m))
        self.host_s += time.time() - th

    def run(self, state: Any, start_step: int | None = None) -> Any:
        if start_step is None:
            start_step = start_step_of(state)
        if self._t0 is None:
            self._t0 = time.time()
        cfg = self.cfg
        comm = self.comm
        saver = (
            AsyncCheckpointer(cfg.ckpt_path, comm, WORKER_ROWS, self.shards)
            if cfg.ckpt_every
            else None
        )
        pf = _Prefetcher(
            self.batch_fn, start_step, cfg.steps, depth=cfg.prefetch, comm=comm
        )
        pending: list[tuple[int, Any, float]] = []
        # the prefetch and writer threads take the interpreter lock from the
        # main thread's dispatch; shrink the switch interval for the run so
        # each hand-back costs microseconds, not the 5 ms default
        prev_switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-4)
        try:
            for step in range(start_step, cfg.steps):
                th = time.time()
                batch = pf.get()
                self.host_s += time.time() - th
                state, metrics = self.step_fn(state, batch)
                if step % cfg.log_every == 0 or step == cfg.steps - 1:
                    pending.append((step, metrics, time.time()))
                # read only the PREVIOUS interval's metrics: this step is
                # queued on the device already
                while len(pending) > 1:
                    self._emit(*pending.pop(0))
                if saver is not None and checkpoint_due(cfg, step):
                    th = time.time()
                    saver.submit(state, snapshot)  # on every rank
                    self.host_s += time.time() - th
            while pending:
                self._emit(*pending.pop(0))
            if saver is not None:
                saver.drain()  # raises a background write error
        finally:
            sys.setswitchinterval(prev_switch)
            pf.close()
            if saver is not None:
                saver.close()
        return state


def run_schedule(
    runner: Any,
    compressor: Any,
    state: dict[str, Any],
    *,
    total_steps: int,
    rebuild: Callable[[Any, int], Callable],
    initial: Any = None,
) -> dict[str, Any]:
    """Drive ``runner`` (a ``Trainer`` or ``AsyncRunner``) through the
    compression schedule's phases.

    ``rebuild(comp_t, seg_start) -> step_fn`` is called only for a phase
    whose compressor differs from the one in force, whose state is carried
    over by ``adapt_state``. ``initial`` names the compressor the runner's
    current ``step_fn`` was built for (default ``compressor``): the
    ``at_step(resume - 1)`` one when resuming a checkpoint. Phases that end
    at or before ``state["step"]`` are skipped. ``state`` is donated, as the
    step donates it: a phase boundary adapts its compressor state in
    place, so no caller holds the state of an earlier phase."""
    sched = getattr(compressor, "schedule", None)
    bounds = (
        [b for b in sched.boundaries() if 0 < b < total_steps]
        if sched is not None
        else []
    )
    resume = start_step_of(state)
    comp_prev = initial if initial is not None else compressor
    for seg_start, seg_end in zip([0] + bounds, bounds + [total_steps]):
        if seg_end <= resume:
            continue  # a phase behind the restored step: never re-adapt
        at = getattr(comp_prev, "at_step", None)
        comp_t = at(max(seg_start, resume)) if at is not None else comp_prev
        if comp_t is not comp_prev:
            state["comp"] = comp_t.adapt_state(state["comp"])
            runner.step_fn = rebuild(comp_t, seg_start)
            comp_prev = comp_t
        runner.cfg.steps = seg_end
        state = runner.run(state)
    return state
