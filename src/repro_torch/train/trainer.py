"""The synchronous training loop: metrics, checkpoints, deterministic data
order; the JAX package's ``train/trainer.py``.

This is the reference loop: every piece of host work (the batch, each
metric's ``float()``, the checkpoint's copy to the host and its write) runs
on the hot path, blocking device dispatch. ``train/runtime.py:AsyncRunner``
overlaps all of it and equals this loop bit for bit.

One ``Trainer`` may drive several ``run()`` calls (the schedule phases swap
``step_fn`` between them): ``history`` accumulates and ``wall_s`` counts
from the first run.

Over several ranks (a ``DistComm``, ``comm=``) every rank builds the global
batch from the step and keeps its workers' rows (``comm.rows``); the
history is the same on every rank, and rank 0 alone prints it and writes
the checkpoints (``checkpoint/io.py``). Over a ``(data, model)`` mesh the
comm spans the rank's data-axis group: the rows are its data row's, the
metrics the mean over the data group (equal on a row's model ranks), and
``shards`` (a ``checkpoint.io.ModelShards``) has each checkpoint gather
the model blocks too.
"""

from __future__ import annotations

import dataclasses
import time
from collections.abc import Callable
from typing import Any

from repro_torch.checkpoint.io import save as ckpt_save

__all__ = [
    "WORKER_ROWS",
    "TrainerConfig",
    "Trainer",
    "local_rows",
    "is_rank0",
    "start_step_of",
    "checkpoint_due",
    "format_metrics",
]


# the train state's per-worker leaves, workers leading: the compressor's
# error feedback and warm-start Q, the lazy groups' references and the
# server wire's per-worker staleness counters. The rest of ['comp'] (a lazy
# group's cached aggregate, its 0-dim counter on the symmetric wire, the
# drift tracker, seeds and step counters) is the same on every worker.
WORKER_ROWS = (
    "['comp']['err']",
    "['comp']['q']",
    "['comp']['lazy_ref']",
    "['comp']['lazy_stale']",
)


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 0  # 0 = disabled
    ckpt_path: str = "checkpoints/state.ckpt"
    verbose: bool = True  # False: record history, print nothing


def start_step_of(state: Any) -> int:
    """The completed steps a state carries (``state["step"]``), else 0."""
    if isinstance(state, dict) and "step" in state:
        return int(state["step"])
    return 0


def checkpoint_due(cfg: TrainerConfig, step: int) -> bool:
    """Save on the interval AND at the final step: a run whose last step is
    off the interval grid still leaves a checkpoint."""
    if not cfg.ckpt_every:
        return False
    return step == cfg.steps - 1 or (step > 0 and step % cfg.ckpt_every == 0)


def is_rank0(comm: Any = None) -> bool:
    """Whether this process prints and writes: rank 0 of the whole process
    group (a data-axis comm's ``process_rank``), or the one process."""
    return comm is None or getattr(comm, "process_rank", comm.rank) == 0


def local_rows(batch: dict[str, Any], comm: Any = None) -> dict[str, Any]:
    """The rows of ``batch`` (a global batch) that this process's workers
    take; the whole batch with one process."""
    if comm is None or comm.world == 1:
        return batch
    rows = comm.rows(next(iter(batch.values())).shape[0])
    return {k: v[rows] for k, v in batch.items()}


def format_metrics(step: int, m: dict[str, float]) -> str:
    msg = " ".join(
        f"{k}={v:.4f}" for k, v in m.items() if k not in ("step", "wall_s")
    )
    return f"step {step:5d} | {msg} | t={m['wall_s']}s"


class Trainer:
    """Drives a step over a deterministic per-step data function."""

    def __init__(
        self,
        step_fn: Callable,
        batch_fn: Callable[[int], Any],
        cfg: TrainerConfig,
        *,
        comm: Any = None,
        shards: Any = None,
    ):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.cfg = cfg
        self.comm = comm
        self.shards = shards
        self.history: list[dict[str, float]] = []
        # main-thread seconds blocked on host work (batch, metric reads,
        # checkpoint IO): what the async runtime shrinks
        self.host_s = 0.0
        self._t0: float | None = None

    def run(self, state: Any, start_step: int | None = None) -> Any:
        """``start_step=None`` resumes from ``state["step"]`` (a restored
        checkpoint's count of completed steps)."""
        if start_step is None:
            start_step = start_step_of(state)
        if self._t0 is None:
            self._t0 = time.time()
        cfg = self.cfg
        for step in range(start_step, cfg.steps):
            th = time.time()
            batch = local_rows(self.batch_fn(step), self.comm)
            self.host_s += time.time() - th
            state, metrics = self.step_fn(state, batch)
            if step % cfg.log_every == 0 or step == cfg.steps - 1:
                th = time.time()
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["wall_s"] = round(time.time() - self._t0, 2)
                self.history.append(m)
                if cfg.verbose and is_rank0(self.comm):
                    print(format_metrics(step, m))
                self.host_s += time.time() - th
            if checkpoint_due(cfg, step):
                th = time.time()
                ckpt_save(
                    cfg.ckpt_path,
                    state,
                    comm=self.comm,
                    per_worker=WORKER_ROWS,
                    shards=self.shards,
                )
                self.host_s += time.time() - th
        return state
