"""Checkpoints of a tree of tensors: path-keyed leaves, zlib, restart-safe.

The JAX package's ``checkpoint/io.py`` contract, in a byte format of the
port's own (stdlib ``zlib`` and numpy bytes; no msgpack, no zstandard):

    magic | header length (8 bytes, little endian) | zlib(JSON header) | blobs

The header keys every leaf by its tree path (``['params']['embed']``, as
``jax.tree_util.keystr`` names it) with its dtype, shape and the offset
and length of its blob, one zlib stream per leaf. bfloat16 leaves are
stored as their raw 16 bits with the tag ``bfloat16``; Python numbers in
the tree (a compressor's step counter) keep their type. A write goes to
``path + ".tmp"`` and is renamed over ``path``, so a crash mid-write
leaves the previous checkpoint whole. :func:`peek_step` reads the header
and the step's blob only. :func:`restore` checks every leaf against a
like-tree and puts it on that tree's device (or the one given).

One file holds a run whatever its world size. The caller names the
per-worker leaves (``per_worker``, tree-path prefixes: the train state's
are ``train/trainer.py:WORKER_ROWS``, the compressor's error feedback,
warm-start Q and lazy references), whose leading dim is the workers; a
0-dim leaf under a prefix is shared (the symmetric wire's lazy counter).
Over a process group (a ``DistComm`` of world
above 1) every rank holds only its own workers' rows, so :func:`save` and
:meth:`AsyncCheckpointer.submit` gather them on every rank and rank 0
alone writes all N, and :func:`restore` checks that the file holds N and
gives each rank its rows (``comm.workers()``). Everything else is the
same on every rank. A barrier after the write (in :func:`save`, in
:meth:`AsyncCheckpointer.drain`) keeps any rank from reading a file still
being written. A checkpoint written by R ranks resumes under any other
split of the same N workers, one process included.

Over a ``(data, model)`` mesh (``shards``, a :class:`ModelShards`) the
leaves split over the model axis (parameters, their optimizer state, the
error feedback) are gathered into whole leaves too, and rank (d0, m0)
writes: the file is the one-process layout, whatever the mesh. A restore
cuts each such leaf to the rank's block, after checking the file holds
the whole leaf. A checkpoint of a 2x2 mesh resumes in one process, and
one process's on 2x2.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import struct
import threading
import zlib
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from repro_torch.core.tree import Tree, flatten_with_paths, tree_unflatten

__all__ = [
    "ModelShards",
    "save",
    "restore",
    "peek_step",
    "leaf_fingerprints",
    "AsyncCheckpointer",
]

_MAGIC = b"REPROTORCHCKPT1\n"
_LEVEL = 3  # zlib's compression level
_PYTHON = {"int": int, "float": float, "bool": bool}


def _spans_ranks(comm: Any) -> bool:
    return comm is not None and comm.world > 1


@dataclasses.dataclass(frozen=True)
class ModelShards:
    """The leaves of a tree that a model axis splits: its comm (a
    ``core.comm.ModelComm``) and, by tree path, the dim each is cut on
    (of the leaf as it is held, a leading worker dim included)."""

    comm: Any
    dims: dict[str, int]

    @classmethod
    def of(cls, comm: Any, specs: Any) -> ModelShards:
        """From a spec tree laid out as the tree (``launch.sharding.Spec``
        leaves; ``train/step.py:train_state_specs``)."""
        from repro_torch.launch.sharding import flatten_specs, split_dim

        pairs = [(path, split_dim(spec)) for path, spec in flatten_specs(specs)]
        return cls(comm, {path: d for path, d in pairs if d is not None})

    @property
    def spans(self) -> bool:
        return self.comm.size > 1

    def gather(self, tree: Tree) -> Tree:
        """``tree`` with every split leaf gathered whole over the model axis
        (a collective: every model rank calls it)."""
        keyed = flatten_with_paths(tree)
        return tree_unflatten(
            tree,
            [
                self.comm.all_gather(x.detach(), self.dims[k], "tp.ckpt")
                if k in self.dims
                else x
                for k, x in keyed
            ],
        )

    def cut(self, key: str, arr: np.ndarray, want: tuple) -> np.ndarray:
        """This rank's block of the whole leaf ``arr`` at ``key``, whose
        held shape is ``want``."""
        d = self.dims[key]
        whole = list(want)
        whole[d] *= self.comm.size
        if list(arr.shape) != whole:
            raise ValueError(
                f"{key}: {list(arr.shape)} in the checkpoint, the whole leaf "
                f"{whole} wanted (a block {list(want)} over {self.comm.size} "
                "model ranks)"
            )
        n = want[d]
        idx = [slice(None)] * arr.ndim
        idx[d] = slice(self.comm.rank * n, (self.comm.rank + 1) * n)
        return arr[tuple(idx)]


def _gather_all(tree: Tree, comm: Any, per_worker: Any, shards: Any) -> Tree:
    """The model blocks gathered, then the worker rows (collectives)."""
    if shards is not None and shards.spans:
        tree = shards.gather(tree)
    if _spans_ranks(comm):
        tree = _gather_rows(tree, comm, per_worker)
    return tree


def _is_writer(comm: Any, shards: Any) -> bool:
    """Rank (d0, m0): data rank 0 of model rank 0."""
    data0 = comm is None or comm.rank == 0
    return data0 and (shards is None or shards.comm.rank == 0)


def _barrier(comm: Any, shards: Any) -> None:
    """Every rank past the writer's write: the data group's barrier (the
    writer's column), then the model group's (each row behind its rank of
    that column)."""
    if _spans_ranks(comm):
        comm.barrier()
    if shards is not None and shards.spans:
        shards.comm.barrier()


def _is_rows(per_worker: str | tuple[str, ...] | None, key: str, leaf: Any) -> bool:
    """Whether the leaf at ``key`` carries the workers on its leading dim:
    a tensor of at least one dim under one of the ``per_worker`` prefixes."""
    return (
        per_worker is not None
        and key.startswith(per_worker)
        and isinstance(leaf, torch.Tensor)
        and leaf.dim() > 0
    )


def _gather_rows(
    tree: Tree, comm: Any, per_worker: str | tuple[str, ...] | None
) -> Tree:
    """``tree`` with every rank's rows gathered into each per-worker leaf
    (a collective: every rank calls it)."""
    keyed = flatten_with_paths(tree)
    return tree_unflatten(
        tree,
        [comm.gather(x) if _is_rows(per_worker, k, x) else x for k, x in keyed],
    )


def _leaf_bytes(leaf: Any) -> tuple[dict[str, Any], bytes]:
    """(its header entry, its raw bytes)."""
    if isinstance(leaf, bool | int | float):
        kind = type(leaf).__name__
        arr = np.asarray(leaf, dtype={"bool": np.bool_, "int": np.int64}.get(kind))
        return {"dtype": arr.dtype.str, "shape": [], "python": kind}, arr.tobytes()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            raw = t.view(torch.int16).numpy().tobytes()
            return {"dtype": "bfloat16", "shape": list(t.shape)}, raw
        leaf = t.numpy()
    arr = np.asarray(leaf)  # tobytes() writes C order, 0-dim arrays too
    return {"dtype": arr.dtype.str, "shape": list(arr.shape)}, arr.tobytes()


_FINGERPRINT_CHUNK = 1 << 24  # 32-bit words a pass


def _fingerprint(leaf: Any) -> tuple:
    """(dtype, shape, two 64-bit sums of the leaf's bytes read as 32-bit
    words, the second weighted by a hash of each word's position), taken
    where the leaf lies, in chunks: equal leaves give equal fingerprints,
    and two that differ in any bit differ in them but with a chance of
    about 2^-64. Not a cryptographic hash."""
    if not isinstance(leaf, torch.Tensor):
        return (type(leaf).__name__, leaf)
    b = leaf.detach().contiguous().reshape(-1).view(torch.uint8)
    b = torch.nn.functional.pad(b, (0, -b.numel() % 4))
    words = b.view(torch.int32)
    s0 = s1 = torch.zeros((), dtype=torch.int64, device=b.device)
    for start in range(0, words.numel(), _FINGERPRINT_CHUNK):
        w = words[start : start + _FINGERPRINT_CHUNK].to(torch.int64)
        pos = torch.arange(start, start + w.numel(), device=b.device)
        s0 = s0 + w.sum()
        s1 = s1 + (w * (pos * 2654435761 % 2147483647 + 1)).sum()
    return (str(leaf.dtype), tuple(leaf.shape), int(s0), int(s1))


def leaf_fingerprints(
    tree: Tree, per_worker: str | tuple[str, ...] | None = None
) -> dict[str, Any]:
    """Each leaf's :func:`_fingerprint` by tree path, a list of one a
    worker for a leaf under ``per_worker`` (its rows), so that two runs'
    leaves can be compared bit for bit where they lie, and a rank's rows
    against another split's."""
    return {
        key: [_fingerprint(row) for row in leaf]
        if _is_rows(per_worker, key, leaf)
        else _fingerprint(leaf)
        for key, leaf in flatten_with_paths(tree)
    }


def save(
    path: str,
    tree: Tree,
    *,
    comm: Any = None,
    per_worker: str | tuple[str, ...] | None = None,
    shards: ModelShards | None = None,
) -> int:
    """Write ``tree`` (tensors on any device, numpy arrays, Python numbers)
    to ``path``. Returns the bytes written. Over several ranks (``comm``,
    ``shards``) every rank calls it: the rows of the ``per_worker`` leaves
    and the model blocks of the split ones are gathered, rank (d0, m0)
    writes, and all wait for the write (other ranks return 0)."""
    if not (_spans_ranks(comm) or (shards is not None and shards.spans)):
        return _write(path, tree)
    tree = _gather_all(tree, comm, per_worker, shards)
    try:
        return _write(path, tree) if _is_writer(comm, shards) else 0
    finally:
        _barrier(comm, shards)


def _write(path: str, tree: Tree) -> int:
    entries, blobs, offset = {}, [], 0
    for key, leaf in flatten_with_paths(tree):
        entry, raw = _leaf_bytes(leaf)
        blob = zlib.compress(raw, _LEVEL)
        entries[key] = {**entry, "offset": offset, "nbytes": len(blob)}
        blobs.append(blob)
        offset += len(blob)
    header = zlib.compress(json.dumps({"version": 1, "entries": entries}).encode())
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(_MAGIC + struct.pack("<Q", len(header)) + header)
        for blob in blobs:
            f.write(blob)
    os.replace(tmp, path)
    return len(_MAGIC) + 8 + len(header) + offset


def _read_header(f) -> tuple[dict[str, Any], int]:
    """(the entries, the file offset of the first blob)."""
    if f.read(len(_MAGIC)) != _MAGIC:
        raise ValueError(f"{f.name!r} is not a checkpoint of this package")
    (n,) = struct.unpack("<Q", f.read(8))
    header = json.loads(zlib.decompress(f.read(n)))
    return header["entries"], len(_MAGIC) + 8 + n


def _read_leaf(f, start: int, entry: dict[str, Any]) -> np.ndarray:
    f.seek(start + entry["offset"])
    raw = zlib.decompress(f.read(entry["nbytes"]))
    dtype = np.int16 if entry["dtype"] == "bfloat16" else np.dtype(entry["dtype"])
    return np.frombuffer(raw, dtype).reshape(entry["shape"])


def peek_step(path: str) -> int:
    """The top-level ``['step']`` counter alone: the header and one blob are
    read, no other leaf. Resume needs the step before it can build the
    restore shapes (a schedule phase changes the compressor state)."""
    with open(path, "rb") as f:
        entries, start = _read_header(f)
        if "['step']" not in entries:
            raise KeyError(f"checkpoint {path!r} has no ['step'] entry")
        return int(_read_leaf(f, start, entries["['step']"]).reshape(-1)[0])


def _to_tensor(arr: np.ndarray, entry: dict[str, Any], device) -> torch.Tensor:
    if entry["dtype"] == "bfloat16":
        return torch.from_numpy(arr.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def restore(
    path: str,
    like: Tree,
    device: torch.device | str | None = None,
    *,
    comm: Any = None,
    per_worker: str | tuple[str, ...] | None = None,
    shards: ModelShards | None = None,
) -> Tree:
    """The checkpoint at ``path`` in the structure of ``like`` (tensors,
    meta tensors or Python numbers). Each tensor leaf must match its
    like's shape and dtype, and lands on ``device``, by default its like's
    (``cpu`` for a meta like). Raises on any mismatch: no partial restore.
    Over several ranks (``comm``) each ``per_worker`` leaf of the file
    must hold ``comm.size()`` workers, and is cut to this rank's rows
    (``comm.workers()``); over a model axis (``shards``) each split leaf
    of the file must be whole, and is cut to this rank's block. Every rank
    reads the same header, so every rank raises alike."""
    cut = _spans_ranks(comm)
    blocks = shards is not None and shards.spans
    out = []
    with open(path, "rb") as f:
        entries, start = _read_header(f)
        for key, ref in flatten_with_paths(like):
            if key not in entries:
                raise KeyError(f"checkpoint {path!r} misses leaf {key}")
            entry = entries[key]
            arr = _read_leaf(f, start, entry)
            if blocks and key in shards.dims:
                rows = list(ref.shape)
                if cut and _is_rows(per_worker, key, ref):
                    rows[0] = comm.size()  # the file holds every worker
                arr = shards.cut(key, arr, tuple(rows))
            if cut and _is_rows(per_worker, key, ref) and "python" not in entry:
                if not entry["shape"] or entry["shape"][0] != comm.size():
                    raise ValueError(
                        f"{key}: {entry['shape'][:1]} workers in the checkpoint, "
                        f"{comm.size()} wanted"
                    )
                arr = arr[comm.workers()]
            if "python" in entry:
                out.append(_PYTHON[entry["python"]](arr.item()))
                continue
            if not isinstance(ref, torch.Tensor):
                raise TypeError(f"{key}: a tensor in the checkpoint, {ref!r} in like")
            dev = device if device is not None else ref.device
            if torch.device(dev).type == "meta":
                dev = "cpu"
            val = _to_tensor(arr, entry, dev)
            if tuple(val.shape) != tuple(ref.shape) or val.dtype != ref.dtype:
                raise ValueError(
                    f"{key}: {tuple(val.shape)} {val.dtype} in the checkpoint, "
                    f"{tuple(ref.shape)} {ref.dtype} wanted"
                )
            out.append(val)
    return tree_unflatten(like, out)


class AsyncCheckpointer:
    """A background writer: the train loop hands over a snapshot (a tree,
    or a callable returning one, which the writer thread calls: the
    runtime's device-side copy, read back here) and keeps dispatching; this
    thread serializes and writes it with :func:`save`.

    The queue is bounded (one write in flight and one waiting), so a disk
    that cannot keep up with the interval applies backpressure instead of
    hoarding snapshots. A write error is kept and raised by :meth:`drain`;
    after one, the thread drains without writing.

    Over several ranks (``comm``, ``shards``) every rank submits:
    :meth:`submit` gathers the rows of the ``per_worker`` leaves and the
    model blocks, rank (d0, m0) alone queues the write, and :meth:`drain`
    ends in a barrier on every rank."""

    def __init__(
        self,
        path: str,
        comm: Any = None,
        per_worker: str | tuple[str, ...] | None = None,
        shards: ModelShards | None = None,
    ):
        self.path = path
        self.comm = comm
        self.per_worker = per_worker
        self.shards = shards
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._err: BaseException | None = None
        self._thread = threading.Thread(
            target=self._worker, name="async-ckpt", daemon=True
        )
        self._thread.start()

    def _worker(self) -> None:
        while True:
            tree = self._q.get()
            try:
                if tree is None:
                    return
                if self._err is None:
                    snap = tree() if callable(tree) else tree
                    save(self.path, snap)
            except Exception as e:  # raised again by drain()
                self._err = e
            finally:
                self._q.task_done()

    def submit(
        self, tree: Tree, prepare: Callable[[Tree], Any] | None = None
    ) -> None:
        """Enqueue a snapshot of ``tree``: ``prepare(tree)`` where given (a
        tree, or a callable the writer thread calls), run on this thread
        after the rows are gathered. Blocks only while two are queued."""
        tree = _gather_all(tree, self.comm, self.per_worker, self.shards)
        if not _is_writer(self.comm, self.shards):
            return
        self._q.put(prepare(tree) if prepare is not None else tree)

    def drain(self) -> None:
        """Wait until every submitted snapshot is written (on every rank:
        until rank (d0, m0)'s is); raise the first write error."""
        self._q.join()
        _barrier(self.comm, self.shards)
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError(
                f"async checkpoint write to {self.path!r} failed"
            ) from err

    def close(self) -> None:
        """Stop the thread (raises nothing: call :meth:`drain` first)."""
        if self._thread.is_alive():
            self._q.put(None)
            self._thread.join(timeout=60)
