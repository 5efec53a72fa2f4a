"""Collectives over data-parallel workers + wire-byte accounting.

Every per-worker tensor carries the workers a process holds as its leading
dimension, as ``jax.vmap(..., axis_name=...)`` does for the JAX package's
collectives. Two comms give the reference's collective semantics
(``src/repro/core/comm.py:AxisComm``) on that layout:

* :class:`SimComm`: one process holds all N workers (one card simulates
  the mesh's data axis);
* :class:`DistComm`: a ``torch.distributed`` process group of ``world``
  ranks, each holding ``local_workers = k`` of them, so N = world * k, and
  rank r's local worker j is global worker r * k + j (NCCL between cards,
  gloo on the CPU or for several ranks sharing one card).

Both reduce and gather the same way:

* ``pmax`` / ``psum`` / ``pmean`` reduce over the workers and return ONE
  tensor without the worker dim: the value every worker holds after the
  collective;
* ``all_gather`` returns the stacked (N, ...) tensor in global worker
  order, which is what every worker holds after the gather.

A tensor-parallel forward's collectives go over :class:`ModelComm`: the
row-parallel products' all-reduce and the gathers of heads, vocab and
attention partials within one axis group of a ``(data, model)`` mesh;
:class:`ModelAxis` is what the sharded forward threads through its layers.
Its collectives carry their own backward (:func:`copy_to_model`,
:func:`reduce_from_model`, :func:`gather_from_model`,
:func:`gather_to_split`), so a training
forward over the model axis is differentiated as it is written. Over a
``(data, model)`` mesh the sync's ``DistComm`` spans the rank's data-axis
group only (``group``).

Byte accounting is static (plain Python ints from shapes), as in the JAX
package, so tables never need device work; only a lazily aggregated
group's payload is charged through a gate on the device. The accounting is
per worker, whichever comm carries it.
"""

from __future__ import annotations

import dataclasses
import time
from collections.abc import Sequence
from typing import Any

import torch
import torch.distributed as dist

__all__ = [
    "CommRecord",
    "SimComm",
    "DistComm",
    "ModelComm",
    "ModelAxis",
    "copy_to_model",
    "reduce_from_model",
    "gather_from_model",
    "gather_to_split",
    "partial_product",
]


@dataclasses.dataclass
class CommRecord:
    """Accumulated wire accounting for one sync call (per worker, bits).

    Three tiers:

    * ``add``: the static tier (plain Python ints from shapes); the eager
      compressors use only this.
    * ``add_gated``: the gated tier of lazily aggregated groups
      (:mod:`repro_torch.core.lazy`): a payload charged only where its gate
      fired, so ``dyn_bits`` / ``dyn_collectives`` are 0-dim f32 tensors on
      the gate's device (``0`` until something is charged). Nothing reads
      them on the host inside a sync.
    * ``add_down``: the server's broadcast (the server wire).

    ``phys_bits`` is what this process's worker actually puts on its
    data-axis wire in the codec phases and raw means (``add_phys``): the
    encoded codes of the tensors it holds plus 32 per scale. Over a model
    axis of 1 it equals the static tier for the compressors without a
    stand-in wire; over M > 1 the static tier stays the whole model's
    figure (the JAX package's accounting) while a rank ships the blocks it
    holds and, whole, what is replicated over the model axis.

    ``effective_bits`` / ``effective_collectives`` fold the static and
    gated tiers; on an eager-only record they stay Python ints."""

    bits_sent: int = 0  # payload each worker puts on the wire (static)
    n_collectives: int = 0
    dyn_bits: Any = 0  # gate-weighted payload (0-dim f32 tensor, or 0)
    dyn_collectives: Any = 0
    down_bits: int = 0  # server->worker broadcast payload (server wire)
    phys_bits: int = 0  # what this rank's worker ships on its data-axis wire

    def add(self, bits: int, n: int = 1) -> None:
        self.bits_sent += int(bits)
        self.n_collectives += n

    def add_gated(
        self, bits: int, n: int, gate: torch.Tensor | bool | float
    ) -> None:
        """Charge ``bits`` / ``n`` weighted by ``gate`` (a bool, or an f32
        share such as a round's contribution rate)."""
        g = torch.as_tensor(gate).to(torch.float32)
        self.dyn_bits = self.dyn_bits + g * bits
        self.dyn_collectives = self.dyn_collectives + g * n

    def add_down(self, bits: int) -> None:
        self.down_bits += int(bits)

    def add_phys(self, bits: int) -> None:
        self.phys_bits += int(bits)

    def effective_bits(self) -> int | torch.Tensor:
        """Static + gate-weighted payload bits."""
        return self.bits_sent + self.dyn_bits

    def effective_collectives(self) -> int | torch.Tensor:
        return self.n_collectives + self.dyn_collectives


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class _Books:
    """A comm's books, by tag: ``calls_by_tag``, ``bytes_by_tag`` (each
    collective's output on this rank: the gathered tensor, the reduced
    one), ``sent_by_tag`` (what this rank put in: its block, its summand)
    and ``op_by_tag`` (``all-reduce`` or ``all-gather``), kept on the host
    as the calls are made (a graph's capture counts once, its replays do
    not); ``host_s`` sums the host seconds inside the calls."""

    def _open_books(self) -> None:
        self.bytes_by_tag: dict[str, int] = {}
        self.sent_by_tag: dict[str, int] = {}
        self.calls_by_tag: dict[str, int] = {}
        self.op_by_tag: dict[str, str] = {}
        self.host_s = 0.0

    def _note(
        self, tag: str, op: str, out: torch.Tensor, sent: torch.Tensor, t0: float
    ) -> None:
        self.host_s += time.perf_counter() - t0
        self.bytes_by_tag[tag] = self.bytes_by_tag.get(tag, 0) + _nbytes(out)
        self.sent_by_tag[tag] = self.sent_by_tag.get(tag, 0) + _nbytes(sent)
        self.calls_by_tag[tag] = self.calls_by_tag.get(tag, 0) + 1
        self.op_by_tag[tag] = op

    def stats(self) -> dict[str, Any]:
        """Calls, bytes out, bytes sent, each tag's op, and host seconds so
        far (every tag's)."""
        return {
            "calls": dict(self.calls_by_tag),
            "bytes": dict(self.bytes_by_tag),
            "sent": dict(self.sent_by_tag),
            "ops": dict(self.op_by_tag),
            "host_s": self.host_s,
        }


class _Comm:
    """The surface both comms share: the fused collectives over the
    workers this process holds (``local_size()``), and the worker and row
    ranges of this process."""

    world = 1  # processes
    rank = 0
    gathered: list[torch.Tensor] | None = None

    def size(self) -> int:
        """N, the data-parallel workers of the mesh."""
        raise NotImplementedError

    def local_size(self) -> int:
        """The workers this process holds on the leading dim."""
        raise NotImplementedError

    def workers(self) -> slice:
        """This process's global worker indices."""
        k = self.local_size()
        return slice(self.rank * k, (self.rank + 1) * k)

    def rows(self, batch: int) -> slice:
        """This process's rows of a global batch of ``batch`` rows: worker w
        takes rows w*B/N .. (w+1)*B/N - 1, as ``P("data")`` shards them."""
        n = self.size()
        if batch % n:
            raise ValueError(f"global batch {batch} not divisible by {n} workers")
        w = self.workers()
        return slice(w.start * (batch // n), w.stop * (batch // n))

    def graph_refusal(self) -> str | None:
        """Why a step over this comm cannot be one CUDA graph; None where
        it can."""
        return None

    def metric_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of a per-worker metric over all N workers (bookkeeping,
        off the accounted wire), taken locally over a gather: SimComm's
        ``x.mean(0)`` bit for bit on every rank."""
        return self.gather(x).mean(0)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every worker's (k, ...) ``x`` -> the (N, ...) stack in global
        worker order, unrecorded: what a caller reduces locally so that the
        result does not depend on how the workers are spread (the lazy
        decision, the warm-up mean, the checkpoint's rows)."""
        raise NotImplementedError

    def _check(self, x: torch.Tensor) -> None:
        k = self.local_size()
        if x.dim() == 0 or x.shape[0] != k:
            raise ValueError(f"want a leading worker dim of {k}, got {tuple(x.shape)}")

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def fused_all_gather(self, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """ONE gather of every (k, ...) payload in ``xs``, concatenated flat
        per worker; returns per-input (N, numel) slices. All inputs share a
        dtype (one wire phase = one code dtype)."""
        if not xs:
            return []
        if len({x.dtype for x in xs}) != 1:
            raise ValueError(
                "fused_all_gather requires a single dtype; got "
                f"{[str(x.dtype) for x in xs]}"
            )
        k = self.local_size()
        g = self.all_gather(torch.cat([x.reshape(k, -1) for x in xs], dim=1))
        sizes = [x[0].numel() for x in xs]
        return list(torch.split(g, sizes, dim=1))

    def fused_pmax(self, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """ONE pmax over every (k, ...) tensor in ``xs``; per-input shapes
        without the worker dim. Scale reductions are f32 by contract."""
        if not xs:
            return []
        bad = [str(x.dtype) for x in xs if x.dtype != torch.float32]
        if bad:
            raise ValueError(
                "fused_pmax requires float32 inputs (scale reductions are f32 "
                f"by contract); got {bad}"
            )
        k = self.local_size()
        m = self.pmax(torch.cat([x.reshape(k, -1) for x in xs], dim=1))
        parts = torch.split(m, [x[0].numel() for x in xs])
        return [p.reshape(x.shape[1:]) for p, x in zip(parts, xs)]


class SimComm(_Comm):
    """N simulated workers on a leading dimension of every per-worker tensor.

    With ``record=True`` every gathered tensor is kept in ``gathered``, in
    the order of the gathers (a fused gather records its one flat buffer),
    so a run's exact wire can be compared with another's."""

    def __init__(self, n_workers: int, *, record: bool = False):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self.n_workers = n_workers
        self.gathered = [] if record else None

    def size(self) -> int:
        return self.n_workers

    def local_size(self) -> int:
        return self.n_workers

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        return x.sum(0)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        return x.mean(0)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        return x.amax(0)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every worker's ``x[w]`` -> the stacked (N, ...) tensor."""
        self._check(x)
        if self.gathered is not None:
            self.gathered.append(x)
        return x


class DistComm(_Comm, _Books):
    """The workers of the default ``torch.distributed`` process group: each
    of its ``world`` ranks holds ``local_workers`` of them on the leading dim of
    every per-worker tensor (see the module doc).

    ``psum`` / ``pmax`` reduce the local dim first, then ``all_reduce``
    (SUM, MAX) across the ranks; ``pmean`` is ``psum / N``. A sum's order
    across ranks is the backend's (a ring), so an f32 ``psum`` may differ
    from :class:`SimComm`'s ``x.sum(0)`` in the last bits; ``pmax`` and
    the gathers are exact, and a mean taken locally over a gather (the
    LQ-SGD wire) is the same on every rank and the same as SimComm's.
    ``metric_mean`` (the step's loss and the like) takes that route too, so
    a run's history does not depend on how the workers are spread. With
    ``record=True`` every gathered (N, ...) tensor is kept in ``gathered``.

    NCCL's collectives run on the card and may be captured into a CUDA
    graph once the communicator exists (after the first collective). Gloo
    runs its collectives from the host, copying a CUDA tensor's bytes
    through host memory inside each collective; a step over it cannot be
    captured (:meth:`graph_refusal`). ``group`` (default: the whole process
    group) is the group the workers span: a ``(data, model)`` mesh's
    data-axis group, whose ranks hold the model-axis coordinate of this
    one; ``rank`` and ``world`` are then this rank's place in it and its
    size, ``process_rank`` its rank in the whole group. The collectives
    used are the ones
    both PyTorch 2.11 and 2.13 offer without a warning (``all_reduce`` and
    the list ``all_gather`` into views of one output buffer). The books
    (``stats()``) hold every collective under its method's name:
    ``all_gather``, ``pmax`` and ``psum`` (``pmean`` too) are the wire, whose
    ``sent_by_tag`` a compressor's ``CommRecord.phys_bits`` counts, and
    ``gather`` what is reduced locally off the wire (metrics, the lazy
    statistics). ``host_s`` sums the host seconds spent inside the
    collectives' calls: the whole collective over gloo, which blocks the
    host (with the wait for the device work queued before it), only the
    enqueue over NCCL."""

    def __init__(
        self, local_workers: int = 1, *, record: bool = False, group: Any = None
    ):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "DistComm needs an initialised torch.distributed process group "
                "(repro_torch.launch.mesh.init_distributed)"
            )
        if local_workers < 1:
            raise ValueError(f"local_workers must be >= 1, got {local_workers}")
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.process_rank = dist.get_rank()
        self.local = local_workers
        self.backend = str(dist.get_backend(group))
        self.gathered = [] if record else None
        self._open_books()

    def __repr__(self) -> str:
        staged = ", host collectives: a CUDA tensor is staged through host memory" * (
            self.backend == "gloo"
        )
        return (
            f"DistComm(backend={self.backend}, world={self.world}, "
            f"rank={self.rank}, local_workers={self.local}{staged})"
        )

    def size(self) -> int:
        return self.world * self.local

    def local_size(self) -> int:
        return self.local

    def graph_refusal(self) -> str | None:
        if self.backend == "gloo":
            return (
                "gloo runs its collectives from the host, which a CUDA graph "
                "cannot capture (use NCCL, one rank a card)"
            )
        return None

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        s = x.sum(0)
        t0 = time.perf_counter()
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=self.group)
        self._note("psum", "all-reduce", s, x, t0)
        return s

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        return self.psum(x) / self.size()

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        m = x.amax(0)
        t0 = time.perf_counter()
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=self.group)
        self._note("pmax", "all-reduce", m, x, t0)
        return m

    def _gather(self, x: torch.Tensor, tag: str) -> torch.Tensor:
        self._check(x)
        out = torch.empty((self.size(),) + x.shape[1:], dtype=x.dtype, device=x.device)
        parts = list(out.chunk(self.world))
        t0 = time.perf_counter()
        dist.all_gather(parts, x.contiguous(), group=self.group)
        self._note(tag, "all-gather", out, x, t0)
        return out

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's (k, ...) ``x`` -> the (N, ...) stack in global worker
        order, unrecorded (booked as ``gather``, off the wire)."""
        return self._gather(x, "gather")

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every worker's ``x[w]`` -> the stacked (N, ...) tensor."""
        out = self._gather(x, "all_gather")
        if self.gathered is not None:
            self.gathered.append(out)
        return out

    def barrier(self) -> None:
        t0 = time.perf_counter()
        dist.barrier(group=self.group)
        self.host_s += time.perf_counter() - t0


class ModelComm(_Books):
    """The collectives of a tensor-parallel forward over one process group
    of ``size`` ranks (this rank ``rank`` within it): the model axis, or the
    group a KV cache's sequence is split over. Over a group of one every
    operation is the identity and nothing is recorded.

    * ``all_reduce(x, tag)``: the sum of the ranks' ``x``, cast to f32,
      summed, cast back once (so gloo never sees bf16); its backward is the
      identity (:func:`reduce_from_model`);
    * ``row_parallel(x, w, tag)``: a product whose weight is split by rows,
      its partial kept in f32 through the all-reduce;
    * ``all_gather(x, dim, tag)``: the ranks' blocks concatenated along
      ``dim`` in rank order; its backward keeps the rank's block
      (:func:`gather_from_model`; :func:`gather_to_split` sums the ranks'
      gradients first);
    * ``max(x, tag)``: the elementwise max over the ranks (no gradient: a
      quantization scale, a log-sum-exp's shift).

    Only ``all_reduce`` and the list ``all_gather`` are used: what gloo
    takes on CUDA tensors in PyTorch 2.11 and 2.13. Over NCCL they can be
    captured into a CUDA graph once the group's communicator exists (after
    its first collective, which a step graph's eager warm-up makes). Each
    call adds its bytes to ``bytes_by_tag`` and its count to
    ``calls_by_tag`` under its tag (``tp.attn.wo``, ``tp.mlp.down``,
    ``tp.embed``, ``tp.head``, ...; a backward's under its forward's tag
    with ``.grad``), on the host as it is made: a graph's capture counts
    once and its replays do not; ``sent_by_tag`` and ``op_by_tag`` beside
    them (``_Books``); ``host_s`` sums the host seconds inside the calls
    (the whole collective over gloo, the enqueue over NCCL)."""

    def __init__(self, group: Any = None, size: int = 1, rank: int = 0):
        if size > 1 and not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("a ModelComm of several ranks needs a process group")
        self.group, self.size, self.rank = group, size, rank
        self.backend = str(dist.get_backend(group)) if size > 1 else None
        self._open_books()

    def __repr__(self) -> str:
        return f"ModelComm(backend={self.backend}, size={self.size}, rank={self.rank})"

    def _sum(self, x: torch.Tensor, tag: str) -> torch.Tensor:
        """The f32 sum over the group, in ``x``'s dtype (no autograd)."""
        y = x.detach().to(torch.float32, copy=True).contiguous()
        t0 = time.perf_counter()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.group)
        self._note(tag, "all-reduce", y, y, t0)
        return y.to(x.dtype)

    def _gather(self, x: torch.Tensor, dim: int, tag: str) -> torch.Tensor:
        out = torch.empty((self.size,) + x.shape, dtype=x.dtype, device=x.device)
        t0 = time.perf_counter()
        dist.all_gather(list(out.unbind(0)), x.detach().contiguous(), group=self.group)
        self._note(tag, "all-gather", out, x, t0)
        return torch.cat(out.unbind(0), dim=dim)

    def all_reduce(self, x: torch.Tensor, tag: str) -> torch.Tensor:
        """The sum over the group of every rank's ``x``, in f32, returned in
        ``x``'s dtype (``x`` itself is left as it was)."""
        return reduce_from_model(x, self, tag)

    def row_parallel(self, x: torch.Tensor, w: torch.Tensor, tag: str) -> torch.Tensor:
        """``x @ w`` for a ``w`` split by rows over the group (``x`` split by
        its last dim alike): this rank's partial product kept in f32 (on the
        card a bf16 product's f32 accumulator, ``out_dtype``), summed over
        the group in f32 and rounded to ``x``'s dtype once, as one process
        rounds the whole product once."""
        return self.all_reduce(partial_product(x, w), tag).to(x.dtype)

    def all_gather(self, x: torch.Tensor, dim: int, tag: str) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order."""
        return gather_from_model(x, self, dim, tag)

    def max(self, x: torch.Tensor, tag: str) -> torch.Tensor:
        """The elementwise max over the group of every rank's ``x`` (exact;
        no gradient)."""
        if self.size == 1:
            return x.detach()
        y = x.detach().clone().contiguous()
        t0 = time.perf_counter()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.group)
        self._note(tag, "all-reduce", y, y, t0)
        return y

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group)


def partial_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in f32: a row-parallel product's partial before its sum
    over the ranks (on the card a bf16 product's f32 accumulator)."""
    if x.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        flat = x.reshape(-1, x.shape[-1])
        partial = _MatmulF32.apply(flat, w)
        return partial.reshape(x.shape[:-1] + (w.shape[-1],))
    return x.float() @ w.float()


class _MatmulF32(torch.autograd.Function):
    """``x @ w`` of two bf16 matrices with its f32 accumulator kept
    (``torch.mm(..., out_dtype=float32)``, which has no derivative). The
    backward takes the gradient in the operands' dtype, whose values it
    holds (the f32 product is rounded to ``x``'s dtype after the sum), and
    forms each operand's gradient as one process's bf16 product does."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.to(x.dtype)
        return g @ w.t(), x.t() @ g


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, tag):
        ctx.comm, ctx.tag = comm, tag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm._sum(grad, ctx.tag + ".grad"), None, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, tag):
        return comm._sum(x, tag)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, tag):
        ctx.comm, ctx.dim, ctx.n = comm, dim, x.shape[dim]
        return comm._gather(x, dim, tag)

    @staticmethod
    def backward(ctx, grad):
        block = grad.narrow(ctx.dim, ctx.comm.rank * ctx.n, ctx.n)
        return block, None, None, None


class _GatherToSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, tag):
        ctx.comm, ctx.dim, ctx.n, ctx.tag = comm, dim, x.shape[dim], tag
        return comm._gather(x, dim, tag)

    @staticmethod
    def backward(ctx, grad):
        whole = ctx.comm._sum(grad, ctx.tag + ".grad")
        block = whole.narrow(ctx.dim, ctx.comm.rank * ctx.n, ctx.n)
        return block, None, None, None


def copy_to_model(x: torch.Tensor, comm: ModelComm, tag: str) -> torch.Tensor:
    """Identity forward, the f32 sum over the model group backward: placed
    where a replicated activation enters a branch whose products split over
    the group, so each rank's partial gradient of it is made whole."""
    if comm.size == 1:
        return x
    return _CopyToModel.apply(x, comm, tag)


def reduce_from_model(x: torch.Tensor, comm: ModelComm, tag: str) -> torch.Tensor:
    """The f32 sum over the model group forward (cast back to ``x``'s dtype
    once), the identity backward: a row-parallel product's partials, a
    vocab-parallel lookup's terms."""
    if comm.size == 1:
        return x
    return _ReduceFromModel.apply(x, comm, tag)


def gather_from_model(
    x: torch.Tensor, comm: ModelComm, dim: int, tag: str
) -> torch.Tensor:
    """The ranks' blocks concatenated along ``dim`` forward, this rank's
    block of the gradient backward."""
    if comm.size == 1:
        return x
    return _GatherFromModel.apply(x, comm, dim % x.dim(), tag)


def gather_to_split(
    x: torch.Tensor, comm: ModelComm, dim: int, tag: str
) -> torch.Tensor:
    """The ranks' blocks concatenated along ``dim`` forward; backward, the
    f32 sum of the ranks' gradients over the group, then this rank's block
    (a reduce-scatter, written as the all-reduce and a narrow: gloo's
    reduce-scatter takes no CUDA tensors). For an activation gathered to
    feed a product split over the group (MLA's latent down-projections,
    gathered before the head-split up-projections): each rank's gradient of
    the gathered tensor is only its heads' part."""
    if comm.size == 1:
        return x
    return _GatherToSplit.apply(x, comm, dim % x.dim(), tag)


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """What a tensor-parallel forward threads through its layers: the
    model-axis comm, the comm of the group the KV cache's sequence is split
    over (a group of one where the cache splits by heads or not at all, and
    in training), the parameter specs of the serving or the training tree
    (``launch/sharding.py``), from which each layer reads which of its
    products split by rows and so end in an all-reduce, and the comm of the
    data-axis group the batch's rows are split over (a group of one where
    every rank holds every row): an MoE layer's one capacity table over
    the whole batch gathers the routing of every row over it. ``gloo``:
    the collectives run from the host, so a decode or a training step over
    them cannot be one CUDA graph."""

    comm: ModelComm
    seq: ModelComm
    specs: Any
    data: ModelComm = dataclasses.field(default_factory=ModelComm)

    @property
    def gloo(self) -> bool:
        return "gloo" in (self.comm.backend, self.seq.backend, self.data.backend)

    def collective_host_s(self) -> float:
        comms = {id(c): c for c in (self.comm, self.seq, self.data)}
        return sum(c.host_s for c in comms.values())
