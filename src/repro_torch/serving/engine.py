"""Serving engine: prefill, decode, the generate loop, and sampling.

The JAX package jits these steps and runs generation as one ``lax.scan``,
one dispatch per chunk instead of one per token. Here generation is a
:class:`DecodeLoop`: on CUDA one decode step (decode, sample, append)
captured into a CUDA graph (``repro_torch.graphs``) and replayed once per
token, over buffers the loop owns; on the CPU the same step runs eagerly.
Every tensor stays on the device; the host reads tokens only when the
caller asks for them. Prefill stays eager: a fixed batch prefills once.

Tensor-parallel serving over a ``(data, model)`` mesh of processes
(``launch/mesh.py``) follows the JAX package's layout: :func:`cache_specs`
and :func:`serve_shardings` are its rules (parameters by
``launch/sharding.py``; the K/V cache's batch over data where it divides,
its KV heads over ``model`` where they divide, else its sequence over
``model``, or over data + model where the batch does not split; MLA's
latent rows by sequence alike; the Mamba-2 state by heads and its conv
window by channels). A :class:`ServeShard` (:func:`serve_shard`) is one
rank's part: its batch rows, the zero caches of its shard, and the
``core.comm.ModelAxis`` the steps thread through the forward. All ten
architectures run so with the fixed scheduler, and the token LMs with
the continuous one (``serving/scheduler.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import graphs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.comm import ModelAxis, ModelComm
from repro_torch.launch.sharding import (
    DATA_AXIS,
    MODEL_AXIS,
    Spec,
    cut,
    serving_param_specs,
    shard_count,
    shard_index,
)
from repro_torch.models.model import apply_head, forward, init_caches
from repro_torch.serving.kv_cache import (
    QUANT_CACHE_LEAVES,
    CacheQuantConfig,
    QuantKV,
    map_cache_tree,
    quantize_tree,
    tree_leaves,
)

__all__ = [
    "cache_specs",
    "serve_shardings",
    "ServeShard",
    "serve_shard",
    "init_serving_caches",
    "build_prefill_step",
    "build_decode_step",
    "build_generate_fn",
    "DecodeLoop",
    "greedy_sample",
    "temperature_sample",
]


def _mesh_shape(mesh: Any) -> tuple[int, int]:
    return tuple(mesh.shape) if hasattr(mesh, "shape") else tuple(mesh)


def _batch_axis(batch: int, n_data: int) -> Any:
    """The batch's spec entry: the data axis where it splits the batch."""
    return (DATA_AXIS,) if batch % max(n_data, 1) == 0 and batch >= n_data else None


def cache_specs(
    cfg: ModelConfig,
    mesh: Any,
    batch: int,
    *,
    cache_dtype: torch.dtype = torch.bfloat16,
    qcfg: CacheQuantConfig | None = None,
) -> Any:
    """The JAX package's ``cache_specs`` over a ``(data, model)`` mesh (a
    ``launch.mesh.DataMesh`` or the shape): a tree of
    ``launch.sharding.Spec`` matching :func:`init_serving_caches`, a
    ``QuantKV`` leaf's codes and scale each with the raw leaf's spec (their
    named dims are the same; the last dim is never split).

    * attention K/V (B, Hkv, S, hd): the batch over data where it splits;
      the KV heads over ``model`` where they divide it, else the sequence
      over ``model`` (over data + model where the batch does not split);
    * MLA latent rows (B, S, r): the sequence as above;
    * Mamba-2 conv window (B, K, C) and state (B, H, P, N): channels and
      heads over ``model`` where they divide it."""
    n_data, msize = _mesh_shape(mesh)
    batch_ax = _batch_axis(batch, n_data)
    seq_axes = (MODEL_AXIS,) if batch_ax is not None else (DATA_AXIS, MODEL_AXIS)

    def leaf_spec(path: tuple, x: torch.Tensor) -> Any:
        stacked = path[0] == "scan"  # a leading stacked-layer dim (repeats)
        shape = x.shape[1:] if stacked else x.shape
        name = path[-1]
        if name in ("ckv", "krope"):  # (B, S, r)
            spec = Spec(batch_ax, seq_axes, None)
        elif name in ("k", "v"):  # (B, Hkv, S, hd)
            if shape[1] % msize == 0:
                spec = Spec(batch_ax, MODEL_AXIS, None, None)
            else:
                spec = Spec(batch_ax, None, seq_axes, None)
        elif name == "conv":  # (B, K, C)
            spec = Spec(batch_ax, None, MODEL_AXIS if shape[2] % msize == 0 else None)
        elif name == "ssm":  # (B, H, P, N)
            heads = MODEL_AXIS if shape[1] % msize == 0 else None
            spec = Spec(batch_ax, heads, None, None)
        else:
            spec = Spec(*([None] * len(shape)))
        spec = Spec(None, *spec) if stacked else spec
        if qcfg is not None and qcfg.bits and name in QUANT_CACHE_LEAVES:
            return QuantKV(spec, spec, qcfg.bits, qcfg.alpha, x.shape[-1])
        return spec

    abstract = init_caches(cfg, batch, 8, cache_dtype, "meta")
    return map_cache_tree(abstract, leaf_spec)


def serve_shardings(
    cfg: ModelConfig,
    mesh: Any,
    batch: int,
    *,
    cache_dtype: torch.dtype = torch.bfloat16,
    qcfg: CacheQuantConfig | None = None,
) -> tuple[Any, Any, Spec]:
    """(parameter specs of the serving tree, cache specs, token spec): the
    JAX package's ``serve_shardings`` as specs, since the port's mesh is a
    process group and each rank holds its shards itself (:class:`ServeShard`)."""
    n_data, msize = _mesh_shape(mesh)
    p_specs = serving_param_specs(cfg, msize)
    c_specs = cache_specs(cfg, mesh, batch, cache_dtype=cache_dtype, qcfg=qcfg)
    extra = 2 if cfg.n_codebooks else 1
    t_spec = Spec(_batch_axis(batch, n_data), *([None] * extra))
    return p_specs, c_specs, t_spec


# the cache leaves with a sequence dim (second to last), split alike
SEQ_LEAVES = ("k", "v", "ckv", "krope")


def _seq_entry(c_specs: Any) -> Any:
    """The spec entry of the sequence dim every K/V or latent leaf of a
    cache spec tree takes (None where the tree has none: Mamba-2)."""
    entries = {
        tuple(s)[-2] for path, s in tree_leaves(c_specs) if path[-1] in SEQ_LEAVES
    }
    if len(entries) > 1:
        raise ValueError(f"the sequence leaves take {len(entries)} layouts: {entries}")
    return entries.pop() if entries else None


@dataclasses.dataclass(frozen=True)
class ServeShard:
    """One rank's part of serving ``batch`` rows over ``mesh`` (a
    ``launch.mesh.DataMesh``): the serving tree's parameter specs, the raw
    cache specs and the token spec of :func:`serve_shardings`, and the
    ``ModelAxis`` the steps thread through the forward."""

    mesh: Any
    batch: int
    param_specs: Any
    cache_specs: Any
    token_spec: Spec
    axis: ModelAxis

    def rows(self) -> slice:
        """This rank's rows of the global batch (all of them where the
        batch does not split)."""
        n = shard_count(self.token_spec[0], self.mesh.sizes)
        i = shard_index(self.token_spec[0], self.mesh.sizes, self.mesh.coords)
        per = self.batch // n
        return slice(i * per, (i + 1) * per)

    def seq_shards(self) -> int:
        """How many shards the caches' sequence dim is cut into."""
        return shard_count(_seq_entry(self.cache_specs), self.mesh.sizes)

    def copies(self, path: tuple | None = None) -> int:
        """How many ranks hold each shard of the cache leaf at ``path`` (the
        ranks over which its spec replicates); without ``path``, of the
        K/V or latent leaves (of the first leaf where there are none)."""
        leaves = list(tree_leaves(self.cache_specs))
        if path is None:
            seq = [p for p, _ in leaves if p[-1] in SEQ_LEAVES]
            path = seq[0] if seq else leaves[0][0]
        n = 1
        for e in self._spec_at(path):
            n *= shard_count(e, self.mesh.sizes)
        return self.mesh.world // n

    def zero_caches(
        self, cfg: ModelConfig, max_seq: int, dtype: torch.dtype, device: Any
    ) -> Any:
        """This rank's shard of ``init_caches(cfg, batch, max_seq, ...)``:
        zeros of each leaf's cut shape, raw (a Mamba-2 layer's SSM state in
        f32, as ``init_caches`` makes it)."""
        if max_seq % self.seq_shards():
            raise ValueError(
                f"a cache of {max_seq} positions does not split into "
                f"{self.seq_shards()} sequence shards"
            )
        abstract = init_caches(cfg, self.batch, max_seq, dtype, "meta")
        sizes, coords = self.mesh.sizes, self.mesh.coords

        def zeros(path: tuple, x: torch.Tensor) -> torch.Tensor:
            spec = self._spec_at(path)
            shape = cut(x, spec, sizes, coords).shape
            return torch.zeros(shape, dtype=x.dtype, device=device)

        return map_cache_tree(abstract, zeros)

    def one_row(self) -> ServeShard:
        """The layout of one request's prefill on this rank's data row (the
        continuous scheduler's admission): a batch of one, whole, with the
        grid's split of every other dim, the same model-axis and sequence
        comms, and no data-axis gather (the other data rows do not run
        it)."""

        def whole_batch(path: tuple, spec: Spec) -> Spec:
            entries = list(spec)
            entries[1 if path[0] == "scan" else 0] = None  # after the repeats
            return Spec(*entries)

        c_specs = map_cache_tree(self.cache_specs, whole_batch)
        t_spec = Spec(None, *tuple(self.token_spec)[1:])
        axis = dataclasses.replace(self.axis, data=ModelComm())
        return dataclasses.replace(
            self, batch=1, cache_specs=c_specs, token_spec=t_spec, axis=axis
        )

    def _spec_at(self, path: tuple) -> Spec:
        sub = self.cache_specs
        for k in path:
            sub = sub[k]
        return sub


def serve_shard(
    cfg: ModelConfig,
    mesh: Any,
    batch: int,
    *,
    cache_dtype: torch.dtype = torch.bfloat16,
) -> ServeShard:
    """This rank's :class:`ServeShard` of ``batch`` rows over ``mesh``: the
    specs, the model-axis comm over the mesh's model group, the comm of the
    group the caches' sequence is cut over (the model group, or every rank
    where the sequence is cut over data + model) and the comm of the
    data-axis group the rows are cut over (for an MoE layer's table). Every
    architecture serves so."""
    if mesh.distributed and mesh.world != mesh.data * mesh.model:
        raise ValueError(
            f"serving over a {mesh.data}x{mesh.model} mesh takes "
            f"{mesh.data * mesh.model} ranks, not {mesh.world}"
        )
    p_specs, c_specs, t_spec = serve_shardings(
        cfg, mesh, batch, cache_dtype=cache_dtype
    )
    comm = ModelComm(mesh.model_group, mesh.model, mesh.model_index)
    seq_entry = _seq_entry(c_specs)
    n_seq = shard_count(seq_entry, mesh.sizes)
    if n_seq == 1:
        seq = ModelComm()
    elif seq_entry == MODEL_AXIS:
        seq = comm
    else:  # data + model: every rank, in global rank order
        rank = shard_index(seq_entry, mesh.sizes, mesh.coords)
        seq = ModelComm(dist.group.WORLD, n_seq, rank)
    n_rows = shard_count(t_spec[0], mesh.sizes)
    data = ModelComm(mesh.data_group, n_rows, mesh.data_index) if n_rows > 1 else None
    axis = ModelAxis(comm=comm, seq=seq, specs=p_specs, data=data or ModelComm())
    return ServeShard(mesh, batch, p_specs, c_specs, t_spec, axis)


def init_serving_caches(
    cfg: ModelConfig,
    batch: int,
    max_seq: int,
    cache_dtype: torch.dtype = torch.bfloat16,
    qcfg: CacheQuantConfig | None = None,
    device: torch.device | str = "cuda",
    shard: ServeShard | None = None,
) -> Any:
    """Zero caches in the serving container format: raw ``cache_dtype``
    tensors, or ``QuantKV`` leaves when ``qcfg.bits`` is 4 or 8; with
    ``shard``, this rank's shard of them (``batch`` is the global batch)."""
    if shard is not None:
        caches = shard.zero_caches(cfg, max_seq, cache_dtype, device)
    else:
        caches = init_caches(cfg, batch, max_seq, cache_dtype, device)
    if qcfg is not None and qcfg.bits:
        caches = quantize_tree(caches, qcfg)
    return caches


def build_prefill_step(
    cfg: ModelConfig,
    max_seq: int,
    *,
    cache_dtype: torch.dtype = torch.bfloat16,
    qcfg: CacheQuantConfig | None = None,
    full_logits: bool = False,
    shard: ServeShard | None = None,
):
    """prefill(params, tokens[, cond]) -> (logits, caches).

    With ``shard`` the step is a rank's part of a tensor-parallel prefill:
    ``params`` are its shards, ``tokens`` its rows of the batch, the caches
    its shard, and the logits the whole vocab (gathered over the model
    axis).

    ``tokens`` is (B, S), or (B, S, cb) with codebooks (logits (B, ., cb,
    V)); ``cond`` (B, L, d) is a conditioning prefix: the caches hold its L
    positions before the prompt's (``max_seq`` must count them), and the
    logits cover the prompt only. Logits are last-position (B, 1, V) by
    default; ``full_logits=True`` returns every position, so a scheduler
    can prefill right-padded prompt buckets and read position L-1 per
    request. As in the JAX package the
    cache is filled in ``cache_dtype`` and then, with ``qcfg``, quantized as
    a whole (every ``max_seq`` row); prefill attention runs on the raw K/V."""

    @torch.no_grad()
    def prefill(params: dict, tokens: torch.Tensor, cond: torch.Tensor | None = None):
        b = tokens.shape[0]
        dev = tokens.device
        caches = init_serving_caches(cfg, b, max_seq, cache_dtype, None, dev, shard)
        tp = shard.axis if shard is not None else None
        x, caches = forward(
            params, tokens, cfg, caches=caches, cond=cond, return_hidden=True, tp=tp
        )
        if qcfg is not None and qcfg.bits:
            caches = quantize_tree(caches, qcfg)
        # last-position logits apply the head to one row only
        logits = apply_head(params, x if full_logits else x[:, -1:], cfg, tp)
        return logits, caches

    return prefill


def build_decode_step(cfg: ModelConfig, shard: ServeShard | None = None):
    """decode(params, caches, tokens (B, 1[, cb]), index) -> (logits, caches);
    ``index`` is an int or a (B,) long tensor of per-request positions on
    the device (continuous batching, and any graphed step, which must not
    bake a position in). Within range both give the same logits and
    caches. The caches are appended in place and returned. With ``shard``
    a rank's part of a tensor-parallel decode (see
    :func:`build_prefill_step`)."""
    tp = shard.axis if shard is not None else None

    @torch.no_grad()
    def decode(params: dict, caches: Any, tokens: torch.Tensor, index):
        return forward(params, tokens, cfg, caches=caches, cache_index=index, tp=tp)

    return decode


class DecodeLoop:
    """``n_steps`` decode steps of a batch of ``batch`` rows over ``caches``
    (appended in place), each step decoding ``tok`` at ``idx``, sampling
    the next token into ``tok`` and column ``i`` of ``sampled`` (B,
    n_steps), and advancing ``idx``. With codebooks a row's token is one id
    a codebook, sampled per codebook: ``tok`` (B, 1, cb), ``sampled`` (B,
    n_steps, cb). On CUDA (unless ``graph=False``) the step is a :class:`~repro_torch.graphs.StepGraph`: ``tok``, the (B,)
    positions, the column counter and ``sampled`` are static buffers, and a
    loop that runs again (the continuous scheduler's chunks) replays the
    graph it captured the first time. ``graph=True`` on the CPU raises.
    ``gen`` is the generator temperature sampling draws from (every rank of
    a tensor-parallel ``shard`` draws from the same gathered logits with a
    generator seeded alike, so the ranks agree). Over a ``shard`` whose
    collectives run on gloo the caller asks for the eager steps
    (``graph=False``): a capture there raises, since gloo runs them from
    the host; over NCCL the graph captures them."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        caches: Any,
        batch: int,
        n_steps: int,
        *,
        temperature: float = 0.0,
        gen: torch.Generator | None = None,
        graph: bool | None = None,
        shard: ServeShard | None = None,
    ):
        device = params["embed"].device
        self._decode = build_decode_step(cfg, shard)
        self.params, self.caches = params, caches
        self.temperature, self.gen = temperature, gen
        self.n_steps = n_steps
        cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
        self.tok = torch.zeros((batch, 1) + cb, dtype=torch.long, device=device)
        self._index = torch.zeros((batch,), dtype=torch.long, device=device)
        self.idx: int | torch.Tensor = self._index
        self._col = torch.zeros((1,), dtype=torch.long, device=device)
        self.sampled = torch.zeros(
            (batch, n_steps) + cb, dtype=torch.long, device=device
        )
        self._graph = None
        capture = graph or (graph is None and device.type == "cuda")
        if capture and shard is not None and shard.axis.gloo:
            raise ValueError(
                "a CUDA graph cannot capture gloo's collectives, which run "
                "from the host: decode with graph=False, or over NCCL"
            )
        if graphs.use_graph(graph, device):
            draws = gen is not None and temperature > 0
            self._graph = graphs.StepGraph(
                self._step, device, generators=[gen] if draws else []
            )

    @property
    def capture_s(self) -> float:
        """Host seconds spent capturing graphs so far (0 when eager)."""
        return self._graph.capture_s if self._graph is not None else 0.0

    def _step(self) -> None:
        logits, _ = self._decode(self.params, self.caches, self.tok, self.idx)
        nxt = temperature_sample(self.gen, logits[:, -1, :], self.temperature)
        self.sampled.index_copy_(1, self._col, nxt[:, None])
        self._col.add_(1)
        self.tok.copy_(nxt[:, None])
        if isinstance(self.idx, int):
            self.idx += 1
        else:
            self.idx.add_(1)

    def run(self, tokens: torch.Tensor, index: int | torch.Tensor) -> torch.Tensor:
        """Decode ``n_steps`` tokens from ``tokens`` (B, 1[, cb]) at ``index``, an
        int or a (B,) tensor of positions; returns ``sampled``. Eagerly an
        int index takes the int path; a graph takes it as a (B,) tensor."""
        self.tok.copy_(tokens)
        self._col.zero_()
        if isinstance(index, int) and self._graph is None:
            self.idx = index
        else:
            self._index[:] = index
            self.idx = self._index
        if self._graph is not None:
            self._graph.run(self.n_steps)
        else:
            for _ in range(self.n_steps):
                self._step()
        return self.sampled


def build_generate_fn(
    cfg: ModelConfig,
    *,
    temperature: float = 0.0,
    graph: bool | None = None,
    shard: ServeShard | None = None,
):
    """generate(params, caches, tokens, index, gen, n_steps) ->
    (caches, next_tokens, new_index, sampled (B, n_steps[, cb])).

    ``tokens`` is the (B, 1[, cb]) token each row decodes first, at ``index`` (an
    int or a (B,) tensor); ``gen`` is the ``torch.Generator`` that
    temperature sampling draws from (on the device of the logits; unused
    when greedy). Each call runs a :class:`DecodeLoop`: on CUDA a graph
    captured for the call and replayed ``n_steps - 1`` times, unless
    ``graph=False``; ``graph=True`` on the CPU raises. After a call
    ``generate.capture_s`` holds the host seconds of its capture."""

    def generate(params, caches, tokens, index, gen, n_steps: int):
        loop = DecodeLoop(
            cfg,
            params,
            caches,
            tokens.shape[0],
            n_steps,
            temperature=temperature,
            gen=gen,
            graph=graph,
            shard=shard,
        )
        sampled = loop.run(tokens, index)
        generate.capture_s = loop.capture_s
        return caches, loop.tok, index + n_steps, sampled

    generate.capture_s = 0.0
    return generate


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the last dim (the first index among ties, like jnp)."""
    return logits.argmax(dim=-1)


def temperature_sample(
    gen: torch.Generator | None, logits: torch.Tensor, temperature: float = 1.0
) -> torch.Tensor:
    """Greedy at temperature <= 0, else a categorical draw from
    softmax(logits / temperature) with ``gen``. The draw is an exponential
    race, argmax of probs / E with E ~ Exp(1) from ``gen``: what
    ``torch.multinomial`` computes for one sample, without its host-side
    check of the probabilities, which a CUDA graph cannot capture. The JAX
    package draws with ``jax.random``, which this cannot reproduce: parity
    is greedy only."""
    if temperature <= 0:
        return greedy_sample(logits)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    race = torch.empty_like(probs).exponential_(1.0, generator=gen)
    return (probs / race).argmax(dim=-1)
