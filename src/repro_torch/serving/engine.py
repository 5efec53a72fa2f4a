"""Serving engine: prefill, decode, the generate loop, and sampling.

The JAX package jits these steps and runs generation as one ``lax.scan``,
one dispatch per chunk instead of one per token. Here generation is a
:class:`DecodeLoop`: on CUDA one decode step (decode, sample, append)
captured into a CUDA graph (``repro_torch.graphs``) and replayed once per
token, over buffers the loop owns; on the CPU the same step runs eagerly.
Every tensor stays on the device; the host reads tokens only when the
caller asks for them. Prefill stays eager: a fixed batch prefills once.
Sharding of caches over a TPU mesh (``cache_specs``/``serve_shardings`` in
the JAX package) waits for multi-GPU serving.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import graphs
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import apply_head, forward, init_caches
from repro_torch.serving.kv_cache import CacheQuantConfig, quantize_tree

__all__ = [
    "init_serving_caches",
    "build_prefill_step",
    "build_decode_step",
    "build_generate_fn",
    "DecodeLoop",
    "greedy_sample",
    "temperature_sample",
]


def init_serving_caches(
    cfg: ModelConfig,
    batch: int,
    max_seq: int,
    cache_dtype: torch.dtype = torch.bfloat16,
    qcfg: CacheQuantConfig | None = None,
    device: torch.device | str = "cuda",
) -> Any:
    """Zero caches in the serving container format: raw ``cache_dtype``
    tensors, or ``QuantKV`` leaves when ``qcfg.bits`` is 4 or 8."""
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
):
    """prefill(params, tokens[, cond]) -> (logits, caches).

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
        caches = init_caches(cfg, tokens.shape[0], max_seq, cache_dtype, tokens.device)
        x, caches = forward(
            params, tokens, cfg, caches=caches, cond=cond, return_hidden=True
        )
        if qcfg is not None and qcfg.bits:
            caches = quantize_tree(caches, qcfg)
        # last-position logits apply the head to one row only
        logits = apply_head(params, x if full_logits else x[:, -1:], cfg)
        return logits, caches

    return prefill


def build_decode_step(cfg: ModelConfig):
    """decode(params, caches, tokens (B, 1[, cb]), index) -> (logits, caches);
    ``index`` is an int or a (B,) long tensor of per-request positions on
    the device (continuous batching, and any graphed step, which must not
    bake a position in). Within range both give the same logits and
    caches. The caches are appended in place and returned."""

    @torch.no_grad()
    def decode(params: dict, caches: Any, tokens: torch.Tensor, index):
        return forward(params, tokens, cfg, caches=caches, cache_index=index)

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
    ``gen`` is the generator temperature sampling draws from."""

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
    ):
        device = params["embed"].device
        self._decode = build_decode_step(cfg)
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
    cfg: ModelConfig, *, temperature: float = 0.0, graph: bool | None = None
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
