"""Serving engine: prefill, decode, the generate loop, and sampling.

The JAX package jits these steps and runs generation as one ``lax.scan``;
PyTorch runs eagerly, so generation here is a Python loop over decode steps
that keeps every tensor on the device (the host reads tokens only when the
caller asks for them). Sharding of caches over a TPU mesh
(``cache_specs``/``serve_shardings`` in the JAX package) waits for a
multi-chip slice.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import apply_head, forward, init_caches
from repro_torch.serving.kv_cache import CacheQuantConfig, quantize_tree

__all__ = [
    "init_serving_caches",
    "build_prefill_step",
    "build_decode_step",
    "build_generate_fn",
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
    """prefill(params, tokens) -> (logits, caches).

    Logits are last-position (B, 1, V) by default; ``full_logits=True``
    returns every position, so a scheduler can prefill right-padded prompt
    buckets and read position L-1 per request. As in the JAX package the
    cache is filled in ``cache_dtype`` and then, with ``qcfg``, quantized as
    a whole (every ``max_seq`` row); prefill attention runs on the raw K/V."""

    def prefill(params: dict, tokens: torch.Tensor):
        caches = init_caches(cfg, tokens.shape[0], max_seq, cache_dtype, tokens.device)
        x, caches = forward(params, tokens, cfg, caches=caches, return_hidden=True)
        if qcfg is not None and qcfg.bits:
            caches = quantize_tree(caches, qcfg)
        # last-position logits apply the head to one row only
        logits = apply_head(params, x if full_logits else x[:, -1:], cfg)
        return logits, caches

    return prefill


def build_decode_step(cfg: ModelConfig):
    """decode(params, caches, tokens (B, 1), index) -> (logits, caches);
    ``index`` is an int or a (B,) tensor of per-request positions. The
    caches are appended in place and returned."""

    def decode(params: dict, caches: Any, tokens: torch.Tensor, index):
        return forward(params, tokens, cfg, caches=caches, cache_index=index)

    return decode


def build_generate_fn(cfg: ModelConfig, *, temperature: float = 0.0):
    """generate(params, caches, tokens, index, gen, n_steps) ->
    (caches, next_tokens, new_index, sampled (B, n_steps)).

    ``tokens`` is the (B, 1) token each row decodes first; ``gen`` is the
    ``torch.Generator`` that temperature sampling draws from (on the
    device of the logits; unused when greedy)."""
    decode = build_decode_step(cfg)

    def generate(params, caches, tokens, index, gen, n_steps: int):
        tok, idx, out = tokens, index, []
        for _ in range(n_steps):
            logits, caches = decode(params, caches, tok, idx)
            nxt = temperature_sample(gen, logits[:, -1, :], temperature)
            out.append(nxt)
            tok, idx = nxt[:, None], idx + 1
        sampled = torch.stack(out, dim=1) if out else tokens[:, :0]
        return caches, tok, idx, sampled

    return generate


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the last dim (the first index among ties, like jnp)."""
    return logits.argmax(dim=-1)


def temperature_sample(
    gen: torch.Generator | None, logits: torch.Tensor, temperature: float = 1.0
) -> torch.Tensor:
    """Greedy at temperature <= 0, else a categorical draw from
    softmax(logits / temperature) with ``gen``. The JAX package draws with
    ``jax.random``, which this cannot reproduce: parity is greedy only."""
    if temperature <= 0:
        return greedy_sample(logits)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen).squeeze(-1)
