"""TransformerLM: embed -> layers -> final norm -> tied head.

The layer stack is ``lead + pattern * repeats + tail`` (configs/base.py),
run as one Python loop. Parameters are a dict ``{"embed", "layers",
"final_norm"}`` with ``layers`` in execution order and every weight in the
JAX layout (d_in, d_out), applied as ``x @ w``; ``repro_torch.weights``
converts the JAX package's stacked pytree into it. Caches keep the JAX tree
layout (``lead``/``scan``/``tail``, scan leaves stacked by repeat); each
layer works on views of its slice, so prefill and decode fill the cache in
place.

Modes (same function, driven by the cache arguments):
  * train:   caches=None                      -> logits
  * prefill: caches=zeros, tokens = prompt    -> logits, filled caches
  * decode:  caches=state, tokens = 1 token   -> logits, appended caches
"""

from __future__ import annotations

from collections.abc import Iterator
from typing import Any

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models.blocks import init_layer, init_layer_cache, layer_forward
from repro_torch.models.common import DTYPES, embed_init, resolve_device, rms_norm
from repro_torch.serving.kv_cache import QuantKV

__all__ = [
    "init_params",
    "init_caches",
    "forward",
    "apply_head",
    "count_params",
    "layer_caches",
]

Params = dict[str, Any]


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.n_codebooks or cfg.cond_len or cfg.mtp or not cfg.tie_embeddings:
        raise NotImplementedError(
            f"{cfg.name}: untied, multi-codebook, conditioned or MTP heads "
            "come with the LM training slice"
        )


def init_params(
    cfg: ModelConfig,
    gen: torch.Generator | int = 0,
    device: torch.device | str = "cuda",
) -> Params:
    """Seeded init: dense 1/sqrt(fan_in), embeddings 0.02, norms 0, then a
    cast to ``cfg.dtype``. ``gen`` is a generator on ``device`` or a seed."""
    cfg.validate()
    _check_ported(cfg)
    dev = resolve_device(device)
    if isinstance(gen, int):
        gen = torch.Generator(device=dev).manual_seed(gen)
    p: Params = {"embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), device=dev)}
    p["layers"] = [init_layer(gen, spec, cfg, dev) for spec in cfg.layers]
    p["final_norm"] = torch.zeros(cfg.d_model, device=dev)
    return cast_params(p, DTYPES[cfg.dtype])


def cast_params(tree: Any, dtype: torch.dtype) -> Any:
    if isinstance(tree, dict):
        return {k: cast_params(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_params(v, dtype) for v in tree]
    return tree.to(dtype)


def count_params(params: Params) -> int:
    def count(t):
        if isinstance(t, dict):
            return sum(count(v) for v in t.values())
        if isinstance(t, list):
            return sum(count(v) for v in t)
        return t.numel()

    return count(params)


def init_caches(
    cfg: ModelConfig,
    batch: int,
    max_seq: int,
    dtype: torch.dtype,
    device: torch.device | str = "cuda",
) -> Params:
    """Zero raw caches in the JAX tree layout; scan leaves carry a leading
    ``repeats`` dim."""
    dev = resolve_device(device)

    def one(spec: LayerSpec) -> Params:
        return init_layer_cache(spec, cfg, batch, max_seq, dtype, dev)

    scan = []
    for spec in cfg.pattern:
        per = [one(spec) for _ in range(cfg.repeats)]
        scan.append({k: torch.stack([c[k] for c in per]) for k in per[0]})
    return {
        "lead": [one(s) for s in cfg.lead],
        "scan": scan,
        "tail": [one(s) for s in cfg.tail],
    }


def _select(leaf: Any, r: int) -> Any:
    return leaf.select(r) if isinstance(leaf, QuantKV) else leaf[r]


def layer_caches(caches: Params, cfg: ModelConfig) -> Iterator[Params]:
    """Each layer's cache in execution order, as views into ``caches``:
    lead layers, then for each repeat r every pattern position, then tail."""
    yield from caches["lead"]
    for r in range(cfg.repeats):
        for pos in range(len(cfg.pattern)):
            yield {k: _select(v, r) for k, v in caches["scan"][pos].items()}
    yield from caches["tail"]


def apply_head(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Tied LM head: x @ embed.T."""
    return x @ params["embed"].to(x.dtype).T


@torch.no_grad()
def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    caches: Params | None = None,
    cache_index: int | torch.Tensor | None = None,
    return_hidden: bool = False,
) -> tuple[torch.Tensor, Params | None]:
    """Returns (logits, caches); with ``return_hidden`` the final-normed
    hidden state (B, S, D) instead of logits, for a caller that applies the
    head to a few positions only.

    tokens: (B, S) integer ids. Embeddings are not scaled by sqrt(d), as in
    the JAX package (unlike Hugging Face's Gemma)."""
    _check_ported(cfg)
    x = params["embed"][tokens]
    b, s = x.shape[0], x.shape[1]
    if cache_index is None:
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    elif isinstance(cache_index, int):
        positions = torch.full((b, s), cache_index, device=x.device)
    else:
        positions = cache_index[:, None].expand(b, s)

    per_layer = layer_caches(caches, cfg) if caches is not None else None
    for p, spec in zip(params["layers"], cfg.layers):
        c = next(per_layer) if per_layer is not None else None
        x, _ = layer_forward(
            p, x, spec, cfg, positions=positions, cache=c, cache_index=cache_index
        )
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x, caches
    return apply_head(params, x, cfg), caches
