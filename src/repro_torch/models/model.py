"""The LM: embed -> layers (attention, MLA or Mamba-2 mixers, dense or MoE
FFNs) -> final norm -> head (tied to the embedding, or its own (d, V)
``head``).

Multi-codebook models (musicgen) embed (B, S, cb) tokens as the sum of
their codebooks' (cb, V, d) embeddings and give (B, S, cb, V) logits from
a head per codebook. A conditioning prefix ``cond`` (B, L, d) is prepended
at train and prefill (positions count it) and sliced off after the final
norm. DeepSeek's multi-token-prediction head (``mtp``: a projection, an MLA
layer with the dense FFN, a norm, the shared head) predicts t + 2 in a
forward with no caches.

The layer stack is ``lead + pattern * repeats + tail`` (configs/base.py),
run as one Python loop. Parameters come in one of two trees, both with
every weight in the JAX layout (d_in, d_out), applied as ``x @ w``:

* the serving tree ``{"embed", "layers", "final_norm"}`` (and ``"head"``
  when the head is untied, ``"mtp"`` with an MTP head), ``layers`` in
  execution order (:func:`init_params`);
* the training tree, the JAX package's own: ``{"embed", "lead", "scan",
  "tail", "final_norm"}`` (and ``"head"``, ``"mtp"``) with the scan leaves
  stacked by repeat (``repro_torch.weights.to_jax_layout``). The compressor
  plans, scales and counts per leaf, so it must see this tree, with its
  :func:`stacked_flags`; the forward reads each layer as views into it
  (:func:`layer_params`), so the gradients land in the stacked leaves.

Caches keep the JAX tree
layout (``lead``/``scan``/``tail``, scan leaves stacked by repeat: K/V rows
for an attention layer, the latent rows ``{"ckv", "krope"}`` for an MLA
layer, the conv window and SSM state ``{"conv", "ssm"}`` for a Mamba-2
layer); each layer works on views of its slice, so prefill and decode fill
the cache in place.

Tensor parallelism (``forward(..., tp=...)``, a ``core.comm.ModelAxis``):
each rank holds its shard of every leaf the specs ``tp.specs`` split
(``launch/sharding.py``; the serving or the training tree's); the
embedding is vocab-parallel (a rank looks up the ids of its vocab rows,
zeros elsewhere, and the model-axis all-reduce sums the one nonzero term,
exact), the head gives logits over the rank's vocab rows, gathered over
the model axis before sampling (training takes the hidden state and the
vocab-parallel loss of ``train/loss.py`` instead), and each layer reads its
own specs (``models.blocks.layer_forward``).

Modes (same function, driven by the cache arguments):
  * train:   caches=None                      -> logits
  * prefill: caches=zeros, tokens = prompt    -> logits, filled caches
  * decode:  caches=state, tokens = 1 token   -> logits, appended caches
"""

from __future__ import annotations

import functools
from collections.abc import Callable, Iterator
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.comm import copy_to_model
from repro_torch.models.blocks import init_layer, init_layer_cache, layer_forward
from repro_torch.models.common import (
    DTYPES,
    dense_init,
    embed_init,
    resolve_device,
    rms_norm,
)
from repro_torch.serving.kv_cache import QuantKV

__all__ = [
    "init_params",
    "init_caches",
    "forward",
    "apply_head",
    "count_params",
    "layer_caches",
    "layer_params",
    "stacked_flags",
]

Params = dict[str, Any]


def init_params(
    cfg: ModelConfig,
    gen: torch.Generator | int | None = 0,
    device: torch.device | str = "cuda",
    shard: Callable[[tuple, Any], Any] | None = None,
) -> Params:
    """Seeded init: dense 1/sqrt(fan_in) (an untied head's fan-in is d),
    embeddings 0.02, norms 0, then a cast to ``cfg.dtype``. ``gen`` is a
    generator on ``device`` or a seed. On the ``meta`` device the tree
    holds shapes and dtypes only. ``shard(path, subtree)`` (a rank's cut,
    ``weights.init_sharded_params``) takes each part as soon as it is cast
    (``("embed",)``, ``("layers", i)``, ``("final_norm",)``, ``("head",)``,
    ``("mtp",)``), so a rank holds its shards plus one part at a time; the
    draws are the same whatever it keeps."""
    if shard is None:

        def shard(path, tree):
            return tree

    cfg.validate()
    dev = resolve_device(device)
    if dev.type == "meta":
        gen = None
    elif isinstance(gen, int):
        gen = torch.Generator(device=dev).manual_seed(gen)
    # each part is cast as soon as it is drawn, so at most one layer is held
    # in f32 at a time (a 28B-parameter model would not fit in f32)
    dtype = DTYPES[cfg.dtype]
    d, v, cb = cfg.d_model, cfg.vocab_size, cfg.n_codebooks
    embed = embed_init(gen, (cb, v, d) if cb else (v, d), device=dev)
    p: Params = {"embed": shard(("embed",), cast_params(embed, dtype))}
    del embed
    p["layers"] = [
        shard(("layers", i), cast_params(init_layer(gen, spec, cfg, dev, dtype), dtype))
        for i, spec in enumerate(cfg.layers)
    ]
    p["final_norm"] = shard(
        ("final_norm",), torch.zeros(d, device=dev, dtype=dtype)
    )
    if not cfg.tie_embeddings:
        head = dense_init(gen, (cb, d, v) if cb else (d, v), in_dim=d, device=dev)
        p["head"] = shard(("head",), cast_params(head, dtype))
    if cfg.mtp:
        mtp = {
            "proj": dense_init(gen, (2 * d, d), device=dev),
            "norm_h": torch.zeros(d, device=dev),
            "norm_e": torch.zeros(d, device=dev),
            "layer": init_layer(gen, LayerSpec("attn"), cfg, dev, dtype),
            "final_norm": torch.zeros(d, device=dev),
        }
        p["mtp"] = shard(("mtp",), cast_params(mtp, dtype))
    return p


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


def layer_params(params: Params, cfg: ModelConfig) -> Iterator[Params]:
    """Each layer's parameters in execution order: the serving tree's
    ``layers``, or views into the training tree (lead layers, then for each
    repeat r every pattern position's slice r, then tail)."""
    if "layers" in params:
        yield from params["layers"]
        return
    yield from params["lead"]
    for r in range(cfg.repeats):
        for pos in range(len(cfg.pattern)):
            yield _tree_select(params["scan"][pos], r)
    yield from params["tail"]


def _run_layers(
    ps: list[Params],
    specs: tuple[LayerSpec, ...],
    x: torch.Tensor,
    per_layer: Iterator[Params] | None,
    aux_total: torch.Tensor | None = None,
    *,
    cfg: ModelConfig,
    positions: torch.Tensor,
    cache_index: int | torch.Tensor | None,
    plain_attention: bool,
    tp: Any = None,
    pspecs: list[Params] | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """``x`` through the layers of ``specs`` with parameters ``ps``, each
    with its cache from ``per_layer`` (or none). Returns (x, ``aux_total``
    plus the MoE layers' load-balance losses, summed in layer order in f32
    as the JAX scan carries them; None while no MoE layer has run). With
    ``tp`` each layer is read with its parameter specs from ``pspecs``."""
    if pspecs is None:
        pspecs = [None] * len(ps)
    for p, spec, pspec in zip(ps, specs, pspecs, strict=True):
        c = next(per_layer) if per_layer is not None else None
        x, _, aux = layer_forward(
            p,
            x,
            spec,
            cfg,
            positions=positions,
            cache=c,
            cache_index=cache_index,
            plain_attention=plain_attention,
            tp=tp,
            pspec=pspec,
        )
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    return x, aux_total


def _unstack_specs(t: Any) -> Any:
    if isinstance(t, dict):
        return {k: _unstack_specs(v) for k, v in t.items()}
    return type(t)(*tuple(t)[1:])


def _layer_specs(tp: Any, cfg: ModelConfig) -> tuple[list, list, list]:
    """(lead, scan, tail) per-layer parameter specs of ``tp.specs``: the
    serving tree's ``layers`` cut at the same places, or the training
    tree's, each scan position's specs without their stacked dim."""
    if tp is None:
        n_pat = len(cfg.pattern)
        return [None] * len(cfg.lead), [None] * n_pat, [None] * len(cfg.tail)
    specs = tp.specs
    if "layers" in specs:
        layers, n_lead = specs["layers"], len(cfg.lead)
        n_scan = len(cfg.pattern) * cfg.repeats
        scan = layers[n_lead : n_lead + len(cfg.pattern)]
        return layers[:n_lead], scan, layers[n_lead + n_scan :]
    return (
        list(specs["lead"]),
        [_unstack_specs(s) for s in specs["scan"]],
        list(specs["tail"]),
    )


def _tree_select(tree: Any, r: int) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_select(v, r) for k, v in tree.items()}
    return tree[r]


def stacked_flags(params: Params) -> Params:
    """The training tree's flags for the compressor: True on the scan
    leaves (stacked by repeat, compressed per layer), False elsewhere."""

    def flags(t: Any, value: bool) -> Any:
        if isinstance(t, dict):
            return {k: flags(v, value) for k, v in t.items()}
        if isinstance(t, list):
            return [flags(v, value) for v in t]
        return value

    out = flags(params, False)
    out["scan"] = flags(params["scan"], True)
    return out


def _embed(
    params: Params, tokens: torch.Tensor, cfg: ModelConfig, tp: Any = None
) -> torch.Tensor:
    """(B, S) ids -> (B, S, d); (B, S, cb) codebook ids -> the sum of their
    codebooks' embeddings, added in codebook order as the JAX package does.
    A vocab-parallel embedding (``tp``, the vocab dim of the leaf's own
    spec: 0, or 1 of a (cb, V, d) codebook table): this rank's rows, zeros
    for ids outside them, summed over the model axis (each codebook's
    lookup in one all-reduce, then added in codebook order: exact)."""
    cb = cfg.n_codebooks
    vdim = 1 if cb else 0
    if tp is not None and tp.specs["embed"][vdim] is not None:
        w = params["embed"]
        n = w.shape[vdim]
        ids = tokens - tp.comm.rank * n
        mine = (ids >= 0) & (ids < n)
        ids = ids.clamp(0, n - 1)
        if not cb:
            x = torch.where(mine[..., None], w[ids], 0)
            return tp.comm.all_reduce(x, "tp.embed")
        parts = torch.stack(
            [torch.where(mine[..., c, None], w[c][ids[..., c]], 0) for c in range(cb)]
        )
        parts = tp.comm.all_reduce(parts, "tp.embed")
        x = parts[0]
        for c in range(1, cb):
            x = x + parts[c]
        return x
    if not cb:
        return params["embed"][tokens]
    x = params["embed"][0][tokens[..., 0]]
    for c in range(1, cb):
        x = x + params["embed"][c][tokens[..., c]]
    return x


def apply_head(
    params: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    tp: Any = None,
    *,
    gather: bool = True,
) -> torch.Tensor:
    """The LM head: x @ embed.T when tied, else x @ head; with codebooks a
    head per codebook, (B, S, d) -> (B, S, cb, V). A vocab-parallel head
    (``tp``): this rank's vocab columns (of every codebook), gathered over
    the model axis in rank order, so every rank holds the whole (B, S[,
    cb], V); ``gather=False`` keeps the rank's columns (the vocab-parallel
    loss)."""
    tied, cb = cfg.tie_embeddings, cfg.n_codebooks
    w = (params["embed"] if tied else params["head"]).to(x.dtype)
    split = None
    if tp is not None:
        split = tp.specs["embed"][1 if cb else 0] if tied else tp.specs["head"][-1]
        if split is not None:
            x = copy_to_model(x, tp.comm, "tp.head.in")
    if cb:
        logits = torch.einsum("bsd,cvd->bscv" if tied else "bsd,cdv->bscv", x, w)
    else:
        logits = x @ (w.T if tied else w)
    if split is not None and gather:
        logits = tp.comm.all_gather(logits, -1, "tp.head")
    return logits


def _mtp_hidden(
    params: Params,
    x: torch.Tensor,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
    plain_attention: bool,
    tp: Any = None,
) -> torch.Tensor:
    """DeepSeek's MTP block on the final-normed hidden state ``x``: h_t
    joined with the embedding of token t + 1 (a roll by one, the wrapped
    last position masked by the loss), projected, one MLA layer and a norm;
    the shared head then gives its logits. Over a model axis (``tp``) the
    embedding is the vocab-parallel one and the layer runs on the rank's
    shards by its own specs (``tp.specs["mtp"]["layer"]``: its MLA and
    FFN leaves split as the trunk's); the projection and the norms
    replicate and take their whole gradients, before the layer's
    ``copy_to_model``."""
    mp = params["mtp"]
    h_norm = rms_norm(x, mp["norm_h"], cfg.norm_eps)
    e_next = rms_norm(_embed(params, tokens, cfg, tp), mp["norm_e"], cfg.norm_eps)
    e_shift = torch.roll(e_next, -1, dims=1)
    h = torch.cat([h_norm, e_shift], dim=-1) @ mp["proj"].to(x.dtype)
    h, _, _ = layer_forward(
        mp["layer"],
        h,
        LayerSpec("attn"),
        cfg,
        positions=positions,
        plain_attention=plain_attention,
        tp=tp,
        pspec=None if tp is None else tp.specs["mtp"]["layer"],
    )
    return rms_norm(h, mp["final_norm"], cfg.norm_eps)


def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    caches: Params | None = None,
    cache_index: int | torch.Tensor | None = None,
    cond: torch.Tensor | None = None,
    return_hidden: bool = False,
    plain_attention: bool = False,
    remat: bool = False,
    return_aux: bool = False,
    tp: Any = None,
) -> tuple[torch.Tensor, Params | None] | tuple[torch.Tensor, Params | None, Any]:
    """Returns (logits, caches); with ``return_hidden`` the final-normed
    hidden state (B, S, D) instead of logits, for a caller that applies the
    head to a few positions only. ``params`` is the serving or the training
    tree. ``return_aux`` adds a third item, ``{"moe_aux": ...}``: the MoE
    layers' load-balance losses summed in layer order in f32 (0 without MoE
    layers), the JAX forward's ``aux``; with an MTP head, a forward with no
    caches over (B, S > 1) tokens adds ``"mtp_logits"`` (only when
    ``return_aux``: nothing else reads them), or with ``return_hidden`` the
    MTP block's final-normed hidden state ``"mtp_hidden"``, to which the
    caller applies the head (the vocab-parallel loss).

    ``cond`` (B, L, D), train and prefill only: prepended to the embedded
    tokens, positions 0 .. L + S - 1, and sliced off after the final norm,
    so logits and the hidden state cover the S tokens; a prefill's caches
    hold all L + S positions, and decode goes on at index L + S.

    ``remat=True`` (a training forward: no caches) keeps only each repeat's
    input of the scanned pattern for the backward and recomputes the
    repeat's layers there, as the JAX package's ``jax.checkpoint(body)``
    around its scan body does (``remat_scan``); the lead and tail layers
    keep their activations, as in JAX. The values are the same bits. The
    forward draws no random numbers, so no RNG state is saved (reading the
    CUDA generator's state is refused inside a CUDA-graph capture).

    Autograd records the forward unless the caller turns it off: the
    serving steps run under ``torch.no_grad()``. A training forward passes
    ``plain_attention=True``, the plain attention on any device, as the
    JAX package's training step runs its plain (``backend="xla"``)
    attention; the attention and SSD kernels have no backward and refuse
    inputs that require grad. The switch covers the Mamba-2 mixer's SSD
    intra-chunk term too (``models.ssm.mamba_forward``): a training forward
    takes its plain version, which keeps autograd, as the JAX package's
    ``jax.grad`` goes through its plain ``ssd_chunked``.

    tokens: (B, S) integer ids, or (B, S, cb) with codebooks. Embeddings are
    not scaled by sqrt(d), as in the JAX package (unlike Hugging Face's
    Gemma).

    ``tp`` (a ``core.comm.ModelAxis``): this rank's part of a
    tensor-parallel forward over the shards of the serving or the training
    tree, differentiable: the model-axis collectives carry their backward
    (``core.comm.copy_to_model`` and its kin). Serving and training run
    every architecture so (serving leaves the MTP head unused). A ``cond``
    prefix is prepended after the vocab-parallel embedding, so a cache
    split by sequence stores its positions on the ranks that hold them."""
    x = _embed(params, tokens, cfg, tp)
    b, s = x.shape[0], x.shape[1]
    offset = 0
    if cond is not None and s > 1:
        x = torch.cat([cond.to(x.dtype), x], dim=1)
        offset, s = cond.shape[1], x.shape[1]
    if cache_index is None:
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    elif isinstance(cache_index, int):
        positions = torch.full((b, s), cache_index, device=x.device)
    else:
        positions = cache_index[:, None].expand(b, s)

    run = functools.partial(
        _run_layers,
        cfg=cfg,
        positions=positions,
        cache_index=cache_index,
        plain_attention=plain_attention,
        tp=tp,
    )
    lead_s, scan_s, tail_s = _layer_specs(tp, cfg)
    if remat and caches is None and "scan" in params:
        x, aux = run(params["lead"], cfg.lead, x, None, pspecs=lead_s)
        for r in range(cfg.repeats):
            ps = [_tree_select(scan, r) for scan in params["scan"]]
            x, aux = checkpoint(
                functools.partial(run, pspecs=scan_s),
                ps,
                cfg.pattern,
                x,
                None,
                aux,
                use_reentrant=False,
                preserve_rng_state=False,
            )
        x, aux = run(params["tail"], cfg.tail, x, None, aux, pspecs=tail_s)
    else:
        per_layer = layer_caches(caches, cfg) if caches is not None else None
        pspecs = lead_s + scan_s * cfg.repeats + tail_s
        x, aux = run(
            list(layer_params(params, cfg)), cfg.layers, x, per_layer, pspecs=pspecs
        )
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if offset:
        x = x[:, offset:]
    out = x if return_hidden else apply_head(params, x, cfg, tp)
    if not return_aux:
        return out, caches
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    aux_out = {"moe_aux": aux}
    mtp = cfg.mtp and caches is None and tokens.dim() == 2 and tokens.shape[1] > 1
    if mtp:
        h = _mtp_hidden(params, x, tokens, cfg, positions, plain_attention, tp)
        if return_hidden:
            aux_out["mtp_hidden"] = h
        else:
            aux_out["mtp_logits"] = apply_head(params, h, cfg, tp)
    return out, caches, aux_out
