"""Parameter and batch sharding over the tensor-parallel (model) axis: the
port's copy of the JAX package's ``launch/sharding.py`` rules.

Megatron-style: QKV / up / gate column-parallel, O / down row-parallel,
vocab-parallel embedding and head, expert-parallel MoE (the expert dim when
it divides the axis, else replicated). The data axis replicates
parameters. The rules are path-keyed, with the JAX package's substring
semantics on its key paths (``"['scan'][0]['mixer']['wq']"``: ``"head" in
path``, ``"up" in path``, ``"'fc'" in path``, ...), so they run on the
training tree (``weights.to_jax_layout``), whose stacked scan leaves take a
leading None for their layer dim; :func:`serving_param_specs` carries them
to the serving tree ``{"embed", "layers", "final_norm"[, "head"]}``.

A spec is a :class:`Spec`: one entry a dim, each None (not split), an axis
name, or a tuple of names (split over their product, the first major).

Training over the model axis reads two more things from the specs:
:func:`split_dim` (which dim of a leaf the model axis cuts) and
:func:`partial_grad_flags` (which replicated leaves a rank holds whole but
receives only a partial gradient for, by where they are used).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig

__all__ = [
    "MODEL_AXIS",
    "DATA_AXIS",
    "Spec",
    "param_specs",
    "serving_param_specs",
    "batch_spec",
    "assert_replicated",
    "spec_tree_leaves",
    "flatten_specs",
    "shard_count",
    "shard_index",
    "cut",
    "split_dim",
    "partial_grad_flags",
]

# the subtrees of a layer whose input enters through ``copy_to_model`` when
# one of their products splits over the model axis
BRANCHES = ("mixer", "ffn")
# MLA's latent down-projections: split by columns, gathered whole before use
GATHERED = ("wq_a", "wkv_a")

MODEL_AXIS = "model"
DATA_AXIS = "data"


def _entry(e: Any) -> Any:
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return e[0] if len(e) == 1 else e
    return e


class Spec(tuple):
    """A partition spec: a tuple of entries, a one-name tuple stored as the
    name (as JAX's ``PartitionSpec`` normalizes it), so ``tuple(spec)``
    equals ``tuple(P(...))`` of the same rule."""

    def __new__(cls, *entries: Any) -> Spec:
        return super().__new__(cls, (_entry(e) for e in entries))

    def __getnewargs__(self) -> tuple:
        return tuple(self)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def _leaf_spec(
    path: str, shape: tuple[int, ...], axis: str, size: int, cfg: Any = None
) -> Spec:
    """Partition rule for one (unstacked) leaf: the JAX package's
    ``_leaf_spec``, rule for rule and in its order. Attention projections
    split over the model axis only where the HEAD COUNT divides it; Mamba-2's
    fused projections stay replicated."""
    nd = len(shape)

    def m(d: int) -> bool:
        return _div(shape[d], size)

    heads_ok = cfg is not None and _div(getattr(cfg, "n_heads", 0), size)
    kv_ok = cfg is not None and _div(getattr(cfg, "n_kv_heads", 0), size)
    rep = Spec(*([None] * nd))

    # embeddings / heads
    if "embed" in path:
        if nd == 3:  # (codebooks, V, D)
            return Spec(None, axis if m(1) else None, None)
        return Spec(axis if m(0) else None, None)
    if "head" in path or "'fc'" in path:
        if nd == 3:  # (codebooks, D, V)
            return Spec(None, None, axis if m(2) else None)
        if nd == 2:
            return Spec(None, axis if m(1) else None)
        return Spec(None)
    # MoE: the router replicates; expert stacks (E, D, F) / (E, F, D) split
    # on E where it divides the axis, else replicate
    if "router" in path:
        return rep
    if "w_gate" in path or "w_up" in path or "w_down" in path:
        return Spec(axis, None, None) if m(0) else Spec(None, None, None)
    # attention (head-boundary aware)
    if "wq_b" in path or "wkv_b" in path:  # MLA up-projections (r, H*dim)
        return Spec(None, axis if (heads_ok and m(1)) else None)
    if "wq" in path:
        return Spec(None, axis if (heads_ok and m(1)) else None)
    if "wk" in path or "wv" in path:
        return Spec(None, axis if (kv_ok and m(1)) else None)
    if "wo" in path:  # row-parallel over heads
        return Spec(axis if (heads_ok and m(0)) else None, None)
    if "bq" in path:
        return Spec(axis if (heads_ok and m(0)) else None)
    if "bk" in path or "bv" in path:
        return Spec(axis if (kv_ok and m(0)) else None)
    # MLA latent down-projections
    if "wq_a" in path:
        return Spec(None, axis if m(1) else None)
    if "wkv_a" in path:  # fused (ckv | rope): replicate
        return rep
    # Mamba-2: fused projections replicate
    if any(k in path for k in ("in_proj", "out_proj", "conv_w", "conv_b")):
        return rep
    # dense MLP
    if "gate" in path or "up" in path:
        return Spec(None, axis if m(1) else None)
    if "down" in path:
        return Spec(axis if m(0) else None, None)
    # everything else: norms, scalars, A_log, D, dt_bias, ...
    return rep


def _walk(tree: Any, path: str = ""):
    """(keystr path, leaf) pairs of a dict / list tree, in the JAX package's
    ``keystr`` format (``['key']``, ``[i]``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}[{i}]")
    else:
        yield path, tree


def _rebuild(tree: Any, leaves: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        return [_rebuild(v, leaves) for v in tree]
    return next(leaves)


def param_specs(
    abstract_params: Any,
    stacked: Any | None = None,
    axis: str = MODEL_AXIS,
    axis_size: int = 1,
    cfg: Any | None = None,
) -> Any:
    """A tree of :class:`Spec` matching ``abstract_params`` (tensors, meta
    ones included: only shapes are read). ``stacked`` (the training tree's
    ``models.model.stacked_flags``) marks the leaves whose leading dim
    stacks layers: they get a leading None."""
    flat = list(_walk(abstract_params))
    if stacked is None:
        flags = [False] * len(flat)
    else:
        flags = [f for _, f in _walk(stacked)]
    specs = []
    for (path, leaf), st in zip(flat, flags, strict=True):
        shape = tuple(leaf.shape)
        if st:
            inner = _leaf_spec(path, shape[1:], axis, axis_size, cfg)
            specs.append(Spec(None, *inner))
        else:
            specs.append(_leaf_spec(path, shape, axis, axis_size, cfg))
    return _rebuild(abstract_params, iter(specs))


def serving_param_specs(cfg: ModelConfig, axis_size: int) -> Any:
    """The specs of the serving tree (``models.model.init_params``) over a
    model axis of ``axis_size``: :func:`param_specs` of the training tree
    of a ``meta`` init, with its stacked flags, then each scan leaf's spec
    unstacked (its leading None dropped) into the layers in execution
    order, as ``weights.params_from_jax`` unstacks the leaves."""
    from repro_torch.models.model import init_params, stacked_flags
    from repro_torch.weights import to_jax_layout

    train = to_jax_layout(init_params(cfg, None, "meta"), cfg)
    specs = param_specs(train, stacked_flags(train), axis_size=axis_size, cfg=cfg)

    def unstack(t: Any) -> Any:
        if isinstance(t, dict):
            return {k: unstack(v) for k, v in t.items()}
        return Spec(*t[1:])

    layers = list(specs["lead"])
    for _ in range(cfg.repeats):
        layers += [unstack(s) for s in specs["scan"]]
    layers += list(specs["tail"])
    out = {
        "embed": specs["embed"],
        "layers": layers,
        "final_norm": specs["final_norm"],
    }
    for key in ("head", "mtp"):
        if key in specs:
            out[key] = specs[key]
    return out


def batch_spec(dp_axes: tuple[str, ...], extra_dims: int = 1) -> Spec:
    """Tokens (B, S[, cb]) split over the data-parallel axes on batch."""
    return Spec(dp_axes, *([None] * extra_dims))


def assert_replicated(specs: Any, what: str) -> None:
    """Raise unless every :class:`Spec` in ``specs`` is fully replicated:
    for values that feed worker-uniform control flow (the JAX package's
    lazy-aggregation counters), where a sharded spec would let the ranks'
    branches diverge."""
    for path, spec in _walk(specs):
        if any(a is not None for a in spec):
            raise AssertionError(
                f"{what}{path}: spec {spec} is not replicated — "
                "worker-uniform control flow would diverge"
            )


def spec_tree_leaves(specs: Any) -> list[tuple[str, Spec]]:
    """(keystr path, spec) pairs of a spec tree."""
    return list(_walk(specs))


def flatten_specs(specs: Any, path: str = "") -> list[tuple[str, Spec]]:
    """(keystr path, spec) pairs of a spec tree in JAX flatten order (a
    dict's keys sorted), the order the compressor numbers its leaves in
    (``core/tree.py``)."""
    if isinstance(specs, dict):
        items = [(f"[{k!r}]", specs[k]) for k in sorted(specs)]
    elif isinstance(specs, (list, tuple)) and not isinstance(specs, Spec):
        items = [(f"[{i}]", v) for i, v in enumerate(specs)]
    else:
        return [(path, specs)]
    return [x for key, v in items for x in flatten_specs(v, path + key)]


def _axes(entry: Any) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_count(entry: Any, sizes: dict[str, int]) -> int:
    """How many shards a spec entry cuts its dim into over a mesh of axis
    ``sizes``."""
    n = 1
    for a in _axes(entry):
        n *= sizes[a]
    return n


def shard_index(entry: Any, sizes: dict[str, int], coords: dict[str, int]) -> int:
    """This rank's shard of a dim cut by ``entry``, the first axis major, as
    a ``jax.sharding.NamedSharding`` lays a dim over several mesh axes."""
    i = 0
    for a in _axes(entry):
        i = i * sizes[a] + coords[a]
    return i


def cut(t: torch.Tensor, spec: Spec, sizes: dict[str, int], coords: dict[str, int]):
    """This rank's block of ``t`` under ``spec`` (views; a dim that does not
    divide raises)."""
    if len(spec) != t.dim():
        raise ValueError(f"spec {spec} for a tensor of shape {tuple(t.shape)}")
    for dim, entry in enumerate(spec):
        n = shard_count(entry, sizes)
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(
                f"dim {dim} of {tuple(t.shape)} does not split into {n} shards"
            )
        size = t.shape[dim] // n
        t = t.narrow(dim, shard_index(entry, sizes, coords) * size, size)
    return t


def split_dim(spec: Spec) -> int | None:
    """The dim of a leaf that ``spec`` cuts over the model axis, or None
    where the leaf is whole on every model rank. Only the model axis splits
    parameters (the data axis replicates them), and at most one dim."""
    dims = [d for d, e in enumerate(spec) if MODEL_AXIS in _axes(e)]
    if len(dims) > 1:
        raise ValueError(f"spec {spec} splits {len(dims)} dims over the model axis")
    return dims[0] if dims else None


def partial_grad_flags(specs: Any) -> Any:
    """A tree of bools matching ``specs``: True on a replicated leaf used
    inside a branch split over the model axis, whose gradient a rank holds
    only in part. A layer's attention mixer or dense FFN (:data:`BRANCHES`)
    is split where one of its leaves splits: its input passes a
    ``copy_to_model``, each rank runs its heads or columns, and a
    replicated leaf inside it (K/V projections over too few KV heads, the
    QK norms, a replicated bias, MLA's latent norms) sees only the rank's
    heads' part of the gradient, which the step sums over the model axis.
    MLA's column-split latent down-projections (:data:`GATHERED`) do not
    split their mixer by themselves: their outputs are gathered whole
    (``models/mla.py:_latents``). An MoE FFN (one with a ``router``) has no
    such leaf: the router and any expert stack or shared expert the axis
    does not split run on the FFN's input itself, and only the split parts
    on its copy (``models/moe.py``). A replicated leaf used before the
    ``copy_to_model`` (the pre-norms, the final norm, the MTP head's
    projection and norms) or in a branch that does not split (a Mamba-2
    mixer, whose leaves all replicate) receives its whole gradient."""

    def splits(path: str, spec: Spec) -> bool:
        name = path.rsplit("[", 1)[-1].strip("']")
        return split_dim(spec) is not None and name not in GATHERED

    def flags(t: Any, inside: bool) -> Any:
        if isinstance(t, dict):
            out = {}
            for k, v in t.items():
                split = k in BRANCHES and isinstance(v, dict) and "router" not in v
                split = split and any(splits(p, s) for p, s in _walk(v))
                out[k] = flags(v, inside or split)
            return out
        if isinstance(t, (list, tuple)) and not isinstance(t, Spec):
            return [flags(v, inside) for v in t]
        return inside and split_dim(t) is None

    return flags(specs, False)
