"""Quantized, paged KV-cache layer: log-quant codes + per-block scales.

Attention K/V cache leaves are stored as b-bit log-quant codes plus one f32
scale per **block**, a block being one token's ``head_dim`` row per (batch,
kv_head, position). The encode is the wire codec verbatim
(:class:`repro_torch.core.codec.LogQuantCodec`): per-block max-abs
normalize in plain torch, then the Triton encode kernel with scale 1.0
(the fused encode + nibble pack for b = 4). The read is the row-scaled
Triton dequant kernel. On the CPU both take their plain versions.

Layout of a quantized leaf (:class:`QuantKV`), as in the JAX package:

    raw   (..., S, d)                  cache dtype
    codes (..., S, ceil(d/2)) int8     b = 4 (nibble-packed, d padded even)
    codes (..., S, d)         int8     b = 8
    scale (..., S, 1)         float32

so cache bytes/token equal the wire's ``packed_wire_bits`` plus 32 bits of
scale per block. Cache trees keep the JAX layout ``{"lead": [...], "scan":
[...], "tail": [...]}`` with scan leaves stacked by repeat, so trees, byte
counts and the scheduler's slot insert compare leaf by leaf.

Unlike the JAX package, whose arrays are immutable, decode appends and slot
inserts write into the cache tensors in place: the cache is the largest
state of serving, and a copy per token would double its traffic.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Iterator
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.codec import LogQuantCodec, packed_wire_bits
from repro_torch.kernels import ops

__all__ = [
    "QuantKV",
    "CacheQuantConfig",
    "QUANT_CACHE_LEAVES",
    "row_bytes",
    "quantize_kv",
    "dequantize_kv",
    "seq_update",
    "kv_update_token",
    "kv_read",
    "map_cache_tree",
    "quantize_tree",
    "tree_leaves",
    "tree_is_quantized",
    "cache_bytes_per_token",
    "cache_bytes_per_token_accounting",
    "BlockPool",
]

# cache leaf names eligible for quantization: append-only attention K/V and
# the MLA latent rows (SSM state is rewritten every step and stays raw)
QUANT_CACHE_LEAVES = ("k", "v", "ckv", "krope")


@dataclasses.dataclass
class QuantKV:
    """One quantized cache leaf: packed codes + per-block scales. ``d`` is
    the logical last-dim size; for b <= 4 the codes' last dim is ceil(d/2)."""

    codes: torch.Tensor
    scale: torch.Tensor
    bits: int
    alpha: float
    d: int

    def select(self, i: int) -> QuantKV:
        """The leaf's i-th entry along the leading (stacked-repeat) dim, as
        views: writes through it land in this leaf."""
        return QuantKV(self.codes[i], self.scale[i], self.bits, self.alpha, self.d)


@dataclasses.dataclass(frozen=True)
class CacheQuantConfig:
    """Serving-cache codec knobs. ``bits`` in {4, 8} (0 = raw cache)."""

    bits: int = 8
    alpha: float = 10.0

    def __post_init__(self):
        if self.bits not in (0, 4, 8):
            raise ValueError(f"cache bits must be 0, 4 or 8, got {self.bits}")


def row_bytes(d: int, bits: int) -> int:
    """Packed container bytes of one d-element block (training-wire layout)."""
    return packed_wire_bits(d, bits) // 8


def quantize_kv(x: torch.Tensor, bits: int, alpha: float = 10.0) -> QuantKV:
    """(..., S, d) values -> QuantKV with per-(..., S) block scales.

    Per-block max-abs normalize, then ``LogQuantCodec.encode`` over the
    flattened rows. For b <= 4 and odd d the row is padded to even length
    first, so nibble pairs never straddle blocks; pad positions encode as 0.
    An all-zero row gets scale 0 and, through the safe scale 1, code 0."""
    d = x.shape[-1]
    x = x.float()
    scale = x.abs().amax(dim=-1, keepdim=True)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    xn = x / safe
    if bits <= 4 and d % 2:
        xn = F.pad(xn, (0, 1))
    wire = LogQuantCodec(bits=bits, alpha=alpha).encode(xn.contiguous())
    codes = wire.reshape(x.shape[:-1] + (row_bytes(d, bits),))
    return QuantKV(codes=codes, scale=scale, bits=bits, alpha=alpha, d=d)


def dequantize_kv(q: QuantKV, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """QuantKV -> (..., S, d) values: the dequantize-on-read path."""
    lead = q.codes.shape[:-1]
    nb = q.codes.shape[-1]
    flat = ops.log_dequantize_rows(
        q.codes.reshape(-1, nb),
        q.scale.reshape(-1, 1).float(),
        bits=q.bits,
        alpha=q.alpha,
    )
    return flat[:, : q.d].reshape(lead + (q.d,)).to(dtype)


# --------------------------------------------------------------- updates


def seq_update(
    arr: torch.Tensor, new: torch.Tensor, idx: int | torch.Tensor, axis: int
) -> torch.Tensor:
    """Write ``new`` (seq dim 1 at ``axis``) into ``arr`` at position ``idx``,
    in place, and return ``arr``.

    An int ``idx`` writes one slice (the fixed-batch decode append). A (B,)
    tensor writes each request at its own position (batch is dim 0), the
    continuous-batching path; a position past the end is dropped, as the
    JAX package's one-hot select drops it."""
    new = new.to(arr.dtype)
    s = arr.shape[axis]
    if isinstance(idx, int):
        if not 0 <= idx < s:
            raise IndexError(f"cache position {idx} outside [0, {s})")
        arr.narrow(axis, idx, 1).copy_(new)
        return arr
    rows = torch.arange(arr.shape[0], device=arr.device)
    pos = idx.clamp(max=s - 1)
    sel = (rows,) + (slice(None),) * (axis - 1) + (pos,)
    vals = new.select(axis, 0)
    keep = (idx < s).view((-1,) + (1,) * (vals.dim() - 1))
    arr[sel] = torch.where(keep, vals, arr[sel])
    return arr


def kv_update_token(
    leaf: Any, new_vals: torch.Tensor, idx: int | torch.Tensor, axis: int
) -> Any:
    """Append one token's values into a cache leaf (raw tensor or QuantKV),
    in place. For a QuantKV the new rows are quantized against their own
    block scales and scattered into codes and scales; history is untouched."""
    if isinstance(leaf, QuantKV):
        qnew = quantize_kv(new_vals, leaf.bits, leaf.alpha)
        seq_update(leaf.codes, qnew.codes, idx, axis)
        seq_update(leaf.scale, qnew.scale, idx, axis)
        return leaf
    return seq_update(leaf, new_vals, idx, axis)


def kv_read(leaf: Any, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dequantize-on-read (identity for raw leaves)."""
    if isinstance(leaf, QuantKV):
        return dequantize_kv(leaf, dtype)
    return leaf


# ------------------------------------------------------------- tree level


def map_cache_tree(tree: Any, fn: Callable[[tuple, Any], Any], path=()) -> Any:
    """Rebuild a dict/list cache tree with ``fn(path, leaf)`` at each leaf
    (a tensor or a QuantKV); ``path`` holds the dict keys and list indices."""
    if isinstance(tree, dict):
        return {k: map_cache_tree(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_cache_tree(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def tree_leaves(tree: Any) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) pairs of a cache tree, leaves being tensors or QuantKV."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            for p, leaf in tree_leaves(v):
                yield (k,) + p, leaf
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            for p, leaf in tree_leaves(v):
                yield (i,) + p, leaf
    else:
        yield (), tree


def quantize_tree(caches: Any, qcfg: CacheQuantConfig) -> Any:
    """Eligible leaves -> QuantKV (identity when ``qcfg.bits == 0``). Stacked
    scan leaves keep their leading repeats dim: blocks are last-dim rows."""
    if qcfg.bits == 0:
        return caches

    def quant(path, x):
        if path and path[-1] in QUANT_CACHE_LEAVES:
            return quantize_kv(x, qcfg.bits, qcfg.alpha)
        return x

    return map_cache_tree(caches, quant)


def tree_is_quantized(caches: Any) -> bool:
    return any(isinstance(leaf, QuantKV) for _, leaf in tree_leaves(caches))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def cache_bytes_per_token(caches: Any, batch: int, max_seq: int) -> float:
    """MEASURED bytes per (request, position): the bytes of every cache
    tensor (codes and scales included) / (batch * max_seq)."""
    total = 0
    for _, leaf in tree_leaves(caches):
        if isinstance(leaf, QuantKV):
            total += _nbytes(leaf.codes) + _nbytes(leaf.scale)
        else:
            total += _nbytes(leaf)
    return total / float(batch * max_seq)


def cache_bytes_per_token_accounting(caches: Any, batch: int, max_seq: int) -> float:
    """ACCOUNTED bytes per token: ``packed_wire_bits`` + a 32-bit scale per
    block for quantized leaves, itemsize for raw ones."""
    total = 0.0
    for _, leaf in tree_leaves(caches):
        if isinstance(leaf, QuantKV):
            blocks = leaf.scale.numel()
            total += blocks * (packed_wire_bits(leaf.d, leaf.bits) + 32) / 8.0
        else:
            total += _nbytes(leaf)
    return total / float(batch * max_seq)


# ------------------------------------------------------------ block pool


class BlockPool:
    """Fixed-size page allocator for KV-cache memory (host-side accounting).

    The cache is carved into ``n_blocks`` pages of ``block_tokens``
    positions; a request holding L tokens owns ceil(L / block_tokens) pages.
    The scheduler admits a request only when its worst-case page count is
    free, so slots are admitted and retired without fragmentation."""

    def __init__(self, n_blocks: int, block_tokens: int):
        if n_blocks < 1 or block_tokens < 1:
            raise ValueError("need n_blocks >= 1 and block_tokens >= 1")
        self.block_tokens = int(block_tokens)
        self._free: list[int] = list(range(int(n_blocks)))
        self._owned: dict[int, list[int]] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    def blocks_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.block_tokens)

    def can_alloc(self, n_tokens: int) -> bool:
        return self.blocks_for(n_tokens) <= self.n_free

    def alloc(self, owner: int, n_tokens: int) -> list[int]:
        """Reserve pages for ``owner`` (a request id); raises when the pool
        cannot hold them, so callers check :meth:`can_alloc` first."""
        n = self.blocks_for(n_tokens)
        if n > len(self._free):
            raise RuntimeError(
                f"pool exhausted: want {n} blocks, {len(self._free)} free"
            )
        pages = [self._free.pop() for _ in range(n)]
        self._owned.setdefault(owner, []).extend(pages)
        return pages

    def release(self, owner: int) -> None:
        self._free.extend(self._owned.pop(owner, []))
