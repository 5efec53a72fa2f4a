"""Continuous batching: paged admission + slot reuse over a fixed decode grid.

The decode step is shape-static, (slots, 1) tokens against (slots, ...,
max_seq, ...) caches, so "continuous" batching means the scheduler keeps
that grid full: requests enter free slots as soon as capacity exists, each
slot carries its own length (the per-request ``index`` vector masks
attention and places cache writes), and finished requests retire at once so
their slot and pages return to the pool.

Phases per :meth:`ContinuousScheduler.step`, as in the JAX package:

  1. **admit**: while a slot is free and the :class:`BlockPool` holds the
     request's worst case (``len(prompt) + max_new`` tokens), prefill the
     prompt alone (batch 1, right-padded to a power-of-two bucket, full
     logits so position L-1 is read whatever the padding) and copy its
     caches into the slot.
  2. **decode**: one chunk of ``decode_chunk`` tokens advances every active
     slot; idle slots compute masked garbage, the price of the static grid.
  3. **retire**: harvest sampled tokens, finish requests at ``max_new``,
     release their pages.

Right-padded prefill is pad-safe for attention stacks only: pad rows land
beyond the causal mask and decode overwrites them before they enter it.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.serving.engine import (
    build_generate_fn,
    build_prefill_step,
    init_serving_caches,
    temperature_sample,
)
from repro_torch.serving.kv_cache import (
    BlockPool,
    CacheQuantConfig,
    QuantKV,
    tree_leaves,
)

__all__ = ["Request", "ContinuousScheduler"]

BLOCK_TOKENS = 16  # cache positions per BlockPool page


@dataclasses.dataclass
class Request:
    """One generation request (host-side bookkeeping)."""

    uid: int
    prompt: np.ndarray  # (L,) integer token ids
    max_new: int
    out: list[int] = dataclasses.field(default_factory=list)
    slot: int = -1

    @property
    def done(self) -> bool:
        return self.slot == -2


def _bucket(n: int, cap: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return min(b, cap)


class ContinuousScheduler:
    """Admit/decode/retire loop over a fixed slot grid (see module doc)."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        *,
        slots: int,
        max_seq: int,
        cache_dtype: torch.dtype = torch.bfloat16,
        qcfg: CacheQuantConfig | None = None,
        temperature: float = 0.0,
        decode_chunk: int = 8,
        device: torch.device | str = "cuda",
    ):
        if any(s.kind == "mamba" for s in cfg.layers):
            raise ValueError(
                "continuous scheduler requires attention-only stacks "
                "(SSM rolling state is not pad-safe)"
            )
        if cfg.cond_len or cfg.n_codebooks:
            raise ValueError(
                "conditioned / multi-codebook configs are not supported by "
                "the continuous scheduler"
            )
        self.cfg, self.params = cfg, params
        self.device = torch.device(device)
        self.slots, self.max_seq = slots, max_seq
        self.temperature = temperature
        self.decode_chunk = decode_chunk
        # pages for every slot's full max_seq: the JAX package's default pool
        self.pool = BlockPool(slots * (-(-max_seq // BLOCK_TOKENS)), BLOCK_TOKENS)
        self.caches = init_serving_caches(
            cfg, slots, max_seq, cache_dtype, qcfg, self.device
        )
        # Full logits of a padded bucket: at gemma3-1b's vocab of 262144 and a
        # 1024 bucket that is 0.5 GB in bf16 per admission, which the card holds.
        self._prefill = build_prefill_step(
            cfg, max_seq, cache_dtype=cache_dtype, qcfg=qcfg, full_logits=True
        )
        self._generate = build_generate_fn(cfg, temperature=temperature)
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        self.lengths = np.zeros(slots, np.int64)  # per-slot next write position
        self.cur = np.zeros(slots, np.int64)  # per-slot pending token
        self.active: dict[int, Request] = {}
        self.waiting: deque[Request] = deque()
        self.steps = 0

    # ------------------------------------------------------------- plumbing
    def _insert(self, one_caches: Any, slot: int) -> None:
        """Copy a batch-1 cache tree into slot ``slot`` of the serving grid,
        in place. Scan leaves carry a leading repeats dim (batch axis 1)."""
        for (path, dst), (_, src) in zip(
            tree_leaves(self.caches), tree_leaves(one_caches)
        ):
            ax = 1 if path[0] == "scan" else 0
            if isinstance(dst, QuantKV):
                pairs = ((dst.codes, src.codes), (dst.scale, src.scale))
            else:
                pairs = ((dst, src),)
            for d, s in pairs:
                d.narrow(ax, slot, 1).copy_(s)

    # -------------------------------------------------------------- control
    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new > self.max_seq:
            raise ValueError(
                f"request {req.uid}: prompt+max_new "
                f"{len(req.prompt) + req.max_new} > max_seq {self.max_seq}"
            )
        self.waiting.append(req)

    def _admit(self) -> None:
        free = [s for s in range(self.slots) if s not in self.active]
        while self.waiting and free:
            req = self.waiting[0]
            need = len(req.prompt) + req.max_new
            if not self.pool.can_alloc(need):
                break  # head-of-line blocks on pages
            self.waiting.popleft()
            slot = free.pop(0)
            self.pool.alloc(req.uid, need)
            ln = len(req.prompt)
            toks = torch.zeros((1, _bucket(ln, self.max_seq)), dtype=torch.long)
            toks[0, :ln] = torch.as_tensor(req.prompt, dtype=torch.long)
            logits, one = self._prefill(self.params, toks.to(self.device))
            first = temperature_sample(
                self._gen, logits[:, ln - 1, :], self.temperature
            )
            self._insert(one, slot)
            req.slot = slot
            req.out.append(int(first[0]))
            self.lengths[slot] = ln
            self.cur[slot] = req.out[-1]
            self.active[slot] = req
            if len(req.out) >= req.max_new:  # max_new == 1
                self._retire(slot)

    def _retire(self, slot: int) -> None:
        req = self.active.pop(slot)
        self.pool.release(req.uid)
        req.slot = -2

    def step(self) -> int:
        """One admit -> decode-chunk -> retire cycle; returns the number of
        tokens harvested (0 when idle)."""
        self._admit()
        if not self.active:
            return 0
        self.caches, _, _, sampled = self._generate(
            self.params,
            self.caches,
            torch.as_tensor(self.cur[:, None], device=self.device),
            torch.as_tensor(self.lengths, device=self.device),
            self._gen,
            self.decode_chunk,
        )
        self.steps += 1
        sampled = sampled.cpu().numpy()
        harvested = 0
        for slot in list(self.active):
            req = self.active[slot]
            take = min(self.decode_chunk, req.max_new - len(req.out))
            req.out.extend(sampled[slot, :take].tolist())
            harvested += take
            self.lengths[slot] += take
            self.cur[slot] = req.out[-1]
            if len(req.out) >= req.max_new:
                self._retire(slot)
        return harvested

    def run(
        self, requests: list[Request] | None = None, max_steps: int = 100_000
    ) -> dict[int, list[int]]:
        """Drive until every submitted request completes."""
        for r in requests or []:
            self.submit(r)
        for _ in range(max_steps):
            if not self.waiting and not self.active:
                break
            self.step()
        else:
            raise RuntimeError("scheduler did not drain within max_steps")
        return {r.uid: r.out for r in requests or []}
