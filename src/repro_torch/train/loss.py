"""Causal-LM loss: next-token cross-entropy, the log-softmax in f32.

The JAX package's ``train/loss.py``: the target of position t is token
t + 1 (a roll by one), the last position is masked, and the loss is
``sum(nll * mask) / (sum(mask) * B)``, plus ``router_aux_coef`` times the
MoE layers' load-balance loss where the model has experts. ``head_chunk``
applies the head (tied or untied) per sequence chunk and recomputes each
chunk's logits in the backward, so the (B, S, V) logits of a 262k
vocabulary never exist at once; the value is the same. ``remat``
recomputes each repeat of the scanned layer pattern in the backward
(``models.model.forward``), as the JAX step's ``remat_scan`` does. The
forward takes the plain attention (and the plain SSD) on any device, as
the JAX training step does (``backend="xla"``).

With codebooks the per-position CE is the mean over the codebooks. With an
MTP head the loss adds 0.3 x the CE against token t + 2 (a roll by two,
the last two positions masked), reported as ``mtp_ce``. A batch's ``cond``
(B, L, d) is the conditioning prefix. The chunked-head path is taken only
without MTP and codebooks, as in the JAX package.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import apply_head, forward

__all__ = ["lm_loss"]


def _ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[..., None].long())[..., 0]


def _masked_mean(nll: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """The mean over the positions whose target ``shift`` ahead exists."""
    b, s = nll.shape
    mask = (torch.arange(s, device=nll.device) < s - shift).float()[None, :]
    return torch.sum(nll * mask) / (torch.sum(mask) * b)


def lm_loss(
    params: Any,
    batch: dict[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    head_chunk: int = 0,
    remat: bool = False,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """batch: {"tokens": (B, S) or (B, S, cb) integer ids, optionally
    "cond": (B, L, d)}. Returns (scalar loss, {"ce", "loss"} and, with
    experts, "moe_aux", with an MTP head, "mtp_ce"), the loss of the
    training or the serving tree."""
    tokens, cond = batch["tokens"], batch.get("cond")
    tgt = torch.roll(tokens, -1, dims=1)
    if head_chunk and not cfg.mtp and not cfg.n_codebooks:
        hidden, _, aux = forward(
            params,
            tokens,
            cfg,
            cond=cond,
            return_hidden=True,
            plain_attention=True,
            remat=remat,
            return_aux=True,
        )
        key = "embed" if cfg.tie_embeddings else "head"

        def chunk_nll(h: torch.Tensor, t: torch.Tensor, w: torch.Tensor):
            return _ce(apply_head({key: w}, h, cfg), t)

        # each chunk's logits are recomputed in the backward, not kept; no
        # RNG state is saved (nothing draws, and a CUDA-graph capture
        # refuses reads of the generator's state)
        chunks = zip(hidden.split(head_chunk, 1), tgt.split(head_chunk, 1))
        nll = torch.cat(
            [
                checkpoint(
                    chunk_nll,
                    h,
                    t,
                    params[key],
                    use_reentrant=False,
                    preserve_rng_state=False,
                )
                for h, t in chunks
            ],
            dim=1,
        )
    else:
        logits, _, aux = forward(
            params,
            tokens,
            cfg,
            cond=cond,
            plain_attention=True,
            remat=remat,
            return_aux=True,
        )
        nll = _ce(logits, tgt)
        if cfg.n_codebooks:
            nll = nll.mean(dim=-1)
    ce = _masked_mean(nll)
    metrics = {"ce": ce}
    loss = ce
    if "mtp_logits" in aux:
        mtp = _masked_mean(_ce(aux["mtp_logits"], torch.roll(tokens, -2, dims=1)), 2)
        loss = loss + 0.3 * mtp
        metrics["mtp_ce"] = mtp
    if cfg.n_experts:
        loss = loss + cfg.router_aux_coef * aux["moe_aux"]
        metrics["moe_aux"] = aux["moe_aux"]
    metrics["loss"] = loss
    return loss, metrics
