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
forward takes the plain attention on any device, as the JAX training step
does (``backend="xla"``). The MTP term and multi-codebook targets come with
those models (ROADMAP Queue 1, item 14).
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


def _check_ported(cfg: ModelConfig, batch: dict[str, Any]) -> None:
    if cfg.mtp or cfg.n_codebooks or "cond" in batch:
        raise NotImplementedError(
            f"{cfg.name}: the MTP, multi-codebook and conditioned losses "
            "are not ported yet: ROADMAP Queue 1, item 14"
        )


def _masked_mean(nll: torch.Tensor) -> torch.Tensor:
    b, s = nll.shape
    mask = (torch.arange(s, device=nll.device) < s - 1).float()[None, :]
    return torch.sum(nll * mask) / (torch.sum(mask) * b)


def lm_loss(
    params: Any,
    batch: dict[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    head_chunk: int = 0,
    remat: bool = False,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """batch: {"tokens": (B, S) integer ids}. Returns (scalar loss,
    {"ce", "loss"} and, with experts, "moe_aux"), the loss of the training
    or the serving tree."""
    _check_ported(cfg, batch)
    tokens = batch["tokens"]
    tgt = torch.roll(tokens, -1, dims=1)
    if head_chunk:
        hidden, _, aux = forward(
            params,
            tokens,
            cfg,
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
            params, tokens, cfg, plain_attention=True, remat=remat, return_aux=True
        )
        nll = _ce(logits, tgt)
    ce = _masked_mean(nll)
    metrics = {"ce": ce}
    loss = ce
    if cfg.n_experts:
        loss = loss + cfg.router_aux_coef * aux["moe_aux"]
        metrics["moe_aux"] = aux["moe_aux"]
    metrics["loss"] = loss
    return loss, metrics
