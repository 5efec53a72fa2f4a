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

Over a model axis (``tp``, a ``core.comm.ModelAxis`` over the training
tree's shards) the forward is the tensor-parallel one, and where the head
splits the vocabulary the cross-entropy is vocab-parallel
(:func:`_ce_vocab_parallel`): a rank forms the logits of its vocab columns
only, by ``head_chunk`` chunks as above, and the (B, S, V) logits are never
gathered (gemma3-1b's V is 262,144): the codebook heads' (B, S, cb, V / M)
likewise, their CE averaged over the codebooks as above, and the MTP
block's logits, whose vocab-parallel CE two ahead joins at 0.3 as above.
The value is the whole loss on every model rank.
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


def _ce_vocab_parallel(
    logits: torch.Tensor, targets: torch.Tensor, tp: Any
) -> torch.Tensor:
    """:func:`_ce` of logits whose last dim is this rank's block of the
    vocabulary (rank m holds ids ``m * Vl`` .. ``(m + 1) * Vl - 1``): the
    f32 max of each row over the model axis (exact, no gradient), each
    rank's sum of ``exp(l - max)`` and its target logit (0 where another
    rank owns the target) summed over the axis in one f32 all-reduce
    (identity backward), then ``log(sum) + max - target``. One process's
    ``log_softmax`` computes the same up to the order of the sum."""
    comm = tp.comm
    lg = logits.float()
    vl = lg.shape[-1]
    m = comm.max(lg.amax(-1), "tp.loss.max")
    sumexp = torch.exp(lg - m[..., None]).sum(-1)
    local = targets.long() - comm.rank * vl
    mine = (local >= 0) & (local < vl)
    tgt = lg.gather(-1, local.clamp(0, vl - 1)[..., None])[..., 0]
    tgt = torch.where(mine, tgt, torch.zeros_like(tgt))
    both = comm.all_reduce(torch.stack([sumexp, tgt]), "tp.loss.sum")
    return torch.log(both[0]) + m - both[1]


def _vocab_split(cfg: ModelConfig, tp: Any) -> bool:
    """Does the head (or the tied embedding: its vocab dim, 1 of a (cb, V,
    d) codebook table) split the vocab over ``tp``?"""
    if tp is None or tp.comm.size == 1:
        return False
    if cfg.tie_embeddings:
        return tp.specs["embed"][1 if cfg.n_codebooks else 0] is not None
    return tp.specs["head"][-1] is not None


def _chunked_nll(
    params: Any,
    hidden: torch.Tensor,
    tgt: torch.Tensor,
    cfg: ModelConfig,
    head_chunk: int,
    tp: Any,
) -> torch.Tensor:
    """The per-position CE of ``hidden`` (B, S, d) against ``tgt`` (B, S[,
    cb]), the head applied per sequence chunk of ``head_chunk`` (all of S
    at 0) and each chunk's logits recomputed in the backward, not kept (no
    RNG state is saved: nothing draws, and a CUDA-graph capture refuses
    reads of the generator's state); vocab-parallel over ``tp`` where it
    splits the vocab. With codebooks, the mean over them: (B, S)."""
    vocab_split = _vocab_split(cfg, tp)
    key = "embed" if cfg.tie_embeddings else "head"

    def chunk_nll(h: torch.Tensor, t: torch.Tensor, w: torch.Tensor):
        if vocab_split:
            return _ce_vocab_parallel(
                apply_head({key: w}, h, cfg, tp, gather=False), t, tp
            )
        return _ce(apply_head({key: w}, h, cfg), t)

    size = head_chunk or hidden.shape[1]
    chunks = zip(hidden.split(size, 1), tgt.split(size, 1))
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
    return nll.mean(dim=-1) if cfg.n_codebooks else nll


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
    tp: Any = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """batch: {"tokens": (B, S) or (B, S, cb) integer ids, optionally
    "cond": (B, L, d)}. Returns (scalar loss, {"ce", "loss"} and, with
    experts, "moe_aux", with an MTP head, "mtp_ce"), the loss of the
    training or the serving tree; with ``tp`` this rank's part of the
    tensor-parallel loss (its value is the whole loss on every model
    rank)."""
    tokens, cond = batch["tokens"], batch.get("cond")
    tgt = torch.roll(tokens, -1, dims=1)
    tgt2 = torch.roll(tokens, -2, dims=1)  # the MTP head's targets
    mtp_nll = None
    vocab_split = _vocab_split(cfg, tp)
    if vocab_split or (head_chunk and not cfg.mtp and not cfg.n_codebooks):
        hidden, _, aux = forward(
            params,
            tokens,
            cfg,
            cond=cond,
            return_hidden=True,
            plain_attention=True,
            remat=remat,
            return_aux=True,
            tp=tp,
        )
        nll = _chunked_nll(params, hidden, tgt, cfg, head_chunk, tp)
        if "mtp_hidden" in aux:
            mtp_nll = _chunked_nll(params, aux["mtp_hidden"], tgt2, cfg, head_chunk, tp)
    else:
        logits, _, aux = forward(
            params,
            tokens,
            cfg,
            cond=cond,
            plain_attention=True,
            remat=remat,
            return_aux=True,
            tp=tp,
        )
        nll = _ce(logits, tgt)
        if cfg.n_codebooks:
            nll = nll.mean(dim=-1)
        if "mtp_logits" in aux:
            mtp_nll = _ce(aux["mtp_logits"], tgt2)
    ce = _masked_mean(nll)
    metrics = {"ce": ce}
    loss = ce
    if mtp_nll is not None:
        mtp = _masked_mean(mtp_nll, 2)
        loss = loss + 0.3 * mtp
        metrics["mtp_ce"] = mtp
    if cfg.n_experts:
        loss = loss + cfg.router_aux_coef * aux["moe_aux"]
        metrics["moe_aux"] = aux["moe_aux"]
    metrics["loss"] = loss
    return loss, metrics
