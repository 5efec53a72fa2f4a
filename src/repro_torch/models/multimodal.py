"""Modality-frontend stubs (the JAX package's ``models/multimodal.py``).

Chameleon (early-fusion VLM): the VQ image tokenizer maps image patches to
ids inside the unified vocabulary; the stub emits mixed image and text ids
directly, and the backbone is a plain LM over them.

MusicGen (audio): the EnCodec codec and the T5 text conditioner are
stubbed; the stubs emit the (B, S, n_codebooks) token grid (the delay
pattern applied upstream) and the (B, cond_len, d_model) conditioning
embeddings the decoder consumes. The draws come from ``torch.Generator`` s,
the port's own streams: a run held to the JAX package feeds it that
package's arrays.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import DTYPES

__all__ = ["vq_tokens_stub", "codec_tokens_stub", "conditioning_stub"]


def vq_tokens_stub(
    gen: torch.Generator,
    batch: int,
    seq: int,
    cfg: ModelConfig,
    image_frac: float = 0.25,
) -> torch.Tensor:
    """Mixed image and text ids (B, S), int64 on ``gen``'s device: the
    first ``image_frac`` of each row are 'image' ids, in the top half of
    the vocabulary, where Chameleon's VQ codes live; the rest text ids, in
    the bottom half."""
    n_img = int(seq * image_frac)
    v = cfg.vocab_size
    dev = gen.device
    img = torch.randint(v // 2, v, (batch, n_img), generator=gen, device=dev)
    txt = torch.randint(0, v // 2, (batch, seq - n_img), generator=gen, device=dev)
    return torch.cat([img, txt], dim=1)


def codec_tokens_stub(
    gen: torch.Generator, batch: int, seq: int, cfg: ModelConfig
) -> torch.Tensor:
    """(B, S, n_codebooks) EnCodec-style token grid, int64 on ``gen``'s
    device, uniform over the codebook vocabulary."""
    shape = (batch, seq, cfg.n_codebooks)
    return torch.randint(0, cfg.vocab_size, shape, generator=gen, device=gen.device)


def conditioning_stub(
    gen: torch.Generator, batch: int, cfg: ModelConfig
) -> torch.Tensor:
    """(B, cond_len, d_model) text-conditioning embeddings (a stub T5):
    N(0, 0.02^2) in ``cfg.dtype`` on ``gen``'s device."""
    shape = (batch, cfg.cond_len, cfg.d_model)
    draw = torch.randn(shape, generator=gen, device=gen.device) * 0.02
    return draw.to(DTYPES[cfg.dtype])
