"""Modality-frontend stubs (the JAX package's ``models/multimodal.py``).

Chameleon (early-fusion VLM): the VQ image tokenizer maps image patches to
ids inside the unified vocabulary; the stub emits mixed image and text ids
directly, and the backbone is a plain LM over them. The EnCodec codec and
text-conditioning stubs come with musicgen (ROADMAP Queue 1, item 14).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["vq_tokens_stub"]


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
