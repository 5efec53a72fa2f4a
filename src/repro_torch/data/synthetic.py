"""Deterministic synthetic data: LM tokens and CIFAR-shaped images.

LM tokens (``LMDataConfig`` / ``lm_batch``) are the JAX package's noisy
periodic copy process over a zipf unigram base, in numpy and step for step
the same draws: a run of the port and of the JAX package see the same
tokens. numpy by design: the async runtime's prefetch thread builds them
while the device runs the step.

Synthetic CIFAR-shaped images: the JAX package's ``ImageDataConfig`` /
``image_batch`` distribution, drawn on the device from a seed.

K fixed class templates (standard normal images) plus Gaussian noise: a
learnable stand-in for CIFAR-10/100/MNIST in the paper's tables. The draws
come from ``torch.Generator`` s, so they are the port's own and cannot
reproduce ``jax.random``; a run held to the JAX package feeds it that
package's arrays. Federated label skew: with ``noniid_alpha > 0`` a
client's labels come from its own Dirichlet row over the classes
(:func:`client_label_probs`, numpy, the JAX package's exactly).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "LMDataConfig",
    "lm_batch",
    "cond_batch",
    "ImageDataConfig",
    "class_templates",
    "client_label_probs",
    "image_batch",
]


def client_label_probs(
    n_classes: int, n_clients: int, alpha: float, seed: int = 0
) -> np.ndarray:
    """Per-client class distributions for federated non-IID sampling: one
    Dirichlet(alpha) draw a client over the class simplex (small alpha:
    each client sees a few classes). Deterministic in ``seed``."""
    if alpha <= 0:
        raise ValueError(f"noniid alpha must be > 0, got {alpha}")
    rng = np.random.default_rng(np.random.SeedSequence([seed, 9917]))
    return rng.dirichlet(np.full(n_classes, alpha), size=n_clients)


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab_size: int
    seq_len: int
    batch: int
    period: int = 16  # copy period (the learnable structure)
    noise: float = 0.15  # fraction of corrupted positions
    n_codebooks: int = 0
    seed: int = 0
    # federated non-IID: Dirichlet concentration reshaping each client's
    # unigram prior (0 = IID, every client samples the shared zipf base)
    noniid_alpha: float = 0.0


def lm_batch(
    cfg: LMDataConfig, step: int, *, client: int | None = None
) -> dict[str, np.ndarray]:
    """The batch of ``step``: {"tokens": (batch, seq_len) int32, or (batch,
    seq_len, n_codebooks) with codebooks}, the same for every call
    (restart-safe data order). ``client`` with ``cfg.noniid_alpha > 0``
    draws that federated client's shard: its unigram prior is a
    Dirichlet(alpha * zipf) reshaping of the shared base, fixed per client
    over the run."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    shape = (cfg.batch, cfg.seq_len) + cb
    ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
    p = ranks**-1.1
    if client is not None and cfg.noniid_alpha > 0:
        crng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 9917, client]))
        p = crng.dirichlet(cfg.noniid_alpha * cfg.vocab_size * p / p.sum())
        p = np.maximum(p, 1e-12)
    base = rng.choice(cfg.vocab_size, size=(cfg.batch, cfg.period) + cb, p=p / p.sum())
    reps = -(-cfg.seq_len // cfg.period)
    tok = np.tile(base, (1, reps) + (1,) * len(cb))[:, : cfg.seq_len]
    corrupt = rng.random(shape) < cfg.noise
    rand_tok = rng.integers(0, cfg.vocab_size, shape)
    return {"tokens": np.where(corrupt, rand_tok, tok).astype(np.int32)}


def cond_batch(cfg: LMDataConfig, step: int, cond_len: int, d_model: int) -> np.ndarray:
    """The conditioning prefix of ``step``'s batch, (batch, cond_len,
    d_model) f32 ~ N(0, 0.02^2): the JAX launcher's numpy draw, which that
    launcher then casts to the model's dtype (the forward casts here)."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, 1]))
    draw = rng.standard_normal((cfg.batch, cond_len, d_model)) * 0.02
    return draw.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class ImageDataConfig:
    n_classes: int = 10
    hw: int = 32
    channels: int = 3
    batch: int = 128
    noise: float = 0.35
    seed: int = 0
    # federated non-IID: Dirichlet label skew across clients (0 = IID)
    noniid_alpha: float = 0.0
    n_clients: int = 0


def _generator(device: torch.device, *ints: int) -> torch.Generator:
    mixed = np.random.SeedSequence(list(ints)).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(mixed[0]) >> 1)


def class_templates(cfg: ImageDataConfig, device="cuda") -> torch.Tensor:
    """Fixed per-class mean images (n_classes, hw, hw, channels): the signal."""
    dev = torch.device(device)
    shape = (cfg.n_classes, cfg.hw, cfg.hw, cfg.channels)
    return torch.randn(shape, generator=_generator(dev, cfg.seed, 1000), device=dev)


def image_batch(
    cfg: ImageDataConfig, step: int, device="cuda", *, client: int | None = None
) -> dict[str, torch.Tensor]:
    """One batch for ``step``, the same for every call with the same config:
    images (batch, hw, hw, channels) f32, labels (batch,) int64. With
    ``client`` the batch is that client's own draw, and with
    ``cfg.noniid_alpha > 0`` its labels follow the client's Dirichlet row
    (inverse-CDF sampling on the device)."""
    dev = torch.device(device)
    ints = (cfg.seed, step) if client is None else (cfg.seed, step, client)
    gen = _generator(dev, *ints)
    if client is not None and cfg.noniid_alpha > 0:
        n_clients = max(cfg.n_clients, client + 1)
        probs = client_label_probs(
            cfg.n_classes, n_clients, cfg.noniid_alpha, cfg.seed
        )[client]
        cdf = torch.as_tensor(np.cumsum(probs), device=dev)
        u = torch.rand(cfg.batch, generator=gen, device=dev, dtype=torch.float64)
        labels = torch.searchsorted(cdf, u, right=True).clamp_(max=cfg.n_classes - 1)
    else:
        labels = torch.randint(
            0, cfg.n_classes, (cfg.batch,), generator=gen, device=dev
        )
    mu = class_templates(cfg, dev)[labels]
    noise = torch.randn(mu.shape, generator=gen, device=dev)
    return {"images": mu + cfg.noise * noise, "labels": labels}
