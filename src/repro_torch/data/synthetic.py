"""Synthetic CIFAR-shaped images: the JAX package's ``ImageDataConfig`` /
``image_batch`` distribution, drawn on the device from a seed.

K fixed class templates (standard normal images) plus Gaussian noise: a
learnable stand-in for CIFAR-10/100/MNIST in the paper's tables. The draws
come from ``torch.Generator`` s, so they are the port's own and cannot
reproduce ``jax.random``; a run held to the JAX package feeds it that
package's arrays. The federated label skew of the JAX package is not
ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["ImageDataConfig", "class_templates", "image_batch"]


@dataclasses.dataclass(frozen=True)
class ImageDataConfig:
    n_classes: int = 10
    hw: int = 32
    channels: int = 3
    batch: int = 128
    noise: float = 0.35
    seed: int = 0


def _generator(device: torch.device, *ints: int) -> torch.Generator:
    mixed = np.random.SeedSequence(list(ints)).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(mixed[0]) >> 1)


def class_templates(cfg: ImageDataConfig, device="cuda") -> torch.Tensor:
    """Fixed per-class mean images (n_classes, hw, hw, channels): the signal."""
    dev = torch.device(device)
    shape = (cfg.n_classes, cfg.hw, cfg.hw, cfg.channels)
    return torch.randn(shape, generator=_generator(dev, cfg.seed, 1000), device=dev)


def image_batch(
    cfg: ImageDataConfig, step: int, device="cuda"
) -> dict[str, torch.Tensor]:
    """One batch for ``step``, the same for every call with the same config:
    images (batch, hw, hw, channels) f32, labels (batch,) int64."""
    dev = torch.device(device)
    gen = _generator(dev, cfg.seed, step)
    labels = torch.randint(0, cfg.n_classes, (cfg.batch,), generator=gen, device=dev)
    mu = class_templates(cfg, dev)[labels]
    noise = torch.randn(mu.shape, generator=gen, device=dev)
    return {"images": mu + cfg.noise * noise, "labels": labels}
