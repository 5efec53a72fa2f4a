"""Reconstruction-quality metrics, the privacy leakage scores, in plain torch.

SSIM: the standard Wang et al. 2004 formulation: an 11x11 Gaussian window
of sigma 1.5, K1 = 0.01, K2 = 0.03, averaged over channels and batch.
PSNR: peak signal-to-noise over the target's dynamic range. Images are
(B, H, W, C), as in the JAX package's API; the filter runs on NCHW as a
depthwise ``conv2d`` (``groups=C``, VALID). Inputs are range-normalized
together (reconstructions are unconstrained).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ssim", "psnr"]


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    g = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (g / sigma) ** 2)
    k = torch.outer(g, g)
    return k / torch.sum(k)


def _filter(x: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """Depthwise 2-D VALID filter over (B, H, W, C) -> (B, C, H', W')."""
    c = x.shape[-1]
    w = kern[None, None].expand(c, 1, *kern.shape)
    return F.conv2d(x.permute(0, 3, 1, 2), w, groups=c)


def ssim(
    a: torch.Tensor, b: torch.Tensor, *, window: int = 11, sigma: float = 1.5
) -> torch.Tensor:
    """a, b: (B, H, W, C) -> scalar mean SSIM in [-1, 1]."""
    a, b = a.float(), b.float()
    lo = torch.minimum(a.min(), b.min())
    hi = torch.maximum(a.max(), b.max())
    rng = torch.clamp(hi - lo, min=1e-6)
    a = (a - lo) / rng
    b = (b - lo) / rng

    k = _gaussian_kernel(window, sigma, a.device)
    c1, c2 = 0.01**2, 0.03**2
    mu_a, mu_b = _filter(a, k), _filter(b, k)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    s_aa = _filter(a * a, k) - mu_aa
    s_bb = _filter(b * b, k) - mu_bb
    s_ab = _filter(a * b, k) - mu_ab
    num = (2 * mu_ab + c1) * (2 * s_ab + c2)
    den = (mu_aa + mu_bb + c1) * (s_aa + s_bb + c2)
    return torch.mean(num / den)


def psnr(target: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB, with the peak taken as the TARGET's
    dynamic range (the reconstruction is unconstrained, so its range would
    reward wild over-shoots). Higher = more leakage."""
    a, b = target.float(), recon.float()
    peak = torch.clamp(a.max() - a.min(), min=1e-6)
    mse = torch.mean((a - b) ** 2)
    return 10.0 * torch.log10(peak * peak / torch.clamp(mse, min=1e-12))
