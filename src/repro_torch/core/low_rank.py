"""Low-rank power-iteration machinery shared by PowerSGD and LQ-SGD.

The single warm-started power-iteration step of PowerSGD (Vogels et al.,
2019) that the paper's Algorithm 1 reuses:

    P = G' Q ;  P <- orthonormalize(P) ;  Q = G'^T P ;  G_hat = P Q^T

Tensors of ndim != 2 are matricized: conv kernels (kh, kw, cin, cout) ->
(kh*kw*cin, cout), so the parameters (and gradients) keep the JAX package's
HWIO layout. Every function takes leading batch dims (workers, stacked
layers) before the matrix dims, which is what ``vmap`` gave the reference.
"""

from __future__ import annotations

import torch

__all__ = [
    "orthonormalize",
    "matricize_shape",
    "power_iter_p",
    "power_iter_q",
    "reconstruct",
]


def orthonormalize(p: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Modified Gram-Schmidt over the columns of ``p`` (..., n, r), column by
    column, each divided by ``norm + eps``, as the PowerSGD reference does."""
    cols: list[torch.Tensor] = []
    for i in range(p.shape[-1]):
        col = p[..., i]
        for prev in cols:
            col = col - (prev * col).sum(-1, keepdim=True) * prev
        col = col / (torch.linalg.vector_norm(col, dim=-1, keepdim=True) + eps)
        cols.append(col)
    return torch.stack(cols, dim=-1)


def matricize_shape(shape: tuple[int, ...]) -> tuple[int, int]:
    """2-D view used for compression: collapse all but the last dim."""
    if len(shape) < 2:
        raise ValueError(f"cannot matricize {shape}")
    n = 1
    for s in shape[:-1]:
        n *= s
    return (n, shape[-1])


def power_iter_p(g2d: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """P = G' Q (before orthonormalization / all-reduce), for each worker:
    ``g2d`` (k, ..., n, m) and ``q`` (k, ..., m, r) carry the workers first.
    Each worker's product is taken on its own, so its bits do not depend on
    how many workers share the call (a product batched over k workers may
    round otherwise, and a rank of a process group holds fewer of them than
    one process simulating all)."""
    return torch.stack([g @ qw for g, qw in zip(g2d, q)])


def power_iter_q(g2d: torch.Tensor, p_hat: torch.Tensor) -> torch.Tensor:
    """Q = G'^T P_hat for each worker of ``g2d`` (k, ..., n, m), P_hat the
    same for all of them; one product a worker, as in :func:`power_iter_p`."""
    return torch.stack([g.transpose(-1, -2) @ p_hat for g in g2d])


def reconstruct(p_hat: torch.Tensor, q_hat: torch.Tensor) -> torch.Tensor:
    """G_hat = P Q^T."""
    return p_hat @ q_hat.transpose(-1, -2)
