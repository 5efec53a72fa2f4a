"""Low-rank power-iteration machinery shared by PowerSGD and LQ-SGD.

The single warm-started power-iteration step of PowerSGD (Vogels et al.,
2019) that the paper's Algorithm 1 reuses:

    P = G' Q ;  P <- orthonormalize(P) ;  Q = G'^T P ;  G_hat = P Q^T

Tensors of ndim != 2 are matricized: conv kernels (kh, kw, cin, cout) ->
(kh*kw*cin, cout), so the parameters (and gradients) keep the JAX package's
HWIO layout. Every function takes leading batch dims (workers, stacked
layers) before the matrix dims, which is what ``vmap`` gave the reference.

Over a model axis a rank may hold a block of P's rows (a gradient split by
rows): :func:`orthonormalize_split` runs the same Gram-Schmidt with every
dot product and norm summed over the axis.
"""

from __future__ import annotations

import torch

__all__ = [
    "orthonormalize",
    "orthonormalize_split",
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


def orthonormalize_split(
    ps: list[torch.Tensor], comm, eps: float = 1e-8
) -> list[torch.Tensor]:
    """:func:`orthonormalize` of P's whose rows are split over ``comm`` (a
    ``ModelComm``): each holds this rank's rows (..., n / M, r). The same
    column order and updates; every column's dot product with an earlier
    column and its squared norm is this rank's partial sum, summed over the
    group in f32, the partials of all ``ps`` in one all-reduce per step
    (r (r + 1) / 2 steps for rank r)."""
    cols: list[list[torch.Tensor]] = [[] for _ in ps]
    for i in range(max(p.shape[-1] for p in ps)):
        live = [j for j, p in enumerate(ps) if p.shape[-1] > i]
        cur = {j: ps[j][..., i] for j in live}
        for k in range(i):
            parts = [(cols[j][k] * cur[j]).sum(-1, keepdim=True) for j in live]
            dots = _sum_parts(parts, comm, "tp.orth.dot")
            for j, dot in zip(live, dots):
                cur[j] = cur[j] - dot * cols[j][k]
        parts = [(cur[j] * cur[j]).sum(-1, keepdim=True) for j in live]
        sq = _sum_parts(parts, comm, "tp.orth.norm")
        for j, n2 in zip(live, sq):
            cols[j].append(cur[j] / (torch.sqrt(n2) + eps))
    return [torch.stack(c, dim=-1) for c in cols]


def _sum_parts(parts: list[torch.Tensor], comm, tag: str) -> list[torch.Tensor]:
    """Each of ``parts`` summed over ``comm``, in one f32 all-reduce."""
    flat = comm.all_reduce(torch.cat([p.reshape(-1) for p in parts]), tag)
    sums = flat.split([p.numel() for p in parts])
    return [x.reshape(p.shape) for x, p in zip(sums, parts)]


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
