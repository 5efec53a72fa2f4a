"""Mamba-2's intra-chunk SSD term on Hopper: the wrapper of ``csrc/ssd_chunk.cu``.

Replaces ``src/repro/kernels/ssd_chunk.py::ssd_chunk_pallas``. The kernel
forms C B^T once for a slab of a group's heads, which then walk it, and sums
by f32 FMA in its plain version's order, so the two agree bit for bit; see
the note at the top of the source. It reads every operand through its
element strides, so permuted views go in without a copy, and B/C per group.
Its plain version is ``repro_torch.kernels.ref.ssd_chunk_ref``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, launches

__all__ = ["ssd_chunk_cuda", "head_slab", "MAX_Q", "MAX_N", "MAX_P"]

# what one block holds (csrc/ssd_chunk.cu: kMaxQ, kMaxN, kMaxP)
MAX_Q, MAX_N, MAX_P = 256, 256, 64
_TILE = 64  # rows of an i tile (kTile)
_BLOCKS_PER_SM = 2  # the shared memory of a block at Q = 256 fits two an SM


@functools.cache
def _fn():
    lib = build.load_library("ssd_chunk")
    fn = lib.ssd_chunk_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
    fn.argtypes += [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def head_slab(b: int, h: int, g: int, nc: int, q: int, sms: int) -> int:
    """Heads of a group one block walks: the largest of H/G, ceil(H/G / 2),
    ceil(H/G / 4), ... whose grid still gives each of ``sms`` SMs two
    blocks (or 1). Each block forms C B^T once for its slab, so a wider slab
    shares it more; a narrower one fills the card."""
    rep = h // g
    base = -(-q // _TILE) * nc * b * g
    slab = rep
    while slab > 1 and base * -(-rep // slab) < _BLOCKS_PER_SM * sms:
        slab = -(-slab // 2)
    return slab


def ssd_chunk_cuda(
    x: torch.Tensor,
    a_cum: torch.Tensor,
    bm: torch.Tensor,
    cm: torch.Tensor,
    *,
    slab: int | None = None,
) -> torch.Tensor:
    """x (B, H, NC, Q, P), a_cum (B, H, NC, Q), bm/cm (B, G, NC, Q, N), all
    float32 CUDA tensors of any strides, H % G == 0 (head h reads group
    h // (H // G)) -> Y_diag (B, H, NC, Q, P) float32, contiguous. ``slab``:
    heads a block walks (default :func:`head_slab` for this card)."""
    operands = (("x", x, 5), ("a_cum", a_cum, 4), ("bm", bm, 5), ("cm", cm, 5))
    for name, t, rank in operands:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: want float32, got {t.dtype}")
        if t.dim() != rank:
            raise ValueError(f"{name} must be {rank}-D, got {tuple(t.shape)}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    b, h, nc, q, p = x.shape
    g, n = bm.shape[1], bm.shape[-1]
    if (
        tuple(a_cum.shape) != (b, h, nc, q)
        or tuple(bm.shape) != (b, g, nc, q, n)
        or cm.shape != bm.shape
        or h % g
    ):
        raise ValueError(
            f"bad shapes x {tuple(x.shape)} a_cum {tuple(a_cum.shape)} "
            f"bm {tuple(bm.shape)} cm {tuple(cm.shape)}"
        )
    if not (q <= MAX_Q and n <= MAX_N and p <= MAX_P):
        raise ValueError(f"Q {q}, N {n}, P {p} over {MAX_Q}, {MAX_N}, {MAX_P}")
    out = torch.empty((b, h, nc, q, p), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    if slab is None:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        slab = head_slab(b, h, g, nc, q, sms)
    if not 1 <= slab <= h // g:
        raise ValueError(f"slab {slab} not in [1, {h // g}]")
    strides = (ctypes.c_longlong * 19)(
        *x.stride(), *a_cum.stride(), *bm.stride(), *cm.stride()
    )
    err = _fn()(
        x.data_ptr(),
        a_cum.data_ptr(),
        bm.data_ptr(),
        cm.data_ptr(),
        out.data_ptr(),
        b,
        h,
        g,
        nc,
        q,
        p,
        n,
        slab,
        strides,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"ssd_chunk launch failed: CUDA error {err}")
    launches.count(ssd_chunk_cuda)
    return out


ssd_chunk_cuda.launches = 0
