"""How the port's redesigned kernels are shaped, checked on the CPU.

* The SSD chunk term on tensor cores, emulated in torch: each f32 operand
  rounded to TF32 as ``cvt.rna.tf32.f32`` does, split into hi + lo, and
  the three products hi*hi + hi*lo + lo*hi summed ("3xTF32"). At
  mamba2-370m's widths it stays within the 1e-4 of max |Y| that the card's
  checks require of ``csrc/ssd_chunk.cu`` against ``ref.ssd_chunk_ref``;
  one TF32 product does not. (The kernel sums by f32 FMA in its plain
  version's order instead, so it is bit-equal; a tensor-core version would
  need the three products.)
* :func:`repro_torch.kernels.ssd_chunk.head_slab`, the heads a block walks.
* :func:`repro_torch.kernels.log_quant.quantize_launch`, ``log_quantize``'s
  launch shape for n values, and the launch tables of ``log_quantize_pack``
  (``PACK_LAUNCH``, in packed bytes) and ``log_dequantize``
  (``DEQUANT_LAUNCH``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref
from repro_torch.kernels.log_quant import (
    DEQUANT_LAUNCH,
    PACK_LAUNCH,
    QUANTIZE_LAUNCH,
    launch_shape,
    quantize_launch,
)
from repro_torch.kernels.ssd_chunk import head_slab

# the card's bound on ssd_chunk against its plain version (test_torch_cuda.py,
# chip_smoke.SSD_REL_TOL)
SSD_REL_TOL = 1e-4
H100_SMS = 132


def _tf32(x):
    """Round f32 to TF32 (10 mantissa bits), to nearest, ties away from zero:
    add half of the dropped 13 bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _product(a, b, splits):
    """a @ b from TF32 operands, each product exact (f64) and the three
    summed, then rounded to f32: 3xTF32 where ``splits``, else one TF32
    product."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    f64 = lambda u, v: torch.matmul(u.double(), v.double())
    if not splits:
        return f64(a_hi, b_hi).float()
    return (f64(a_lo, b_hi) + f64(a_hi, b_lo) + f64(a_hi, b_hi)).float()


def _decay(a_cum):
    q = a_cum.shape[-1]
    causal = torch.ones((q, q), dtype=torch.bool).tril()
    seg = (a_cum[..., :, None] - a_cum[..., None, :]).masked_fill(~causal, -np.inf)
    return torch.exp(seg)


def _ssd_tf32(x, a_cum, bm, cm, splits):
    """The kernel's two products: S = C B^T, then M = S * L in f32 and
    Y = M X, both from TF32 operands."""
    s = _product(cm, bm.transpose(-1, -2), splits)
    return _product(s * _decay(a_cum), x, splits)


def _ssd_f64(x, a_cum, bm, cm):
    """The same function in f64 throughout."""
    s = torch.matmul(cm.double(), bm.double().transpose(-1, -2))
    return torch.matmul(s * _decay(a_cum.double()), x.double())


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0**-10  # the TF32 step above 1
    x = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 2.0**-12, one])
    assert _tf32(x).tolist() == [one, -one, 1.0, one]


@pytest.mark.parametrize("seed", [0, 1])
def test_ssd_chunk_3xtf32_meets_the_tolerance_one_tf32_misses_it(seed):
    """mamba2-370m's widths (Q 256, N 128, P 64; 4 of its 32 heads, one
    group, 2 chunks), a_cum falling as dt * A does: 3xTF32 within 1e-4 of
    max |Y| of the plain version, one TF32 product over it: why a
    tensor-core version of the kernel must split its operands. Against the
    function in f64, 3xTF32 is off by about 3e-7 of max |Y| on these draws
    and one TF32 product by about 6e-4. (PyTorch's first f32 matmul in a
    CPU process may itself be off by ~5e-5 of max |Y|, so the plain version
    is held to the card's bound only.)"""
    rng = np.random.default_rng(seed)
    b, h, nc, q, p, n = 1, 4, 2, 256, 64, 128
    x = torch.from_numpy(rng.standard_normal((b, h, nc, q, p), dtype=np.float32))
    a = torch.from_numpy((-1.6 * rng.random((b, h, nc, q))).astype(np.float32))
    a_cum = torch.cumsum(a, dim=-1)
    bc = rng.standard_normal((2, b, 1, nc, q, n), dtype=np.float32)
    bm, cm = (torch.from_numpy(t).expand(b, h, nc, q, n) for t in bc)
    want = ref.ssd_chunk_ref(x, a_cum, bm, cm)
    top = float(want.abs().max())
    err3 = float((_ssd_tf32(x, a_cum, bm, cm, True) - want).abs().max())
    err1 = float((_ssd_tf32(x, a_cum, bm, cm, False) - want).abs().max())
    assert err3 <= SSD_REL_TOL * top, (err3, top)
    assert err1 > SSD_REL_TOL * top, (err1, top)
    exact = _ssd_f64(x, a_cum, bm, cm)
    exact3 = float((_ssd_tf32(x, a_cum, bm, cm, True) - exact).abs().max())
    exact1 = float((_ssd_tf32(x, a_cum, bm, cm, False) - exact).abs().max())
    assert exact3 <= 1e-6 * top < SSD_REL_TOL * top < exact1, (exact3, exact1, top)


@pytest.mark.parametrize(
    "b,h,g,nc,q,want",
    [
        (4, 32, 1, 4, 256, 4),  # mamba2-370m (g1): 512 blocks
        (1, 32, 1, 32, 256, 8),  # mamba2-370m (g3): 512 blocks
        (4, 32, 1, 4, 232, 4),  # a ragged Q still makes 4 row tiles
        (64, 32, 1, 4, 256, 32),  # a grid that is full at one slab a group
        (2, 12, 2, 1, 64, 1),
        (9, 10, 2, 2, 256, 3),  # 5 heads a group: slabs of 3 and 2
    ],
)
def test_head_slab(b, h, g, nc, q, want):
    """The widest slab, halving from H/G, whose grid gives every SM two
    blocks; a narrower one only where the grid needs it."""
    slab = head_slab(b, h, g, nc, q, H100_SMS)
    assert slab == want
    rep, base = h // g, -(-q // 64) * nc * b * g
    assert 1 <= slab <= rep
    blocks = base * -(-rep // slab)
    assert blocks >= 2 * H100_SMS or slab == 1
    if slab < rep:  # the slab before it in the halving gave too few blocks
        wider = next(w for w in _halvings(rep) if -(-w // 2) == slab)
        assert base * -(-rep // wider) < 2 * H100_SMS


def _halvings(rep):
    w = rep
    while True:
        yield w
        if w == 1:
            return
        w = -(-w // 2)


def _covers_every_n(table, launch):
    """From 1 to 4.4 M (a gemma3-1b scan leaf is 4,325,376 values): each
    shape a power-of-two block of at least one element a thread on a
    power-of-two count of warps, and a grid that covers n with no program
    left empty."""
    tops = [top for top, _, _ in table[:-1]]
    assert tops == sorted(tops) and table[-1][0] is None
    ns = {1, 2, 7, 1000, 1024, 4_325_376, 4_400_000}
    ns |= {t + d for t in tops for d in (-1, 0, 1)}
    ns |= {int(v) for v in np.geomspace(1, 4.4e6, 200)}
    for n in sorted(ns):
        block, warps = launch(n)
        assert block & (block - 1) == 0 and warps & (warps - 1) == 0, n
        assert 1 <= warps <= 8 and block >= 32 * warps, n
        programs = -(-n // block)
        assert programs * block >= n > (programs - 1) * block, n


def test_quantize_launch_covers_every_n():
    _covers_every_n(QUANTIZE_LAUNCH, quantize_launch)


@pytest.mark.parametrize("name", ["pack", "dequant"])
def test_launch_table_covers_every_n(name):
    """``PACK_LAUNCH`` over packed bytes, ``DEQUANT_LAUNCH`` over values."""
    table = {"pack": PACK_LAUNCH, "dequant": DEQUANT_LAUNCH}[name]
    _covers_every_n(table, lambda n: launch_shape(table, n))


def test_quantize_launch_spreads_the_decode_append():
    """One token of gemma3-1b's K or V at batch 4 (1024 values) runs as
    several programs of a few values a thread, not one program; a prefill
    layer's K or V (4 x 1056 x 256) fills every SM of an H100."""
    block, warps = quantize_launch(4 * 256)
    assert -(-1024 // block) >= 4 and block // (32 * warps) <= 4
    block, _ = quantize_launch(4 * 1056 * 256)
    assert -(-(4 * 1056 * 256) // block) >= H100_SMS


def test_pack_launch_spreads_the_decode_append():
    """A q4 decode append (1024 values, 512 bytes) runs as at least 4
    programs of a byte or two a thread; a prefill layer's 540,672 bytes run
    as at least one program an SM at up to 4 bytes (8 values) a thread."""
    append, layer = 4 * 256 // 2, 4 * 1056 * 256 // 2
    block, warps = launch_shape(PACK_LAUNCH, append)
    assert -(-append // block) >= 4 and block // (32 * warps) <= 2
    block, warps = launch_shape(PACK_LAUNCH, layer)
    assert -(-layer // block) >= H100_SMS and block // (32 * warps) <= 4


@pytest.mark.parametrize("n", [5 * 512, 4608])
def test_dequant_launch_takes_one_value_a_thread_on_the_training_wire(n):
    """The expand's inputs on the training path, from the decoded codes of
    5 workers for a 512-value leaf to the mean code of ResNet-18's largest
    factor (4608 x 1): one value a thread, over a dozen programs or more."""
    block, warps = launch_shape(DEQUANT_LAUNCH, n)
    assert block == 32 * warps and -(-n // block) >= 12
