"""The port's hand-written kernels against their plain versions, on the card.

Marked ``cuda``: each test asks for the ``cuda`` fixture, which skips it on a
machine without a CUDA device. On the GPU machine run

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the GPU machine
need not have; nothing here uses it.)
"""

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.codec import unpack_nibbles
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.quantization import f32_div
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data.synthetic import ImageDataConfig, image_batch
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.log_dequant_rows import log_dequantize_rows_cuda
from repro_torch.kernels.ssd_chunk import ssd_chunk_cuda
from repro_torch.models.resnet import init_resnet18, resnet18_forward
from repro_torch.train.data_parallel import train_one, worker_grads
from repro_torch.bench import gia_ssim
from repro_torch.core.privacy.gia import attack_loss
from repro_torch.kernels.log_quant import (
    DEQUANT_LAUNCH,
    NIBBLE_LAUNCH,
    PACK_LAUNCH,
    log_dequantize_triton,
    log_quantize_pack_triton,
    log_quantize_triton,
    pack_nibbles_triton,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _near_half(x, scale, bits, alpha=10.0):
    """Where the exact q*L lies near a half-integer, so that a last-ulp
    difference may round the code either way: within 1e-4 for b <= 8, and
    within 1e-4 * L / 127 above, since the f32 value of q*L carries an
    absolute rounding error that grows with L."""
    levels = (1 << (bits - 1)) - 1
    y = x.double() / (scale if scale > 0 else 1.0)
    u = torch.log1p(alpha * y.abs()) / math.log1p(alpha) * levels
    return ((u - u.floor()) - 0.5).abs() < 1e-4 * max(1.0, levels / 127)


def _assert_codes(got, want, near):
    diff = (got.int() - want.int()).abs()
    assert not bool((diff > 1).any())
    assert not bool(((diff == 1) & ~near).any())


@pytest.mark.parametrize(
    "shape", [(7,), (64, 32), (3, 48, 16), (1000,), (513, 7), (4, 1, 1056, 256)]
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [4, 8, 12])
def test_log_quantize_kernel(cuda, shape, dtype, bits):
    x = (torch.randn(shape, generator=cuda, device="cuda") * 2).to(dtype)
    scale = float(x.float().abs().max())
    before = log_quantize_triton.launches
    got = log_quantize_triton(x, scale, bits=bits)
    assert log_quantize_triton.launches == before + 1
    want = ref.log_quantize_ref(x, scale, bits, 10.0)
    assert got.dtype == want.dtype and got.shape == want.shape
    _assert_codes(got, want, _near_half(x.float(), scale, bits))


@pytest.mark.parametrize(
    "shape", [(7,), (64, 32), (3, 48, 16), (1001,), (513, 7), (4, 1, 1056, 256)]
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [3, 4])
def test_log_quantize_pack_kernel(cuda, shape, dtype, bits):
    x = (torch.randn(shape, generator=cuda, device="cuda") * 2).to(dtype)
    scale = float(x.float().abs().max())
    got = log_quantize_pack_triton(x, scale, bits=bits)
    want = ref.log_quantize_pack_ref(x, scale, bits, 10.0)
    assert got.shape == want.shape and got.dtype == torch.int8
    n = x.numel()
    near = _near_half(x.float().reshape(-1), scale, bits)
    _assert_codes(unpack_nibbles(got, n), unpack_nibbles(want, n), near)


@pytest.mark.parametrize("n", [1024, 16383, 16384, 16385, 1 << 18])
@pytest.mark.parametrize("unit", [True, False])
def test_log_quantize_kernel_launch_shapes(cuda, n, unit):
    """Every launch shape of ``QUANTIZE_LAUNCH`` at an n just under, at and
    just over each of its bounds, and the decode append (4, 1, 1, 256): on
    rows normalized as the codec does (scale 1.0, the compile-time unit
    case) and on raw values with their max as a general scale."""
    shape = (4, 1, 1, 256) if n == 1024 else (n,)
    x = torch.randn(shape, generator=cuda, device="cuda") * 2
    if unit:
        x, scale = x / x.abs().amax(-1, keepdim=True), 1.0
    else:
        scale = float(x.abs().max())
    before = log_quantize_triton.launches
    got = log_quantize_triton(x, scale, bits=8)
    assert log_quantize_triton.launches == before + 1
    want = ref.log_quantize_ref(x, scale, 8, 10.0)
    assert got.dtype == want.dtype and got.shape == want.shape
    _assert_codes(got, want, _near_half(x, scale, 8))


# values just under, at and just over each bound of PACK_LAUNCH (in bytes:
# an odd n one byte under, an even n at it, an odd n one byte over), the q4
# decode append, a prefill layer and an odd n on the last row
_PACK_NS = [1024, 4 * 1056 * 256, (1 << 20) + 1]
_PACK_NS += [n for t, _, _ in PACK_LAUNCH[:-1] for n in (2 * t - 3, 2 * t, 2 * t + 1)]


@pytest.mark.parametrize("n", _PACK_NS)
@pytest.mark.parametrize("unit", [True, False])
def test_log_quantize_pack_kernel_launch_shapes(cuda, n, unit):
    """Every launch shape of ``PACK_LAUNCH``, on rows normalized as the codec
    does (scale 1.0, the compile-time unit case) and on raw values with
    their max as a general scale: the codes of the plain version, an odd
    n's pad nibble 0, one launch."""
    shapes = {1024: (4, 1, 1, 256), 4 * 1056 * 256: (4, 1, 1056, 256)}
    x = torch.randn(shapes.get(n, (n,)), generator=cuda, device="cuda") * 2
    if unit:
        x, scale = x / x.abs().amax(-1, keepdim=True), 1.0
    else:
        scale = float(x.abs().max())
    before = log_quantize_pack_triton.launches
    got = log_quantize_pack_triton(x, scale, bits=4)
    assert log_quantize_pack_triton.launches == before + 1
    want = ref.log_quantize_pack_ref(x, scale, 4, 10.0)
    assert got.dtype == torch.int8 and got.shape == want.shape == ((n + 1) // 2,)
    if n % 2:
        assert int(got[-1]) >> 4 == 0
    near = _near_half(x.reshape(-1), scale, 4)
    _assert_codes(unpack_nibbles(got, n), unpack_nibbles(want, n), near)


def test_plain_versions_divide_as_ieee_f32(cuda):
    """The plain versions divide through ``f32_div``: equal bit for bit to
    numpy's f32 division. (PyTorch's CUDA ``x / python_float`` multiplies by
    the reciprocal instead, which moved a b=12 code by one step in
    test_log_quantize_kernel before the plain versions used f32_div.)"""
    x = torch.randn(1 << 20, generator=cuda, device="cuda")
    for d in (3.7, 127.0, 2047.0, 2.3978953):
        want = x.cpu().numpy() / np.float32(d)
        np.testing.assert_array_equal(f32_div(x, d).cpu().numpy(), want)


def test_zero_scale_reads_as_one(cuda):
    x = torch.linspace(-1, 1, 257, device="cuda")
    assert torch.equal(
        log_quantize_triton(x, 0.0), ref.log_quantize_ref(x, 0.0, 8, 10.0)
    )


@pytest.mark.parametrize(
    "bits,r,nb",
    [(8, 4224, 256), (4, 4224, 128), (4, 37, 4), (8, 5, 33), (4, 300, 37)],
)
def test_log_dequantize_rows_kernel(cuda, bits, r, nb):
    """Relative error <= 1e-6 (expm1 of the device and of torch), so zeros
    stay where they were. Widths that are no multiple of 16 bytes (4, 33,
    37) find each byte's row, and their last bytes take the scalar tail."""
    c = torch.randint(-128, 128, (r, nb), generator=cuda, device="cuda").to(torch.int8)
    if bits == 8:
        c = c.clamp(-127, 127)
    s = torch.rand((r, 1), generator=cuda, device="cuda") * 3
    s[0] = 0
    before = log_dequantize_rows_cuda.launches
    got = log_dequantize_rows_cuda(c, s, bits=bits)
    assert log_dequantize_rows_cuda.launches == before + 1
    want = ref.log_dequantize_rows_ref(c, s, bits, 10.0)
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= 1e-6 * want.abs()).all())


def test_log_dequantize_rows_kernel_refuses_unaligned_codes(cuda):
    c = torch.zeros(4 * 64 + 1, dtype=torch.int8, device="cuda")[1:].view(4, 64)
    with pytest.raises(ValueError, match="16-byte boundary"):
        log_dequantize_rows_cuda(c, torch.ones((4, 1), device="cuda"), bits=8)


@pytest.mark.parametrize(
    "shape", [(0,), (1,), (7,), (4096,), (4097,), (513, 7), (5, 3, 3, 512, 512)]
)
def test_pack_nibbles_kernel(cuda, shape):
    """Exact: the same bytes as the plain version, odd tails packing a zero
    code; an empty tensor launches nothing."""
    c = torch.randint(-8, 8, shape, generator=cuda, device="cuda").to(torch.int8)
    before = pack_nibbles_triton.launches
    got = pack_nibbles_triton(c)
    assert pack_nibbles_triton.launches == before + (1 if c.numel() else 0)
    want = ref.pack_nibbles_ref(c)
    assert got.dtype == torch.int8 and got.shape == want.shape
    assert torch.equal(got, want)


# codes (two a byte): 1, 2 and 3; 2 x BLOCK - 1 and + 1 of every row of
# NIBBLE_LAUNCH; just under, at and just over the bound between its rows
_NIBBLE_NS = [1, 2, 3]
_NIBBLE_NS += [n for _, b, _ in NIBBLE_LAUNCH for n in (2 * b - 1, 2 * b + 1)]
_NIBBLE_NS += [n for t, _, _ in NIBBLE_LAUNCH[:-1] for n in (2 * t - 1, 2 * t + 1)]
_NIBBLE_NS += [2 * t for t, _, _ in NIBBLE_LAUNCH[:-1]]


@pytest.mark.parametrize("n", _NIBBLE_NS)
def test_pack_nibbles_kernel_launch_shapes(cuda, n):
    """Every launch shape of ``NIBBLE_LAUNCH`` and the odd tail: the bytes
    of the plain version, an odd n's high nibble 0, one launch."""
    c = torch.randint(-8, 8, (n,), generator=cuda, device="cuda").to(torch.int8)
    before = pack_nibbles_triton.launches
    got = pack_nibbles_triton(c)
    assert pack_nibbles_triton.launches == before + 1
    assert torch.equal(got, ref.pack_nibbles_ref(c))
    if n % 2:
        assert (int(got[-1]) >> 4) & 0xF == 0


@pytest.mark.parametrize("n", [1, 2, 4096, 4097])
def test_pack_nibbles_kernel_reads_a_view_at_an_odd_address(cuda, n):
    """A view with a storage offset of 1 (an odd data pointer, so no
    16-byte vector loads): the plain version's bytes, through the dispatch
    too."""
    base = torch.randint(-8, 8, (n + 1,), generator=cuda, device="cuda")
    view = base.to(torch.int8)[1:]
    assert view.storage_offset() == 1 and view.data_ptr() % 2 == 1
    assert torch.equal(pack_nibbles_triton(view), ref.pack_nibbles_ref(view))
    assert torch.equal(ops.pack_nibbles(view), ref.pack_nibbles_ref(view))


def _ulp(x):
    """The f32 spacing at |x|: the distance to the next float away from 0."""
    a = x.abs()
    return torch.nextafter(a, torch.full_like(a, math.inf)) - a


@pytest.mark.parametrize("shape", [(0,), (1,), (7,), (4608, 1), (5, 512), (1000, 33)])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("kind", ["f32_mean", "int8"])
def test_log_dequantize_kernel(cuda, shape, bits, kind):
    """Within 2 ulp of the plain version: expm1 of the device's libdevice and
    of torch may differ in the last bit, and the division by alpha and the
    scale multiply each round once more. Inputs: integer codes, and the f32
    mean of 5 workers' codes as the paper's avg mode hands the expand."""
    lv = (1 << (bits - 1)) - 1
    codes = torch.randint(-lv, lv + 1, (5,) + shape, generator=cuda, device="cuda")
    if kind == "int8":
        c = codes[0].to(torch.int8)
    else:
        c = codes.float().mean(0)
    for scale in (1.0, 0.37):
        got = log_dequantize_triton(c, scale, bits=bits)
        want = ref.log_dequantize_ref(c, scale, bits, 10.0)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert bool(((got - want).abs() <= 2 * _ulp(want)).all())
        assert bool(((got == 0) == (want == 0)).all())


# values just under, at and just over each bound of DEQUANT_LAUNCH, the
# training wire's two shapes and one on the last row
_DEQUANT_SHAPES = [(4608, 1), (5, 512), (1 << 20,)]
_DEQUANT_SHAPES += [(t + d,) for t, _, _ in DEQUANT_LAUNCH[:-1] for d in (-1, 0, 1)]


@pytest.mark.parametrize("shape", _DEQUANT_SHAPES)
@pytest.mark.parametrize("kind", ["f32_mean", "int8"])
def test_log_dequantize_kernel_launch_shapes(cuda, shape, kind):
    """Every launch shape of ``DEQUANT_LAUNCH`` at scale 1.0 (the
    compile-time unit case every caller takes) and at a general scale:
    within 2 ulp of the plain version, zeros where it has them, one launch
    a call."""
    codes = torch.randint(-127, 128, (5,) + shape, generator=cuda, device="cuda")
    c = codes[0].to(torch.int8) if kind == "int8" else codes.float().mean(0)
    for scale in (1.0, 0.37):
        before = log_dequantize_triton.launches
        got = log_dequantize_triton(c, scale, bits=8)
        assert log_dequantize_triton.launches == before + 1
        want = ref.log_dequantize_ref(c, scale, 8, 10.0)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert bool(((got - want).abs() <= 2 * _ulp(want)).all())
        assert bool(((got == 0) == (want == 0)).all())


@pytest.mark.parametrize(
    "b,hq,hkv,s,d",
    [
        (1, 2, 2, 64, 32),
        (2, 4, 2, 128, 64),
        (1, 8, 1, 96, 64),
        (1, 4, 4, 33, 128),
        (1, 4, 1, 1, 256),
        (2, 4, 1, 300, 256),
        # gemma3-1b's heads, ending inside, at and just past a 64-row tile
        (2, 4, 1, 63, 256),
        (2, 4, 1, 64, 256),
        (2, 4, 1, 65, 256),
        (2, 4, 1, 129, 256),
        (2, 4, 1, 1000, 256),
    ],
)
# 48 and 512 end inside a 64-key tile of the bf16 kernel
@pytest.mark.parametrize("window", [None, 1, 16, 100, 48, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(cuda, b, hq, hkv, s, d, window, dtype):
    """atol 1e-4 in f32 (scalar FMA vs torch's f32 GEMM), 2e-2 in bf16
    (tensor cores, P rounded to bf16)."""
    q, k, v = (
        torch.randn((b, h, s, d), generator=cuda, device="cuda").to(dtype)
        for h in (hq, hkv, hkv)
    )
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, window=window)
    assert flash_attention_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.attention_ref(q.float(), k.float(), v.float(), window=window)
    atol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=0)


def _ssd_inputs(gen, b, h, g, nc, q, p, n):
    """x, a_cum, B, C as the model hands them to the kernel: permuted views of
    (B, NC, Q, H, P), (B, NC, Q, H) and (B, NC, Q, G, N), not copies. a_cum
    falls to about -200 within a chunk of 256, as dt * A does in mamba2-370m,
    so the decay underflows to 0 where it does in the model."""
    x = torch.randn((b, nc, q, h, p), generator=gen, device="cuda")
    a = -torch.rand((b, nc, q, h), generator=gen, device="cuda") * 1.6
    bm = torch.randn((b, nc, q, g, n), generator=gen, device="cuda")
    cm = torch.randn((b, nc, q, g, n), generator=gen, device="cuda")
    a_cum = torch.cumsum(a.permute(0, 3, 1, 2), dim=-1)
    heads_first = (0, 3, 1, 2, 4)
    return (
        x.permute(heads_first), a_cum, bm.permute(heads_first), cm.permute(heads_first)
    )


@pytest.mark.parametrize("nc", [1, 5])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("p", [8, 64])
@pytest.mark.parametrize("n", [16, 128])
@pytest.mark.parametrize("q", [16, 64, 100, 256])
def test_ssd_chunk_kernel(cuda, q, n, p, groups, nc):
    """Against the plain version on the groups broadcast to heads (jnp.repeat's
    order), f32: max abs error <= 1e-4 of max |Y|. Both sum up to N + Q f32
    products per entry in other orders; K eps for K = 384 is 2.3e-5."""
    x, a_cum, bm, cm = _ssd_inputs(cuda, 2, 4, groups, nc, q, p, n)
    before = ssd_chunk_cuda.launches
    got = ssd_chunk_cuda(x, a_cum, bm, cm)
    assert ssd_chunk_cuda.launches == before + 1
    rep = 4 // groups
    want = ref.ssd_chunk_ref(
        x, a_cum, bm.repeat_interleave(rep, 1), cm.repeat_interleave(rep, 1)
    )
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert got.is_contiguous()
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err


@pytest.mark.parametrize(
    "b,h,g,nc,q,n,p,slab",
    [
        (1, 32, 1, 2, 256, 128, 64, None),  # mamba2-370m's heads, default slab
        (1, 32, 1, 2, 256, 128, 64, 32),  # the whole group in one slab
        (1, 32, 1, 2, 256, 128, 64, 5),  # slabs of 5 and a last one of 2
        (2, 12, 2, 2, 256, 128, 64, 4),  # 6 heads a group: slabs of 4 and 2
        (2, 12, 2, 3, 100, 16, 8, 5),  # ragged Q, slabs of 5 and 1
        (2, 10, 2, 2, 200, 17, 10, 3),  # N, P no multiple of 4: 4-byte copies
        (1, 6, 3, 1, 77, 40, 7, 2),  # odd P: scalar stores
    ],
)
def test_ssd_chunk_kernel_head_layouts(cuda, b, h, g, nc, q, n, p, slab):
    """Head slabs that share C B^T, whole or not dividing a group's heads,
    against the plain version: max abs error <= 1e-4 of max |Y|."""
    x, a_cum, bm, cm = _ssd_inputs(cuda, b, h, g, nc, q, p, n)
    before = ssd_chunk_cuda.launches
    got = ssd_chunk_cuda(x, a_cum, bm, cm, slab=slab)
    assert ssd_chunk_cuda.launches == before + 1
    rep = h // g
    want = ref.ssd_chunk_ref(
        x, a_cum, bm.repeat_interleave(rep, 1), cm.repeat_interleave(rep, 1)
    )
    assert got.shape == want.shape and got.is_contiguous()
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err


def test_ssd_chunk_kernel_equals_plain_bit_for_bit(cuda):
    """mamba2-370m's (g1) prefill layer, the groups broadcast to heads as
    reference mode does: the kernel sums in its plain version's order (one
    f32 FMA chain an entry, ascending), so the two agree bit for bit. The
    served model's logits against reference mode need it: 48 bf16 layers
    carry any last-bit difference to about 5% of the logits."""
    x, a_cum, bm, cm = _ssd_inputs(cuda, 4, 32, 1, 4, 256, 64, 128)
    got = ssd_chunk_cuda(x, a_cum, bm, cm)
    rep = lambda t: t.repeat_interleave(32, 1)
    assert torch.equal(got, ref.ssd_chunk_ref(x, a_cum, rep(bm), rep(cm)))


def test_ssd_chunk_kernel_is_deterministic(cuda):
    """mamba2-370m's (g1) prefill layer twice: the same bits (no atomics;
    every sum in one order), which the q8-equals-raw token check needs."""
    x, a_cum, bm, cm = _ssd_inputs(cuda, 4, 32, 1, 4, 256, 64, 128)
    first = ssd_chunk_cuda(x, a_cum, bm, cm)
    assert torch.equal(first, ssd_chunk_cuda(x, a_cum, bm, cm))


def test_ssd_chunk_kernel_refuses_what_a_block_cannot_hold(cuda):
    x, a_cum, bm, cm = _ssd_inputs(cuda, 1, 2, 1, 1, 16, 128, 16)
    with pytest.raises(ValueError, match="P 128"):
        ssd_chunk_cuda(x, a_cum, bm, cm)
    x, a_cum, bm, cm = _ssd_inputs(cuda, 1, 2, 1, 1, 16, 8, 16)
    with pytest.raises(ValueError, match="float32"):
        ssd_chunk_cuda(x.double(), a_cum, bm, cm)


def test_dispatch_launches_kernels_and_reference_mode_does_not(cuda):
    x = torch.randn(1024, generator=cuda, device="cuda")
    ssd = _ssd_inputs(cuda, 1, 2, 1, 2, 16, 8, 16)
    codes = torch.zeros((4, 128), dtype=torch.int8, device="cuda")
    scales = torch.ones((4, 1), device="cuda")
    qkv = [torch.randn((1, 1, 70, 64), device="cuda").bfloat16() for _ in range(3)]

    def every_kernel():
        ops.log_quantize(x, 1.0)
        ops.log_dequantize(x)
        ops.pack_nibbles(torch.zeros(9, dtype=torch.int8, device="cuda"))
        ops.ssd_chunk(*ssd)
        ops.log_dequantize_rows(codes, scales, bits=4)
        ops.flash_attention(*qkv)

    ops.reset_launch_counts()
    every_kernel()
    with ops.reference_mode():
        every_kernel()
    counts = ops.launch_counts()
    assert counts["log_quantize"] == counts["log_dequantize"] == 1
    assert counts["pack_nibbles"] == counts["ssd_chunk"] == 1
    assert counts["log_dequantize_rows"] == counts["flash_attention"] == 1


def _attack_inputs(model, dtype, dev):
    """The GIA benchmark's victim on ``dev`` in ``dtype``, its observed raw
    gradient, and 4 seeded restarts x̂ (drawn on the CPU)."""
    victim = gia_ssim.setup(model, "cpu")
    p = tree_map(lambda t: t.to(dev, dtype), victim["params"])
    x, y = victim["x"].to(dev, dtype), victim["y"].to(dev)
    g_obs = victim["grad_fn"](p, x, y)
    gen = torch.Generator().manual_seed(1)
    x_hat = 0.5 * torch.randn((4,) + tuple(x.shape), generator=gen, dtype=dtype)
    loss = functools.partial(attack_loss, victim["grad_fn"], p, g_obs, y, 5e-3)
    return loss, x_hat.to(dev)


@pytest.mark.parametrize(
    "model,dtype,tol",
    [("cnn", torch.float32, 1e-4), ("resnet18", torch.float64, 1e-8)],
)
def test_attack_gradient_on_the_card_equals_the_cpu(cuda, model, dtype, tol):
    """The attack's double backward, ∂(attack loss)/∂x̂ at a seeded x̂ for
    the GIA benchmark's victims (the 2-conv net at 16x16, ResNet-18 at
    32x32), on the card against the same call on the CPU, TF32 off: within
    ``tol`` of the largest |∂|. The 2-conv net in f32; ResNet-18 in f64,
    since f32 rounding alone moves its attack gradient by 8e-3 of the
    largest on the CPU (BatchNorm over a batch of one). No kernel of the
    port runs in it: its convolutions are cuDNN's."""
    grads = {}
    for dev in ("cpu", "cuda"):
        loss, x_hat = _attack_inputs(model, dtype, dev)
        grads[dev] = torch.func.grad(loss)(x_hat[0]).cpu()
    want, got = grads["cpu"], grads["cuda"]
    top = float(want.abs().max())
    assert top > 0 and got.dtype == dtype
    assert float((got - want).abs().max()) <= tol * top


def test_batched_attack_gradient_on_the_card_equals_a_loop(cuda):
    """Restarts under ``torch.func.vmap`` (one convolution over all of
    them) against one call a restart, on the card: within 1e-4 of the
    largest |∂|."""
    loss, x_hat = _attack_inputs("cnn", torch.float32, "cuda")
    batched = torch.func.vmap(torch.func.grad(loss))(x_hat)
    looped = torch.stack([torch.func.grad(loss)(x) for x in x_hat])
    top = float(looped.abs().max())
    assert float((batched - looped).abs().max()) <= 1e-4 * top


def test_train_one_computes_in_f32_with_tf32_on(cuda):
    """With both TF32 flags on (cuDNN's default for convolutions), a step of
    ``train_one`` (the training launcher's loop) on ResNet-18 gives the
    gradients of the same step taken in f32 with both flags off: the mean
    of the workers' gradients within 1e-4 x each leaf's max |grad|, the f32
    tolerance of tests/test_torch_resnet.py. cuDNN deterministic, so the
    two runs pick their algorithms alike; the flags come back on."""
    workers, batch, hw = 2, 8, 32
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    was = cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32
    try:
        cudnn.deterministic, cudnn.benchmark = True, False
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        out = train_one(
            CompressorConfig(name="none"),
            n_workers=workers,
            batch=batch,
            hw=hw,
            steps=1,
            device="cuda",
        )
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
        cudnn.allow_tf32 = matmul.allow_tf32 = False
        params = init_resnet18(10, seed=0, device="cuda")
        params = tree_map(lambda t: t.requires_grad_(True), params)
        data = ImageDataConfig(n_classes=10, hw=hw, batch=workers * batch, seed=0)
        b = image_batch(data, 0, "cuda")
        images = b["images"].reshape((workers, batch) + b["images"].shape[1:])
        labels = b["labels"].reshape(workers, batch)
        _, grads = worker_grads(resnet18_forward, params, images, labels)
    finally:
        cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32 = was
    for got, w in zip(tree_leaves(out.last_grads), tree_leaves(grads)):
        want = w.mean(0)
        err, top = float((got - want).abs().max()), float(want.abs().max())
        assert err <= 1e-4 * top, (err, top)
