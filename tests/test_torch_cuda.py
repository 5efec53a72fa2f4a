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
from repro_torch.configs import get_config
from repro_torch.core.privacy.gia import (
    GIAConfig,
    attack_loss,
    invert_gradients_batched,
)
from repro_torch.launch.serve import run_continuous, run_fixed
from repro_torch.models.model import init_params
from repro_torch.serving.engine import DecodeLoop, build_prefill_step
from repro_torch.serving.kv_cache import CacheQuantConfig, QuantKV
from repro_torch.serving.kv_cache import tree_leaves as kv_tree_leaves
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


# ------------------------------------------------- graphed decode and attack
def _smoke_server(arch, bits):
    cfg = get_config(arch, smoke=True)
    params = init_params(cfg, 0, "cuda")
    qcfg = CacheQuantConfig(bits=bits) if bits else None
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 20))).cuda()
    return cfg, params, qcfg, tokens


def _cache_tensors(caches):
    for _, leaf in kv_tree_leaves(caches):
        yield from (leaf.codes, leaf.scale) if isinstance(leaf, QuantKV) else (leaf,)


def _caches_equal(a, b):
    pairs = zip(_cache_tensors(a), _cache_tensors(b), strict=True)
    return all(torch.equal(x, y) for x, y in pairs)


@pytest.mark.parametrize(
    "arch,bits,temperature",
    [
        ("gemma3-1b", 8, 0.0),
        ("gemma3-1b", 4, 0.0),
        ("mamba2-370m", 0, 0.0),
        ("gemma3-1b", 8, 1.0),
    ],
)
def test_graphed_generate_equals_eager(cuda, arch, bits, temperature):
    """``run_fixed`` replaying a CUDA graph of the decode step (the default
    on the card) against ``graph=False``: the same tokens (at temperature
    1 too, from the same generator seed, twice), every cache tensor equal
    byte for byte, the same launch counts; only the graph run captures."""
    cfg, params, qcfg, tokens = _smoke_server(arch, bits)
    runs, counts = [], []
    for graph in (None, False, None):
        ops.reset_launch_counts()
        kw = dict(gen=12, qcfg=qcfg, temperature=temperature, graph=graph)
        runs.append(run_fixed(cfg, params, tokens, **kw))
        counts.append(ops.launch_counts())
    graphed, eager, again = runs
    assert graphed["capture_s"] > 0 and eager["capture_s"] == 0
    for other in (eager, again):
        assert torch.equal(graphed["tokens"], other["tokens"])
        assert _caches_equal(graphed["caches"], other["caches"])
    assert counts[0] == counts[1] == counts[2]
    if arch == "gemma3-1b":
        # 11 decode steps x 2 layers x a K and a V read, all but one replayed
        assert counts[0]["log_dequantize_rows"] == 11 * 4


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_graphed_continuous_scheduler_equals_eager(cuda, temperature):
    """5 requests of 3-14 tokens x 10 through 2 slots, q8: the grid's graph
    is captured at the first chunk and replayed while requests retire and
    new ones take their slots (admission prefills and draws run eagerly
    between replays). Tokens, caches and launch counts equal the eager
    scheduler's."""
    cfg, params, qcfg, _ = _smoke_server("gemma3-1b", 8)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 9, 14, 3, 11)]
    runs, counts = [], []
    for graph in (None, False):
        ops.reset_launch_counts()
        kw = dict(gen=10, slots=2, qcfg=qcfg, temperature=temperature, graph=graph)
        runs.append(run_continuous(cfg, params, prompts, **kw))
        counts.append(ops.launch_counts())
    graphed, eager = runs
    assert graphed["scheduler"].steps == eager["scheduler"].steps >= 3
    assert graphed["capture_s"] > 0 and eager["capture_s"] == 0
    assert graphed["tokens"] == eager["tokens"]
    assert _caches_equal(graphed["scheduler"].caches, eager["scheduler"].caches)
    assert counts[0] == counts[1]


def test_a_graph_in_reference_mode_runs_no_kernel(cuda):
    """A decode loop keys its graphs on ``ops.reference_mode()``: run in
    reference mode it captures a graph of its own, whose replays launch no
    kernel; back outside, the kernel graph replays and launches."""
    cfg, params, qcfg, tokens = _smoke_server("gemma3-1b", 8)
    _, caches = build_prefill_step(cfg, 32, qcfg=qcfg)(params, tokens)
    loop = DecodeLoop(cfg, params, caches, 3, 4)
    first = tokens[:, -1:]
    ops.reset_launch_counts()
    kernel_tokens = loop.run(first, 20).clone()
    assert ops.launch_counts()["log_dequantize_rows"] == 4 * 4
    with ops.reference_mode():
        ops.reset_launch_counts()
        plain_tokens = loop.run(first, 20).clone()
        assert set(ops.launch_counts().values()) == {0}
    ops.reset_launch_counts()
    assert torch.equal(loop.run(first, 20), kernel_tokens)
    assert ops.launch_counts()["log_dequantize_rows"] == 4 * 4
    assert plain_tokens.shape == kernel_tokens.shape == (3, 4)
    assert loop.capture_s > 0


@pytest.mark.parametrize("model", ["cnn", "resnet18"])
def test_graphed_attack_equals_the_eager_loop(cuda, model):
    """20 sign-Adam steps over 4 restarts, graphed (step 0 eager, one step
    captured, 19 replays) against ``graph=False``: x̂ and the losses equal
    bit for bit, cuDNN deterministic as the benchmark runs it."""
    victim = gia_ssim.setup(model, "cuda")
    p, x, y = victim["params"], victim["x"], victim["y"]
    g_obs = victim["grad_fn"](p, x, y)
    gen = torch.Generator(device="cuda").manual_seed(2)
    x0 = 0.5 * torch.randn((4,) + tuple(x.shape), generator=gen, device="cuda")
    cfg = GIAConfig(steps=20, lr=0.05, tv_coef=5e-3)
    cudnn = torch.backends.cudnn
    was = cudnn.deterministic, cudnn.benchmark
    try:
        cudnn.deterministic, cudnn.benchmark = True, False
        out = [
            invert_gradients_batched(
                victim["grad_fn"], p, g_obs, tuple(x.shape), y, cfg=cfg, x0=x0, graph=g
            )
            for g in (None, False)
        ]
    finally:
        cudnn.deterministic, cudnn.benchmark = was
    (gx, gl), (ex, el) = out
    assert bool(torch.isfinite(gl).all()) and not torch.equal(gx, x0)
    assert torch.equal(gx, ex) and torch.equal(gl, el)


# ------------------------------------------------ the composite compressor
_LAZY_SHAPES = {"w": (64, 32), "b": (32,), "scan": (3, 48, 16)}
_LAZY_STACKED = {"w": False, "b": False, "scan": True}


def _lazy_run(mode, seeds):
    """A uniform lq_sgd r2 lazy composite, fused, on the card: identical
    and fresh gradients in turn; per step the outputs, the effective counts,
    the gathers and the launches, and the final state."""
    from repro_torch.core.comm import SimComm
    from repro_torch.core.composite import CompositeCompressor
    from repro_torch.core.compressors import LeafPolicy

    cfg = CompressorConfig(name="lq_sgd", rank=2, fuse_collectives=True, lazy_mode=mode)
    abstract = {k: torch.empty(s, device="meta") for k, s in _LAZY_SHAPES.items()}
    pol = LeafPolicy(rank=2, lazy_thresh=0.5, max_stale=2)
    comp = CompositeCompressor(cfg, abstract, _LAZY_STACKED, policies=[pol] * 3)
    st = comp.init_state(5, 4, "cuda")
    steps = []
    for seed in seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        g = {
            k: torch.randn((4,) + s, generator=gen, device="cuda")
            for k, s in _LAZY_SHAPES.items()
        }
        comm = SimComm(4, record=True)
        before = ops.launch_counts()
        out, st, rec = comp.sync(g, st, comm)
        after = ops.launch_counts()
        launched = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        counts = (rec.effective_bits(), rec.effective_collectives())
        steps.append((out, counts, len(comm.gathered), launched))
    return steps, st


_LAZY_SEEDS = [1, 1, 1, 2, 2, 3, 3, 3]


def test_lazy_elide_equals_gate_on_the_card(cuda):
    elide, st_e = _lazy_run("elide", _LAZY_SEEDS)
    gate, st_g = _lazy_run("gate", _LAZY_SEEDS)
    for (oe, ce, _, _), (og, cg, _, _) in zip(elide, gate):
        assert all(torch.equal(oe[k], og[k]) for k in oe)
        assert all(torch.equal(a, b) for a, b in zip(ce, cg))
    for ns, sub in st_e.items():
        if ns == "step":
            assert sub == st_g[ns]
            continue
        assert all(torch.equal(v, st_g[ns][k]) for k, v in sub.items()), ns
    fired = [float(c[1]) > 1 for _, c, _, _ in elide]
    assert fired[0] and any(fired[1:]) and not all(fired)


def test_lazy_skip_issues_no_gather_and_no_launch(cuda):
    steps, _ = _lazy_run("elide", _LAZY_SEEDS)
    for out, (bits, colls), n_gathers, launched in steps:
        if float(colls) > 1:  # fired: the group's kernels and gathers ran
            assert n_gathers > 0 and launched.get("log_quantize", 0) > 0
            assert launched.get("log_dequantize", 0) > 0
        else:  # skipped: only the decision psum
            assert float(colls) == 1 and n_gathers == 0 and launched == {}


def test_server_participation_draw_on_the_card(cuda):
    """2000 rounds of 5 workers at 0.5: the rate within 4 sd; the same
    (seed, step) gives the same flags on the device."""
    from repro_torch.core.wire import participation_draw

    p, rounds, n = 0.5, 2000, 5
    draws = torch.stack([participation_draw(3, t, n, p, "cuda") for t in range(rounds)])
    assert draws.device.type == "cuda" and draws.dtype == torch.bool
    rate = float(draws.float().mean())
    assert abs(rate - p) < 4 * (p * (1 - p) / (rounds * n)) ** 0.5
    assert torch.equal(participation_draw(3, 123, n, p, "cuda"), draws[123])


# ----------------------------------------------------- LM training (slice 10)
@pytest.mark.parametrize("name", ["flash_attention", "ssd_chunk"])
def test_attention_and_ssd_kernels_refuse_inputs_that_require_grad(cuda, name):
    """They have no backward: a CUDA input that requires grad raises with
    grad mode on, instead of coming back without a ``grad_fn``."""
    dev = torch.device("cuda")
    if name == "flash_attention":
        shapes = ((1, 4, 64, 64), (1, 1, 64, 64), (1, 1, 64, 64))
        args = [torch.randn(s, device=dev, dtype=torch.bfloat16) for s in shapes]
        why = "plain attention"
    else:
        gen = torch.Generator(device=dev).manual_seed(0)
        args = list(_ssd_inputs(gen, 1, 2, 1, 2, 16, 8, 16))
        why = "Mamba-2 trains through the plain SSD"
    args[0] = args[0].detach().requires_grad_(True)
    with pytest.raises(RuntimeError, match=why):
        getattr(ops, name)(*args)
    with torch.no_grad():
        out = getattr(ops, name)(*args)
    assert out.grad_fn is None and torch.isfinite(out.float()).all()


def test_full_width_lm_training_step_equals_reference_mode(cuda):
    """One step of gemma3-1b at full width, bf16, over 4 workers of 2 x 512
    tokens with LQ-SGD r1 b8 and Adam: the sync launches the encode (#1)
    and the wire dequant (#5) and no attention kernel; with deterministic
    algorithms on, the gradients into the sync equal reference mode's bit
    for bit, the synced gradients agree within one bf16 ulp of each leaf's
    largest value plus train_tol's f32 noise (1e-5), and the step ships
    the JAX package's 9,236,960 bits."""
    from repro_torch.data.synthetic import LMDataConfig, lm_batch
    from repro_torch.train.optimizer import adam
    from repro_torch.train.step import (
        build_train_step,
        init_train_state,
        make_model_compressor,
    )

    cfg = get_config("gemma3-1b")
    comp = make_model_compressor(cfg, CompressorConfig(name="lq_sgd", rank=1))
    batch = lm_batch(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=512, batch=8), 0)
    seen = {}

    def run(mode):
        def on_sync(grads, synced, state, rec):
            seen[mode] = dict(
                grads=[g.to("cpu") for g in tree_leaves(grads)],
                synced=[g.to("cpu") for g in tree_leaves(synced)],
                bits=rec.effective_bits(),
            )

        opt = adam(1e-3)
        state = init_train_state(cfg, 0, opt, comp, 4, "cuda")
        step = build_train_step(cfg, (4, 1), comp, opt, on_sync=on_sync)
        _, m = step(state, batch)
        assert math.isfinite(float(m["loss"]))
        del state
        torch.cuda.empty_cache()

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ops.reset_launch_counts()
        run("kernel")
        counts = ops.launch_counts()
        with ops.reference_mode():
            run("reference")
    finally:
        torch.use_deterministic_algorithms(False)
    assert counts["log_quantize"] > 0 and counts["log_dequantize"] > 0
    assert counts["flash_attention"] == counts["log_quantize_pack"] == 0
    k, r = seen["kernel"], seen["reference"]
    assert k["bits"] == r["bits"] == 9_236_960
    for g, w in zip(k["grads"], r["grads"], strict=True):
        assert torch.equal(g, w)
    for g, w in zip(k["synced"], r["synced"], strict=True):
        top = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= (2**-8 + 1e-5) * top


def test_graphed_attack_equals_eager_after_training(cuda):
    """(h2)'s check after other work: two ResNet-18 training steps of 5
    workers x 128 with LQ-SGD first, then the (sgd, cold start) attack on
    the full-width ResNet-18, 40 steps of 8 restarts, graphed and with
    ``graph=False``: x-hat and losses equal bit for bit."""
    import dataclasses

    from repro_torch.core.privacy.harness import _restart_keys

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    train_one(
        CompressorConfig(name="lq_sgd", rank=1, bits=8),
        n_workers=5,
        batch=128,
        hw=32,
        steps=2,
        device="cuda",
    )
    cfg = gia_ssim.harness_config(quick=False)
    gia = dataclasses.replace(cfg.gia, steps=40)
    victim = gia_ssim.setup("resnet18", "cuda")
    params, x, y, grad_fn = (victim[k] for k in ("params", "x", "y", "grad_fn"))
    g_obs = grad_fn(params, x, y)
    out = {}
    for graph in (None, False):
        keys = _restart_keys(cfg.seed, 0, cfg.n_attack_seeds, "cuda")
        out[graph] = invert_gradients_batched(
            grad_fn, params, g_obs, tuple(x.shape), y, keys, gia, graph=graph
        )
    assert torch.equal(out[None][0], out[False][0])
    assert torch.equal(out[None][1], out[False][1])


def _graph_vs_eager(run):
    """``run(graph)`` twice, graphed and with ``graph=False``, launch counts
    reset before each: (graphed result, eager result, their launch counts)."""
    out = {}
    for graph in (None, False):
        ops.reset_launch_counts()
        out[graph] = (run(graph), ops.launch_counts())
    return out[None][0], out[False][0], out[None][1], out[False][1]


@pytest.mark.parametrize(
    "knobs", [dict(name="lq_sgd", rank=1, bits=8), dict(name="qsgd", bits=4)]
)
def test_graphed_lm_step_equals_eager(cuda, knobs):
    """gemma3-1b at smoke widths, 4 workers, Adam, 4 steps (warm-up,
    capture, two replays) with deterministic algorithms on: every step's
    metrics, synced gradients and gathered wire arrays (a recording comm
    keeps all four steps' under the graph too), the final state and the
    launch counts of the graphed step equal the eager step's bit for bit."""
    from repro_torch.core.comm import SimComm
    from repro_torch.data.synthetic import LMDataConfig, lm_batch
    from repro_torch.train.optimizer import adam
    from repro_torch.train.step import (
        build_train_step,
        init_train_state,
        make_model_compressor,
    )

    cfg = get_config("gemma3-1b", smoke=True)
    comp = make_model_compressor(cfg, CompressorConfig(**knobs))
    data = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=64, batch=8)

    def run(graph):
        opt = adam(1e-3)
        state = init_train_state(cfg, 0, opt, comp, 4, "cuda")
        comm = SimComm(4, record=True)
        step = build_train_step(cfg, (4, 1), comp, opt, comm=comm, graph=graph)
        seen = []
        for i in range(4):
            state, m = step(state, lm_batch(data, i))
            synced = [g.clone() for g in tree_leaves(step.synced)]
            seen.append(({k: float(v) for k, v in m.items()}, synced))
        assert (step.graph is not None) == (graph is None)
        tensors = [x for x in tree_leaves(state) if isinstance(x, torch.Tensor)]
        return seen, tensors + comm.gathered

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        (g_seen, g_state), (e_seen, e_state), g_counts, e_counts = _graph_vs_eager(run)
    finally:
        torch.use_deterministic_algorithms(False)
    assert g_counts == e_counts and sum(g_counts.values()) > 0
    for (gm, gs), (em, es) in zip(g_seen, e_seen, strict=True):
        assert gm == em
        assert all(torch.equal(a, b) for a, b in zip(gs, es, strict=True))
    assert all(torch.equal(a, b) for a, b in zip(g_state, e_state, strict=True))


@pytest.mark.parametrize(
    "knobs", [dict(name="lq_sgd", rank=1, bits=4), dict(name="qsgd", bits=4)]
)
def test_graphed_resnet_step_equals_eager(cuda, knobs):
    """ResNet-18 at full width, 3 workers x 16 images at 32x32, 4 steps:
    the graphed ``train_one`` equals ``graph=False`` bit for bit (losses,
    every step's synced gradients, all four steps' gathered wire arrays in
    a recording comm, final parameters and compressor state, launch
    counts)."""
    from repro_torch.core.comm import SimComm

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    def run(graph):
        grads = []
        comm = SimComm(3, record=True)
        out = train_one(
            CompressorConfig(**knobs),
            n_workers=3,
            batch=16,
            hw=32,
            steps=4,
            device="cuda",
            comm=comm,
            graph=graph,
            on_sync=lambda t, s, st: grads.append([g.clone() for g in tree_leaves(s)]),
        )
        state = [x for x in tree_leaves(out.comp_state) if isinstance(x, torch.Tensor)]
        return out.losses, grads, tree_leaves(out.params), state + comm.gathered

    got, want, g_counts, e_counts = _graph_vs_eager(run)
    assert g_counts == e_counts and sum(g_counts.values()) > 0
    assert got[0] == want[0]
    for gs, ws in zip(got[1], want[1], strict=True):
        assert all(torch.equal(a, b) for a, b in zip(gs, ws, strict=True))
    for a, b in zip(got[2] + got[3], want[2] + want[3], strict=True):
        assert torch.equal(a, b)


def _sequence_number():
    """This thread's autograd sequence counter (the next node made here
    takes it; reading it makes one node)."""
    with torch.enable_grad():
        return (torch.zeros((), requires_grad=True) * 1.0).grad_fn._sequence_nr()


def _advance(n):
    """Move this thread's sequence counter on by ``n`` (``n`` CPU nodes)."""
    x = torch.zeros((), requires_grad=True)
    with torch.enable_grad():
        for _ in range(max(n, 0)):
            x * 1.0


class _OnBackwardThread(torch.autograd.Function):
    """The identity, whose backward calls ``fn`` on the thread the autograd
    engine runs it on: the card's own thread for a CUDA tensor."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        ctx.fn()
        return g, None


def _on_device_thread(fn):
    """``fn()`` run on the autograd engine's CUDA device thread."""
    got = {}
    x = torch.zeros(1, device="cuda", requires_grad=True)
    _OnBackwardThread.apply(x, lambda: got.setdefault("out", fn())).sum().backward()
    return got["out"]


def _lead_device_counter(lead):
    """Advance whichever autograd sequence counter is behind until the
    device thread's stands ``lead`` above this thread's (give or take the
    nodes that reading them makes)."""
    here, device = _sequence_number(), _on_device_thread(_sequence_number)
    gap = lead - (device - here)
    if gap > 0:
        _on_device_thread(lambda: _advance(gap))
    else:
        _advance(-gap)


def test_graphed_attack_equals_eager_whatever_autograd_ran_before(cuda, monkeypatch):
    """(h2)'s graph = eager check against what broke it after other work.
    The autograd engine runs a CUDA backward on a thread of its own and
    orders a backward's ready nodes by their sequence numbers, which each
    thread counts on its own; the attack's double backward mixed nodes of
    the calling thread and of that device thread, so its order, and the
    order in which it summed gradients, turned on where the two counters
    stood. A ResNet-18 training step first; then the (sgd, cold start)
    attack step on the full-width ResNet-18 (8 restarts), its gradient
    taken before the sign trick (which hides most rounding) with the
    device thread's counter at 17 leads from -2 to +2 attack steps' nodes
    over this thread's: bit-equal at every lead (the attack's backward runs
    on the calling thread, ``core/privacy/gia.py``; on the engine's
    threads some leads sum in another order: ``tools/gia_capture_probe.py
    --only shift``). Then the attack (40 steps) graphed and, with the
    device thread's counter far ahead, eagerly: x-hat and losses equal."""
    import dataclasses

    from repro_torch.core.privacy.gia import make_attack_step
    from repro_torch.core.privacy.harness import _restart_keys

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    train_one(
        CompressorConfig(name="lq_sgd", rank=1, bits=8),
        n_workers=2,
        batch=16,
        hw=32,
        steps=3,
        device="cuda",
    )
    cfg = gia_ssim.harness_config(quick=False)
    gia = dataclasses.replace(cfg.gia, steps=40)
    victim = gia_ssim.setup("resnet18", "cuda")
    params, x, y, grad_fn = (victim[k] for k in ("params", "x", "y", "grad_fn"))
    g_obs = grad_fn(params, x, y)

    step = make_attack_step(grad_fn, params, g_obs, y, gia)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x0 = torch.randn((8,) + tuple(x.shape), generator=gen, device="cuda")
    sign = torch.sign

    def raw_grad():
        seen = []
        monkeypatch.setattr(torch, "sign", lambda g: seen.append(g.clone()) or sign(g))
        m, v = torch.zeros_like(x0), torch.zeros_like(x0)
        step(x0.clone(), m, v, torch.zeros((), device="cuda"))
        monkeypatch.setattr(torch, "sign", sign)
        return seen[-1]

    before = _sequence_number() + _on_device_thread(_sequence_number)
    want = raw_grad()
    per_step = _sequence_number() + _on_device_thread(_sequence_number) - before
    differ = []
    for k in range(-8, 9):
        _lead_device_counter(k * per_step // 4)
        if not torch.equal(raw_grad(), want):
            differ.append(k)
    assert not differ, f"the gradient differs at leads {differ} x {per_step // 4}"

    def attack(graph):
        keys = _restart_keys(cfg.seed, 0, cfg.n_attack_seeds, "cuda")
        return invert_gradients_batched(
            grad_fn, params, g_obs, tuple(x.shape), y, keys, gia, graph=graph
        )

    _lead_device_counter(-3 * per_step)
    graphed = attack(None)
    _lead_device_counter(3 * per_step)
    eager = attack(False)
    assert torch.equal(graphed[0], eager[0])
    assert torch.equal(graphed[1], eager[1])


@pytest.mark.parametrize(
    "spec",
    ["dlog:bits=4,dp_epsilon=16", "dlog:bits=8,dp_epsilon=16", "lrq:bits=4", "lrq"],
)
@pytest.mark.parametrize("n", [4608, 1001])
def test_randomized_encode_on_the_card_equals_its_plain_version(cuda, spec, n):
    """dlog / lrq on the card: the codes come from plain torch on the card's
    generator, the b <= 4 pack from the nibble kernel, the expand from the
    dequant kernel; the same seed gives the same bytes as reference mode and
    as a second run, another seed other bytes, every code a valid b-bit one."""
    from repro_torch.core.codec import make_codec

    codec = make_codec(spec)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn(n, generator=gen, device="cuda") * 0.3).clamp(-1, 1)

    def enc(seed):
        return codec.encode(x, key=torch.Generator(device="cuda").manual_seed(seed))

    ops.reset_launch_counts()
    got = enc(5)
    launched = ops.launch_counts()
    assert launched["pack_nibbles"] == (1 if codec.bits <= 4 else 0)
    assert launched["log_quantize"] == launched["log_quantize_pack"] == 0
    with ops.reference_mode():
        want = enc(5)
    assert torch.equal(got, want) and torch.equal(got, enc(5))
    assert not torch.equal(got, enc(6))
    assert got.numel() * 8 == codec.wire_bits(n)
    codes = codec.decode(got, n)
    assert int(codes.abs().max()) <= (1 << (codec.bits - 1)) - 1
    out = codec.expand(codes)
    with ops.reference_mode():
        ref_out = codec.expand(codes)
    # the dequant kernel against its plain version: within 2 ulp, as above
    assert bool(((out - ref_out).abs() <= 2 * _ulp(ref_out)).all())


# ---------------------------------------------------------------- model zoo
@pytest.mark.parametrize(
    "b,hq,hkv,s,window",
    [
        (4, 32, 8, 1024, None),  # mistral-nemo-12b, qwen2, chameleon: 4-way GQA
        (4, 48, 1, 1024, None),  # granite-20b: 48-way MQA
        (2, 32, 8, 5120, 4096),  # mixtral-8x7b: a window of 4096, prompt past it
    ],
)
def test_flash_attention_kernel_at_the_zoo_shapes(cuda, b, hq, hkv, s, window):
    """head_dim 128 at the served zoo's prefill shapes, bf16, against the
    f32 plain version (by query chunks, as reference mode takes it past
    2048 positions): atol 2e-2, as at gemma3-1b's shapes."""
    q, k, v = (
        torch.randn((b, h, s, 128), generator=cuda, device="cuda").bfloat16()
        for h in (hq, hkv, hkv)
    )
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, window=window)
    assert flash_attention_cuda.launches == before + 1
    want = ref.chunked_attention_ref(q.float(), k.float(), v.float(), window=window)
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=0)


def test_ssd_chunk_kernel_at_jamba_shape(cuda):
    """jamba-v0.1-52b's prefill layer: B 4, H 128 in one group, NC 4, Q 256,
    P 64, N 16; max abs error <= 1e-4 of max |Y|."""
    x, a_cum, bm, cm = _ssd_inputs(cuda, 4, 128, 1, 4, 256, 64, 16)
    got = ssd_chunk_cuda(x, a_cum, bm, cm)
    rep = lambda t: t.repeat_interleave(128, 1)
    want = ref.ssd_chunk_ref(x, a_cum, rep(bm), rep(cm))
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err


@pytest.mark.parametrize("impl", ["global", "batched"])
def test_moe_forward_graph_equals_eager_without_host_sync(cuda, impl):
    """The MoE FFN at mixtral-8x7b's smoke widths in bf16 runs under
    ``set_sync_debug_mode("error")`` (nothing read on the host), and a CUDA
    graph of it, replayed on new inputs, equals the eager forward bit for
    bit (output and load-balance loss)."""
    import dataclasses

    from repro_torch.models.moe import init_moe, moe_forward

    cfg = dataclasses.replace(get_config("mixtral-8x7b", smoke=True), moe_impl=impl)
    p = tree_map(lambda t: t.bfloat16(), init_moe(cuda, cfg, "cuda"))
    xs = [
        torch.randn((2, 64, cfg.d_model), generator=cuda, device="cuda").bfloat16()
        for _ in range(2)
    ]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = [moe_forward(p, x, cfg) for x in xs]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    static = xs[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        moe_forward(p, static, cfg)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, aux = moe_forward(p, static, cfg)
    for x, (want_y, want_aux) in zip(xs, eager):
        static.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, want_y) and torch.equal(aux, want_aux)


# ------------------------------------- MLA, codebooks, Mamba-2 training (slice 14)
@pytest.mark.parametrize(
    "b,hq,s,dtype",
    [
        (1, 4, 300, torch.float32),  # ends inside a 32-row tile
        (2, 4, 129, torch.bfloat16),  # just past two 64-row tiles
        (4, 128, 1024, torch.bfloat16),  # deepseek-v3-671b's prefill (m1)
    ],
)
def test_flash_attention_kernel_at_head_dim_192(cuda, b, hq, s, dtype):
    """MLA's prefill head dim (128 nope + 64 rope), no GQA, V zero-padded
    from 128 to 192 as the model pads it, scale 1/sqrt(192): against the
    f32 plain version, atol 1e-4 in f32 and 2e-2 in bf16, and the padded
    columns of the output exactly 0."""
    q, k = (
        torch.randn((b, hq, s, 192), generator=cuda, device="cuda").to(dtype)
        for _ in range(2)
    )
    v = torch.randn((b, hq, s, 128), generator=cuda, device="cuda").to(dtype)
    v = torch.nn.functional.pad(v, (0, 64))
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v)
    assert flash_attention_cuda.launches == before + 1
    want = ref.attention_ref(q.float(), k.float(), v.float())
    atol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=0)
    assert bool((got[..., 128:] == 0).all())


@pytest.mark.parametrize("bits,nb", [(4, 32), (8, 32), (4, 256), (8, 512)])
def test_log_dequantize_rows_kernel_on_latent_and_codebook_rows(cuda, bits, nb):
    """The rows of this slice's caches: 32 bytes (MLA's krope of 64 at q4,
    musicgen's K/V of 64 at q4, krope at q8 of a head of 32), 256 and 512
    bytes (ckv of 512 at q4 and q8). Relative error <= 1e-6."""
    r = 4 * 1056
    c = torch.randint(-127, 128, (r, nb), generator=cuda, device="cuda").to(torch.int8)
    s = torch.rand((r, 1), generator=cuda, device="cuda") * 3
    before = log_dequantize_rows_cuda.launches
    got = log_dequantize_rows_cuda(c, s, bits=bits)
    assert log_dequantize_rows_cuda.launches == before + 1
    want = ref.log_dequantize_rows_ref(c, s, bits, 10.0)
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= 1e-6 * want.abs()).all())


def _mla_server():
    """deepseek-v3-671b at smoke widths but for a QK head dim of 192 (176
    nope + 16 rope), which the attention kernel takes."""
    import dataclasses

    cfg = dataclasses.replace(
        get_config("deepseek-v3-671b", smoke=True), qk_nope_dim=176
    )
    params = init_params(cfg, 0, "cuda")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 20))).cuda()
    return cfg, params, tokens


@pytest.mark.parametrize("bits", [0, 8])
def test_graphed_mla_decode_equals_eager(cuda, bits):
    """MLA's absorbed decode over the latent cache (raw, and q8 rows of 32
    and 16), replayed from a CUDA graph at a (B,) position tensor, against
    ``graph=False`` at the int position: the same tokens, every cache tensor
    equal, the same launch counts."""
    cfg, params, tokens = _mla_server()
    qcfg = CacheQuantConfig(bits=bits) if bits else None
    runs, counts = [], []
    for graph in (None, False):
        ops.reset_launch_counts()
        runs.append(run_fixed(cfg, params, tokens, gen=10, qcfg=qcfg, graph=graph))
        counts.append(ops.launch_counts())
    graphed, eager = runs
    assert graphed["capture_s"] > 0 and eager["capture_s"] == 0
    assert torch.equal(graphed["tokens"], eager["tokens"])
    assert _caches_equal(graphed["caches"], eager["caches"])
    assert counts[0] == counts[1] and counts[0]["flash_attention"] == 3
    if bits:
        # 9 decode steps x 3 layers x a ckv and a krope read
        assert counts[0]["log_dequantize_rows"] == 9 * 6


def test_graphed_mamba2_training_step_equals_eager(cuda):
    """mamba2-370m at smoke widths, 2 workers, LQ-SGD r1 b8, Adam, 3 steps
    (warm-up, capture, a replay) with deterministic algorithms on: the
    training forward takes the plain SSD (no ``ssd_chunk`` launch); every
    step's metrics and synced gradients and the final state of the graphed
    step equal the eager step's bit for bit."""
    from repro_torch.data.synthetic import LMDataConfig, lm_batch
    from repro_torch.train.optimizer import adam
    from repro_torch.train.step import (
        build_train_step,
        init_train_state,
        make_model_compressor,
    )

    cfg = get_config("mamba2-370m", smoke=True)
    comp = make_model_compressor(cfg, CompressorConfig(name="lq_sgd", rank=1))
    data = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=64, batch=4)

    def run(graph):
        opt = adam(1e-3)
        state = init_train_state(cfg, 0, opt, comp, 2, "cuda")
        step = build_train_step(cfg, (2, 1), comp, opt, graph=graph)
        seen = []
        for i in range(3):
            state, m = step(state, lm_batch(data, i))
            synced = [g.clone() for g in tree_leaves(step.synced)]
            seen.append(({k: float(v) for k, v in m.items()}, synced))
        return seen, [x for x in tree_leaves(state) if isinstance(x, torch.Tensor)]

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        (g_seen, g_state), (e_seen, e_state), g_counts, e_counts = _graph_vs_eager(run)
    finally:
        torch.use_deterministic_algorithms(False)
    assert g_counts == e_counts and g_counts["ssd_chunk"] == 0
    assert g_counts["log_quantize"] > 0
    for (gm, gs), (em, es) in zip(g_seen, e_seen, strict=True):
        assert gm == em and math.isfinite(gm["loss"])
        assert all(torch.equal(a, b) for a, b in zip(gs, es, strict=True))
    assert all(torch.equal(a, b) for a, b in zip(g_state, e_state, strict=True))


def _process_group(backend, path):
    import torch.distributed as dist

    store = dist.FileStore(str(path / "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)


def test_nccl_distcomm_world1_graphed_lm_step_equals_simcomm(cuda, tmp_path):
    """An NCCL ``DistComm`` of world 1 holding the 4 workers: a graphed LM
    step at smoke widths (the collectives captured) equals ``SimComm(4)``'s
    bit for bit (metrics, parameters, every gather)."""
    import _torch_dist as td
    import torch.distributed as dist

    from repro_torch.core.comm import DistComm, SimComm

    want = td.lm_smoke_steps(SimComm(4, record=True), "cuda")
    _process_group("nccl", tmp_path)
    try:
        got = td.lm_smoke_steps(DistComm(4, record=True), "cuda")
    finally:
        dist.destroy_process_group()
    assert got[3] and want[3]  # both graph replays
    assert got[0] == want[0]
    for a, b in zip(got[1] + got[2], want[1] + want[2], strict=True):
        assert torch.equal(a, b)


def test_gloo_step_on_the_card_refuses_a_graph(cuda, tmp_path):
    """Gloo's collectives run from the host: the step runs eagerly, and
    ``graph=True`` raises, naming gloo."""
    import _torch_dist as td
    import torch.distributed as dist

    from repro_torch.core.comm import DistComm, SimComm

    want = td.lm_smoke_steps(SimComm(4, record=True), "cuda", graph=False, steps=2)
    _process_group("gloo", tmp_path)
    try:
        got = td.lm_smoke_steps(DistComm(4, record=True), "cuda", steps=2)
        with pytest.raises(NotImplementedError, match="gloo"):
            td.lm_smoke_steps(DistComm(4), "cuda", graph=True, steps=1)
    finally:
        dist.destroy_process_group()
    assert not got[3]
    assert got[0] == want[0]
    for a, b in zip(got[1] + got[2], want[1] + want[2], strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["lq_sgd", "qsgd", "dlog"])
def test_nccl_two_ranks_lm_step_equals_simcomm(cuda, tmp_path, name):
    """Two NCCL ranks, one card each, 2 workers each: the LM step (graphed
    for LQ-SGD and QSGD, whose draws the graph registers; eager for dlog,
    the composite) equals ``SimComm(4)``'s in one process bit for bit, on
    every rank: each rank draws all 4 workers' values and keeps its rows."""
    if torch.cuda.device_count() < 2:
        pytest.skip(
            "needs 2 CUDA devices: NCCL refuses two ranks on one card, so "
            "NCCL at world 2 stays unverified until run on such a machine"
        )
    import _torch_dist as td

    from repro_torch.core.comm import SimComm

    want = td.lm_smoke_steps(SimComm(4, record=True), "cuda:0", name=name)
    join = td.spawn(
        None, str(tmp_path), world=2, target=td.card_lm_rank, extra=("nccl", name)
    )
    for got in join():
        assert got[3] == want[3] == (name != "dlog")
        _ranks_equal_simcomm(got, want, name)


def test_nccl_two_ranks_tp_serve_equals_one_process(cuda, tmp_path):
    """gemma3-1b smoke (f32, q8 cache) at a 1x2 mesh over NCCL, one card a
    rank: the graphed decode, its model-axis collectives captured, equals
    the eager tensor-parallel decode bit for bit (tokens, logits, cache
    shards), and both equal the one-process run on card 0: tokens equal,
    prefill logits atol / rtol 1e-4, cache codes within one step of the
    block the rank's spec cuts, bytes/token shares summing to its figure."""
    if torch.cuda.device_count() < 2:
        pytest.skip(
            "needs 2 CUDA devices: NCCL refuses two ranks on one card, so "
            "tensor-parallel serving over NCCL stays unverified until run on "
            "such a machine"
        )
    import _torch_dist as td
    import _torch_tp as tt

    from repro_torch.launch.sharding import cut

    want = tt.card_serve("cuda:0")
    join = td.spawn(None, str(tmp_path), world=2, target=tt.card_tp_rank)
    ranks = join()
    for got in ranks:
        g, e, rows = got["graphed"], got["eager"], got["rows"]
        assert torch.equal(g["tokens"], e["tokens"])
        assert torch.equal(g["logits"], e["logits"])
        for (_, gc, gs), (_, ec, es) in zip(g["caches"], e["caches"], strict=True):
            assert torch.equal(gc, ec) and torch.equal(gs, es)
        assert torch.equal(g["tokens"], want["tokens"][rows])
        torch.testing.assert_close(
            g["logits"], want["logits"][rows], atol=1e-4, rtol=1e-4
        )
        specs = [s for _, s in kv_tree_leaves(got["cache_specs"])]
        for (_, c, _), (_, wc, _), spec in zip(
            g["caches"], want["caches"], specs, strict=True
        ):
            block = cut(wc, spec, got["sizes"], got["coords"])
            assert int((c.int() - block.int()).abs().max()) <= 1
    assert sum(r["graphed"]["bytes"] for r in ranks) == want["bytes"]


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "jamba-v0.1-52b"])
def test_nccl_two_ranks_tp_serve_of_the_zoo_equals_one_process(cuda, tmp_path, arch):
    """mixtral-8x7b (2 of 4 experts a rank) and jamba-v0.1-52b (Mamba-2
    heads, conv channels, MoE and attention) smoke configs (f32, q8 cache)
    at a 1x2 mesh over NCCL, one card a rank: the graphed decode, its
    model-axis collectives captured, equals the eager tensor-parallel
    decode bit for bit (tokens, logits, cache shards), and both equal the
    one-process run on card 0: tokens equal, prefill logits atol / rtol
    1e-4, cache codes within one step of the block the rank's spec cuts,
    and raw leaves (the SSM state and conv window) rtol 1e-4 and within
    1e-4 of their largest value, or within 2e-2 of it where a cache code
    moved (a moved code moves the later decode steps' inputs, which the
    states carry: the zoo tests' allowance for decode after a code flip),
    bytes/token shares summing to its figure. The decode graphs are freed
    before the process group is destroyed (``card_tp_rank``)."""
    if torch.cuda.device_count() < 2:
        pytest.skip(
            "needs 2 CUDA devices: NCCL refuses two ranks on one card, so "
            "tensor-parallel serving over NCCL stays unverified until run on "
            "such a machine"
        )
    import _torch_dist as td
    import _torch_tp as tt

    from repro_torch.launch.sharding import cut

    want = tt.card_serve("cuda:0", arch=arch)
    join = td.spawn(
        None, str(tmp_path), world=2, target=tt.card_tp_rank, extra=(arch,)
    )
    ranks = join()
    for got in ranks:
        g, e, rows = got["graphed"], got["eager"], got["rows"]
        assert torch.equal(g["tokens"], e["tokens"])
        assert torch.equal(g["logits"], e["logits"])
        for (_, gc, gs), (_, ec, es) in zip(g["caches"], e["caches"], strict=True):
            assert torch.equal(gc, ec) and (gs is None or torch.equal(gs, es))
        assert torch.equal(g["tokens"], want["tokens"][rows])
        torch.testing.assert_close(
            g["logits"], want["logits"][rows], atol=1e-4, rtol=1e-4
        )
        specs = [s for _, s in kv_tree_leaves(got["cache_specs"])]
        raw, moved = [], 0
        for (_, c, sc), (_, wc, _), spec in zip(
            g["caches"], want["caches"], specs, strict=True
        ):
            block = cut(wc, spec, got["sizes"], got["coords"])
            if sc is None:
                raw.append((c, block))
            else:
                diff = (c.int() - block.int()).abs()
                assert int(diff.max()) <= 1
                moved += int((diff > 0).sum())
        share = 2e-2 if moved else 1e-4
        for c, block in raw:
            atol = share * float(block.abs().max())
            torch.testing.assert_close(c, block, atol=atol, rtol=1e-4)
    total = sum(r["graphed"]["bytes"] for r in ranks)
    assert total == pytest.approx(want["bytes"], rel=1e-12)


def test_nccl_two_ranks_tp_train_equals_one_process(cuda, tmp_path):
    """gemma3-1b smoke (f32) trained 3 steps with LQ-SGD r1 b8 and SGD at a
    1x2 mesh over NCCL, one card a rank: the graphed step, its model-axis
    and data-axis collectives captured, equals the eager tensor-parallel
    step bit for bit (losses, step 0's gradients, every step's synced
    gradients, parameters), and both equal the one-process run on card 0:
    losses rtol 1e-5, step 0's gradients within 1e-5 of each leaf's
    largest value, the synced gradients and parameters within
    ``flip_tol`` a step (a wire code on a bin edge may flip)."""
    _nccl_tp_train(tmp_path, "gemma3-1b")


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v3-671b"])
def test_nccl_two_ranks_tp_train_of_the_zoo_equals_one_process(cuda, tmp_path, arch):
    """As :func:`test_nccl_two_ranks_tp_train_equals_one_process` for mixtral
    (2 of 4 experts a rank, the router on the FFN's input) and deepseek
    (MLA's gathered latents, the shared expert, the MTP head) smoke."""
    _nccl_tp_train(tmp_path, arch)


@pytest.mark.parametrize("cname", ["topk", "qsgd_b4", "lazy"])
def test_nccl_two_ranks_tp_train_of_every_compressor_equals_one_process(
    cuda, tmp_path, cname
):
    """As :func:`test_nccl_two_ranks_tp_train_equals_one_process` with TopK
    (the candidates gathered over the model axis) and QSGD b4 (each rank
    draws the whole leaf and keeps its block), each one graph a step equal
    to the eager steps, and a lazy LQ-SGD group (the composite, eager both
    times), against one process: QSGD's values within two of its levels a
    step (a draw on a level's edge may round the other way)."""
    _nccl_tp_train(tmp_path, "gemma3-1b", cname)


def _nccl_tp_train(tmp_path, arch, cname=None):
    if torch.cuda.device_count() < 2:
        pytest.skip(
            "needs 2 CUDA devices: NCCL refuses two ranks on one card, so "
            "tensor-parallel training over NCCL stays unverified until run on "
            "such a machine"
        )
    import _torch_dist as td
    import _torch_tp_train as tt

    from repro_torch.core.compressors import model_split
    from repro_torch.core.tree import flatten_with_paths
    from repro_torch.train.step import train_param_specs

    levels = (1 << 7) - 1
    flip = 2 * ((1 + 10.0) ** (1 / levels) - 1)  # _torch_lm.flip_tol(8, 1)
    if cname == "topk":
        flip = 0.0  # the f32 wire: F32 only
    elif cname == "qsgd_b4":
        flip = 2 / 7  # two of b4's 7 levels
    want = tt.card_tp_train("cuda:0", arch=arch, cname=cname)
    join = td.spawn(
        None,
        str(tmp_path),
        world=2,
        target=tt.card_tp_train_rank,
        extra=(arch, cname),
    )
    cfg = get_config(arch, smoke=True)
    dims = model_split(None, train_param_specs(cfg, 2)).dims  # flatten order

    def close(a, b, tol, label):
        a, b = a.float(), b.float()
        atol = tol * max(float(b.abs().max()), 1e-30)
        torch.testing.assert_close(a, b, atol=atol, rtol=1e-4, msg=label)

    for got in join():
        g, e, m = got["graphed"], got["eager"], got["coords"]["model"]
        assert g["graphed"] == (cname != "lazy") and not e["graphed"]
        assert g["losses"] == e["losses"]
        np.testing.assert_allclose(g["losses"], want["losses"], rtol=1e-5)
        for key in ("params",):
            for a, b in zip(tree_leaves(g[key]), tree_leaves(e[key])):
                assert torch.equal(a, b)
        for s, (gs, es, ws) in enumerate(zip(g["seen"], e["seen"], want["seen"])):
            pairs = [("synced", 1 + s)] + ([("grads", 0)] if s == 0 else [])
            for key, steps in pairs:
                leaves = zip(
                    flatten_with_paths(gs[key]),
                    tree_leaves(es[key]),
                    tree_leaves(ws[key]),
                    dims,
                    strict=True,
                )
                for (path, a), b, w, dim in leaves:
                    assert torch.equal(a, b), (s, key, path)
                    if key == "grads":
                        a, w = a[0], w[0]
                    if dim is not None:
                        n = w.shape[dim] // 2
                        w = w.narrow(dim, m * n, n)
                    tol = 1e-5 if key == "grads" else max(steps * flip, 1e-5)
                    close(a, w, tol, path)
        for (path, a), w, dim in zip(
            flatten_with_paths(g["params"]), tree_leaves(want["params"]), dims
        ):
            if dim is not None:
                n = w.shape[dim] // 2
                w = w.narrow(dim, m * n, n)
            close(a, w, max(3 * flip, 1e-5), path)


def _ranks_equal_simcomm(got, want, name):
    """A rank's :func:`lm_smoke_steps` against ``SimComm(4)``'s: bit for
    bit, but for QSGD, whose raw leaves psum in f32 in the ring's order:
    then step 0 ships the same bytes and reads the same loss, and the rest
    may differ in the last bits."""
    if name != "qsgd":
        assert got[0] == want[0]
        for a, b in zip(got[1] + got[2], want[1] + want[2], strict=True):
            assert torch.equal(a, b)
        return
    assert got[0][0] == want[0][0]
    per_step = len(want[2]) // len(want[0])
    assert len(got[2]) == len(want[2])
    for a, b in zip(got[2][:per_step], want[2][:per_step], strict=True):
        assert torch.equal(a, b)
    for g, w in zip(got[0][1:], want[0][1:], strict=True):
        assert abs(g["loss"] - w["loss"]) <= 1e-3 * abs(w["loss"])


def test_gloo_two_ranks_qsgd_step_on_the_card_equals_simcomm(cuda, tmp_path):
    """Two gloo ranks sharing the card, 2 workers each (QSGD b4): each rank
    draws all 4 workers' rounding values from the one CUDA generator and
    keeps its rows, so step 0 ships ``SimComm(4)``'s bytes; the step runs
    eagerly (gloo)."""
    import _torch_dist as td

    from repro_torch.core.comm import SimComm

    want = td.lm_smoke_steps(SimComm(4, record=True), "cuda", graph=False, name="qsgd")
    join = td.spawn(
        None, str(tmp_path), world=2, target=td.card_lm_rank, extra=("gloo", "qsgd")
    )
    for got in join():
        assert not got[3]
        _ranks_equal_simcomm(got, want, "qsgd")
