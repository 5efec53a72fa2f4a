"""The port's hand-written kernels against their plain versions, on the card.

Marked ``cuda``: each test asks for the ``cuda`` fixture, which skips it on a
machine without a CUDA device. On the GPU machine run

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the GPU machine
need not have; nothing here uses it.)
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.codec import unpack_nibbles
from repro_torch.core.quantization import f32_div
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.log_quant import (
    log_dequantize_rows_triton,
    log_quantize_pack_triton,
    log_quantize_triton,
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


@pytest.mark.parametrize("shape", [(7,), (64, 32), (3, 48, 16), (1000,), (513, 7), (4, 1, 1056, 256)])
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


@pytest.mark.parametrize("shape", [(7,), (64, 32), (3, 48, 16), (1001,), (513, 7), (4, 1, 1056, 256)])
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
    assert torch.equal(log_quantize_triton(x, 0.0), ref.log_quantize_ref(x, 0.0, 8, 10.0))


@pytest.mark.parametrize("bits,r,nb", [(8, 4224, 256), (4, 4224, 128), (4, 37, 4), (8, 5, 33)])
def test_log_dequantize_rows_kernel(cuda, bits, r, nb):
    """Relative error <= 1e-6 (expm1 of the device and of torch)."""
    c = torch.randint(-128, 128, (r, nb), generator=cuda, device="cuda").to(torch.int8)
    if bits == 8:
        c = c.clamp(-127, 127)
    s = torch.rand((r, 1), generator=cuda, device="cuda") * 3
    s[0] = 0
    got = log_dequantize_rows_triton(c, s, bits=bits)
    want = ref.log_dequantize_rows_ref(c, s, bits, 10.0)
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= 1e-6 * want.abs()).all())


@pytest.mark.parametrize(
    "b,hq,hkv,s,d",
    [(1, 2, 2, 64, 32), (2, 4, 2, 128, 64), (1, 8, 1, 96, 64), (1, 4, 4, 33, 128),
     (1, 4, 1, 1, 256), (2, 4, 1, 300, 256)],
)
@pytest.mark.parametrize("window", [None, 1, 16, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(cuda, b, hq, hkv, s, d, window, dtype):
    """atol 1e-4 in f32 (scalar FMA vs torch's f32 GEMM), 2e-2 in bf16."""
    q, k, v = (
        torch.randn((b, h, s, d), generator=cuda, device="cuda").to(dtype)
        for h in (hq, hkv, hkv)
    )
    got = flash_attention_cuda(q, k, v, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.attention_ref(q.float(), k.float(), v.float(), window=window)
    atol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=0)


def test_dispatch_launches_kernels_and_reference_mode_does_not(cuda):
    x = torch.randn(1024, generator=cuda, device="cuda")
    ops.reset_launch_counts()
    ops.log_quantize(x, 1.0)
    with ops.reference_mode():
        ops.log_quantize(x, 1.0)
    assert ops.launch_counts()["log_quantize"] == 1
