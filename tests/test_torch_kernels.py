"""The port's kernel modules against the JAX package's Pallas kernels.

Inputs come from numpy with a fixed seed and go through both sides: the
Pallas kernel in interpret mode (or the JAX oracle) and the port's dispatch
wrapper on a CPU tensor, which takes the kernel's plain version. The
hand-written CUDA/Triton kernels themselves are held against these plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core.codec import pack_nibbles
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.log_quant import (
    log_dequantize_rows_pallas,
    log_quantize_pack_pallas,
    log_quantize_pallas,
)
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

ALPHA = 10.0
# one compile per shape instead of JAX's op-by-op dispatch
_jax_attention = jax.jit(jref.attention_ref, static_argnames=("causal", "window", "scale"))


def _inputs(shape, dtype, seed):
    """The same values on both sides: f32 from numpy, rounded to bf16 (RNE)
    by each framework where asked, and checked equal."""
    x = (np.random.default_rng(seed).standard_normal(shape) * 2.0).astype(np.float32)
    if dtype == "float32":
        return jnp.asarray(x), torch.from_numpy(x.copy())
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x.copy()).to(torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(xj, np.float32), xt.float().numpy())
    return xj, xt


def _scale(xt):
    return float(xt.float().abs().max())


# ------------------------------------------------------ #1 log_quantize, exact
@pytest.mark.parametrize("shape", [(7,), (64, 32), (3, 48, 16), (1000,), (513, 7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [4, 8, 12])
def test_log_quantize_matches_pallas(shape, dtype, bits):
    """Codes equal byte for byte (tolerance 0): same f32 ops, half-to-even."""
    xj, xt = _inputs(shape, dtype, seed=0)
    scale = _scale(xt)
    want = log_quantize_pallas(xj, jnp.float32(scale), bits=bits, alpha=ALPHA)
    got = ops.log_quantize(xt, scale, bits=bits, alpha=ALPHA)
    assert got.dtype == (torch.int8 if bits <= 8 else torch.int16)
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_log_quantize_zero_scale_reads_as_one():
    x = torch.linspace(-1.0, 1.0, 64)
    got = ops.log_quantize(x, 0.0, bits=8, alpha=ALPHA)
    want = log_quantize_pallas(jnp.asarray(x.numpy()), jnp.float32(0.0), bits=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_log_quantize_rounds_half_to_even():
    """q*L landing exactly on a half-integer rounds to even, as jnp.round
    does; floor(x + 0.5) would round 0.5 up to 1."""
    cfg_levels = 7  # bits 4
    # log1p(a|y|)/log1p(a) * 7 == 0.5  <=>  |y| = expm1(log1p(a) * 0.5 / 7) / a
    y = np.float32(np.expm1(np.log1p(np.float32(ALPHA)) * 0.5 / cfg_levels) / ALPHA)
    x = torch.tensor([y, -y], dtype=torch.float32)
    got = ops.log_quantize(x, 1.0, bits=4, alpha=ALPHA)
    want = log_quantize_pallas(jnp.asarray(x.numpy()), jnp.float32(1.0), bits=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------- #3 log_quantize_pack, exact bytes
@pytest.mark.parametrize("shape", [(7,), (64, 32), (3, 48, 16), (1001,), (513, 7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [3, 4])
def test_log_quantize_pack_matches_pallas(shape, dtype, bits):
    """Packed bytes equal (tolerance 0), the zero pad nibble of odd sizes
    included."""
    xj, xt = _inputs(shape, dtype, seed=7)
    scale = _scale(xt)
    want = log_quantize_pack_pallas(xj, jnp.float32(scale), bits=bits, alpha=ALPHA)
    got = ops.log_quantize_pack(xt, scale, bits=bits, alpha=ALPHA)
    n = int(np.prod(shape))
    assert got.dtype == torch.int8 and tuple(got.shape) == ((n + 1) // 2,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_log_quantize_pack_rejects_wide_bits():
    with pytest.raises(ValueError, match="bits <= 4"):
        ops.log_quantize_pack(torch.ones(8), 1.0, bits=8)


# ------------------------------------------------ #4 log_dequantize_rows
@pytest.mark.parametrize(
    "bits,r,d",
    [(8, 96, 32), (4, 96, 32), (4, 37, 7)],  # q8, q4, odd d (padded even)
)
def test_log_dequantize_rows_matches_pallas(bits, r, d):
    """Row dequant within rtol 1e-6 / atol 1e-7 (f32 expm1 of the two math
    libraries may differ in the last ulp)."""
    rng = np.random.default_rng(3)
    lv = (1 << (bits - 1)) - 1
    codes = rng.integers(-lv, lv + 1, size=(r, d + d % 2 if bits <= 4 else d))
    if bits <= 4:
        packed = np.asarray(pack_nibbles(jnp.asarray(codes))).reshape(r, -1)
    else:
        packed = codes.astype(np.int8)
    scales = rng.uniform(0.0, 3.0, size=(r, 1)).astype(np.float32)
    scales[0, 0] = 0.0  # an all-zero row stores scale 0
    want = log_dequantize_rows_pallas(
        jnp.asarray(packed), jnp.asarray(scales), bits=bits, alpha=ALPHA
    )
    got = ops.log_dequantize_rows(
        torch.from_numpy(packed.copy()), torch.from_numpy(scales), bits=bits
    )
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


# ------------------------------------------------------ #6 flash attention
def _qkv(b, hq, hkv, s, d, dtype, seed):
    rng = np.random.default_rng(seed)
    out = []
    for h in (hq, hkv, hkv):
        out.append(_inputs((b, h, s, d), dtype, int(rng.integers(1 << 30))))
    return [o[0] for o in out], [o[1] for o in out]


@pytest.mark.parametrize(
    "b,hq,hkv,s,d",
    [
        (1, 2, 2, 64, 32),  # MHA
        (2, 4, 2, 128, 64),  # GQA 2:1
        (1, 8, 1, 96, 64),  # MQA, unaligned seq
        (1, 4, 4, 33, 128),  # odd seq
    ],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_jax_ref_causal(b, hq, hkv, s, d, dtype):
    """atol 2e-5 in f32, 2e-2 in bf16 (the tolerances of the JAX suite)."""
    (qj, kj, vj), (qt, kt, vt) = _qkv(b, hq, hkv, s, d, dtype, seed=1)
    want = _jax_attention(qj, kj, vj, causal=True)
    got = ops.flash_attention(qt, kt, vt, causal=True)
    assert got.dtype == qt.dtype
    atol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=atol
    )


@pytest.mark.parametrize("window", [1, 16, 64, 1000])
def test_attention_sliding_window(window):
    """Windowed causal attention, f32, atol 3e-5."""
    (qj, kj, vj), (qt, kt, vt) = _qkv(1, 2, 2, 80, 32, "float32", seed=2)
    want = _jax_attention(qj, kj, vj, causal=True, window=window)
    got = ops.flash_attention(qt, kt, vt, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


@pytest.mark.parametrize("window", [None, 24])
def test_chunked_attention_matches_jax(window, monkeypatch):
    """The plain version's query-chunk path (taken above the chunk
    threshold, lowered here to 64) against the JAX one, f32, atol 3e-5."""
    (qj, kj, vj), (qt, kt, vt) = _qkv(1, 4, 1, 100, 32, "float32", seed=4)
    want = jref.chunked_attention_ref(qj, kj, vj, window=window, chunk_q=32)
    got = tref.chunked_attention_ref(qt, kt, vt, window=window, chunk_q=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)
    monkeypatch.setattr(ops, "_CHUNK_THRESHOLD", 64)
    via_ops = ops.flash_attention(qt, kt, vt, window=window)
    np.testing.assert_allclose(via_ops.numpy(), np.asarray(want), atol=3e-5)


def test_attention_matches_flash_pallas_interpret():
    """One small case against the Pallas flash kernel itself (interpret
    mode), GQA with a window, f32, atol 3e-5."""
    (qj, kj, vj), (qt, kt, vt) = _qkv(1, 4, 1, 40, 32, "float32", seed=5)
    want = flash_attention_pallas(
        qj, kj, vj, causal=True, window=12, block_q=16, block_k=16, interpret=True
    )
    got = ops.flash_attention(qt, kt, vt, causal=True, window=12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


def test_attention_scale_override():
    (qj, _, _), (qt, _, _) = _qkv(1, 1, 1, 32, 16, "float32", seed=6)
    want = _jax_attention(qj, qj, qj, causal=True, scale=0.5)
    got = ops.flash_attention(qt, qt, qt, sm_scale=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)
