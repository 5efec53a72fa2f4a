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
    log_dequantize_pallas,
    log_dequantize_rows_pallas,
    log_quantize_pack_pallas,
    log_quantize_pallas,
    pack_nibbles_pallas,
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


def test_log_dequantize_rows_on_cpu_takes_the_plain_version(monkeypatch):
    """A CPU tensor never reaches the CUDA wrapper: q4 rows of 37 bytes (no
    multiple of 16) against the Pallas kernel, rtol 1e-6 / atol 1e-7."""

    def boom(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA wrapper")

    monkeypatch.setattr(ops, "log_dequantize_rows_cuda", boom)
    rng = np.random.default_rng(11)
    codes = rng.integers(-8, 8, size=(300, 74))
    packed = np.asarray(pack_nibbles(jnp.asarray(codes))).reshape(300, 37)
    scales = rng.uniform(0.0, 3.0, size=(300, 1)).astype(np.float32)
    want = log_dequantize_rows_pallas(
        jnp.asarray(packed), jnp.asarray(scales), bits=4, alpha=ALPHA
    )
    got = ops.log_dequantize_rows(
        torch.from_numpy(packed.copy()), torch.from_numpy(scales), bits=4
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


# ------------------------------------------------- #2 pack_nibbles, exact bytes
@pytest.mark.parametrize("numel", [1, 2, 7, 63, 100, 101, 1000, 4096])
def test_pack_nibbles_matches_pallas(numel):
    """Packed bytes equal (tolerance 0) over the sizes of the JAX codec
    tests, odd sizes packing a zero pad code."""
    codes = np.random.default_rng(numel).integers(-8, 8, size=numel).astype(np.int8)
    want = pack_nibbles_pallas(jnp.asarray(codes), interpret=True)
    got = ops.pack_nibbles(torch.from_numpy(codes.copy()))
    assert got.dtype == torch.int8 and tuple(got.shape) == ((numel + 1) // 2,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pack_nibbles_keeps_flat_order_of_any_shape():
    codes = np.random.default_rng(5).integers(-7, 8, size=(5, 3, 3, 7)).astype(np.int8)
    want = pack_nibbles_pallas(jnp.asarray(codes), interpret=True)
    got = ops.pack_nibbles(torch.from_numpy(codes.copy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------ #5 log_dequantize
def _mean_codes(shape, bits, n_workers, seed):
    """The f32 mean over workers of integer codes, as the paper's avg mode
    hands the expand."""
    lv = (1 << (bits - 1)) - 1
    rng = np.random.default_rng(seed)
    codes = rng.integers(-lv, lv + 1, size=(n_workers,) + shape)
    return jnp.mean(jnp.asarray(codes, jnp.float32), axis=0)


@pytest.mark.parametrize("shape", [(4608, 1), (7,), (3, 48, 16), (513, 7)])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("scale", [1.0, 0.37])
def test_log_dequantize_means_match_pallas(shape, bits, scale):
    """f32 mean codes in, rtol 1e-6 (f32 expm1 of the two math libraries
    may differ in the last ulp)."""
    mean = _mean_codes(shape, bits, 5, seed=bits)
    want = log_dequantize_pallas(mean, jnp.float32(scale), bits=bits, alpha=ALPHA)
    got = ops.log_dequantize(torch.from_numpy(np.array(mean)), scale, bits=bits)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("bits,dtype", [(4, np.int8), (8, np.int8), (12, np.int16)])
def test_log_dequantize_int_codes_match_pallas(bits, dtype):
    """Integer codes in (int8, or int16 above b = 8), rtol 1e-6."""
    lv = (1 << (bits - 1)) - 1
    codes = np.random.default_rng(bits).integers(-lv, lv + 1, size=(5, 512))
    codes = codes.astype(dtype)
    want = log_dequantize_pallas(jnp.asarray(codes), jnp.float32(1.0), bits=bits)
    got = ops.log_dequantize(torch.from_numpy(codes.copy()), bits=bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


def test_log_dequantize_inverts_log_quantize_on_the_grid():
    """expand(codes(x)) lands on the grid point of each code: codes of the
    expanded values are the codes again (exact)."""
    x = torch.from_numpy(np.linspace(-1.0, 1.0, 255, dtype=np.float32))
    codes = ops.log_quantize(x, 1.0, bits=8)
    again = ops.log_quantize(ops.log_dequantize(codes, bits=8), 1.0, bits=8)
    assert torch.equal(again, codes)


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


def _kernel_branch(monkeypatch):
    """Route CPU tensors to the kernel branch of every wrapper, as CUDA
    tensors outside ``reference_mode`` go."""
    monkeypatch.setattr(ops, "_plain", lambda t: False)


def _attention_inputs(requires_grad):
    g = torch.Generator().manual_seed(0)
    shapes = ((1, 4, 8, 32), (1, 1, 8, 32), (1, 1, 8, 32))
    return [torch.randn(s, generator=g).requires_grad_(requires_grad) for s in shapes]


def _ssd_inputs(requires_grad):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 2, 2, 4, 8), generator=g)
    a_cum = torch.randn((1, 2, 2, 4), generator=g).cumsum(-1)
    bm, cm = (torch.randn((1, 1, 2, 4, 16), generator=g) for _ in range(2))
    return [t.requires_grad_(requires_grad) for t in (x, a_cum, bm, cm)]


@pytest.mark.parametrize(
    "name, args, why",
    [
        ("flash_attention", _attention_inputs, "trains with the plain attention"),
        # the SSD kernel once refused naming the slice that would train
        # Mamba-2; that slice trains through the plain SSD, as this says now
        # (the case keeps its id)
        pytest.param(
            "ssd_chunk",
            _ssd_inputs,
            "Mamba-2 trains through the plain SSD",
            id="ssd_chunk-_ssd_inputs-item 14",
        ),
    ],
)
def test_kernel_branch_refuses_inputs_that_require_grad(monkeypatch, name, args, why):
    """The attention and SSD kernels have no backward: with grad mode on, an
    input that requires grad raises instead of coming back without a
    ``grad_fn``. Without grad the kernel branch goes on to launch (here it
    then refuses the CPU tensor)."""
    _kernel_branch(monkeypatch)
    wrapper = getattr(ops, name)
    with pytest.raises(RuntimeError, match=why):
        wrapper(*args(True))
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensor"):
        wrapper(*args(True))
    with pytest.raises(ValueError, match="CUDA tensor"):
        wrapper(*args(False))


@pytest.mark.parametrize(
    "name, args", [("flash_attention", _attention_inputs), ("ssd_chunk", _ssd_inputs)]
)
def test_plain_branch_keeps_autograd(name, args):
    inputs = args(True)
    out = getattr(ops, name)(*inputs)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out.sum(), inputs)
    assert all(g is not None and torch.isfinite(g).all() for g in grads)


def test_training_attention_takes_the_plain_version_on_the_kernel_branch(monkeypatch):
    """``plain=True`` (the training forward's) is the plain attention even
    where a tensor would launch the kernel, and keeps autograd."""
    _kernel_branch(monkeypatch)
    q, k, v = _attention_inputs(True)
    out = ops.flash_attention(q, k, v, plain=True)
    assert out.grad_fn is not None
    assert torch.equal(out, tref.attention_ref(q, k, v))
