"""The port's wire-codec layer against the JAX package's.

``codec_phase`` runs on N = 2 workers both ways: the JAX function under
``jax.vmap(axis_name=...)`` with a comm that records every gathered array,
the port's on a leading worker dim through ``SimComm(record=True)``. Inputs
come from numpy with fixed seeds. Held exact: every gathered wire array
(byte for byte), ``CommRecord`` bits and collective counts. Held within a
tolerance: the synced outputs (rtol 1e-6, atol 1e-6 x the largest scale),
where the f32 ``expm1`` of the two math libraries may differ in the last
ulp and the dequant-then-mean path sums in another order.
"""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import codec as jcodec
from repro.core import quantization as jquant
from repro.core.comm import AxisComm
from repro.core.comm import CommRecord as JaxCommRecord
from repro_torch.core import codec as tcodec
from repro_torch.core import quantization as tquant
from repro_torch.core.comm import CommRecord, SimComm

N = 2


class _RecordingComm(AxisComm):
    """The JAX comm, keeping each gathered array (fused: its flat buffer)."""

    def __init__(self, names):
        super().__init__(names)
        self.log = []

    def all_gather(self, x):
        g = super().all_gather(x)
        self.log.append(g)
        return g


def _leaves(seed):
    """A plain leaf, a stacked (L=3) leaf, and an odd-sized one (b <= 4 pads)."""
    rng = np.random.default_rng(seed)
    shapes = [(N, 33), (N, 3, 16, 5), (N, 7, 1)]
    return [(rng.standard_normal(s) * 2).astype(np.float32) for s in shapes]


FLAGS = [False, True, False]


def _jax_phase(xs, codec, **kw):
    recs = []

    def worker(*xs_w):
        comm = _RecordingComm(("data",))
        rec = JaxCommRecord()
        outs = jcodec.codec_phase(list(xs_w), FLAGS, codec, comm, rec, **kw)
        recs.append(rec)
        return outs, comm.log

    outs, log = jax.vmap(worker, axis_name="data")(*[jnp.asarray(x) for x in xs])
    return [np.asarray(o[0]) for o in outs], [np.asarray(g[0]) for g in log], recs[0]


def _port_phase(xs, codec, **kw):
    comm = SimComm(N, record=True)
    rec = CommRecord()
    outs = tcodec.codec_phase(
        [torch.from_numpy(x.copy()) for x in xs], FLAGS, codec, comm, rec, **kw
    )
    return [o.numpy() for o in outs], [g.numpy() for g in comm.gathered], rec


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("wire", ["allgather_codes", "psum_sim"])
@pytest.mark.parametrize("avg_mode", ["paper", "dequant_then_mean"])
def test_codec_phase_matches_jax(avg_mode, wire, fuse, bits):
    xs = _leaves(seed=bits)
    kw = dict(avg_mode=avg_mode, wire=wire, fuse=fuse)
    want, want_log, want_rec = _jax_phase(
        xs, jcodec.LogQuantCodec(bits=bits, alpha=10.0), **kw
    )
    got, got_log, got_rec = _port_phase(
        xs, tcodec.make_codec("log", bits=bits, alpha=10.0), **kw
    )
    assert len(got_log) == len(want_log) == (0 if wire == "psum_sim" else 1 if fuse else 3)
    for g, w in zip(got_log, want_log):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got_rec.bits_sent == want_rec.bits_sent
    assert got_rec.n_collectives == want_rec.n_collectives
    atol = 1e-6 * max(float(np.abs(x).max()) for x in xs)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=atol)


@pytest.mark.parametrize("fuse", [False, True])
def test_float32_phase_and_sparse_accounting_match_jax(fuse):
    """The f32 wire (PowerSGD factors, TopK's dense stand-in): no scale
    collectives, and ``account_bits`` overriding the payload."""
    xs = _leaves(seed=3)
    kw = dict(fuse=fuse, account_bits=[100, 200, 300])
    want, want_log, want_rec = _jax_phase(xs, jcodec.Float32Codec(), **kw)
    got, got_log, got_rec = _port_phase(xs, tcodec.make_codec("float32"), **kw)
    for g, w in zip(got_log, want_log):
        np.testing.assert_array_equal(g, w)
    assert (got_rec.bits_sent, got_rec.n_collectives) == (
        want_rec.bits_sent,
        want_rec.n_collectives,
    )
    assert got_rec.bits_sent == 600
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- the registry
def test_registry_lists_the_ported_codecs():
    want = ("dlog", "float32", "log", "lrq", "qsgd")
    assert tcodec.available_codecs() == jcodec.available_codecs() == want


def test_make_codec_parses_inline_knobs_and_keywords_win():
    c = tcodec.make_codec("log:bits=4,alpha=5.0")
    assert c == tcodec.LogQuantCodec(bits=4, alpha=5.0)
    assert tcodec.make_codec("log:bits=4", bits=8).bits == 8
    assert tcodec.make_codec("qsgd:bits=4").codec_name == "qsgd"


@pytest.mark.parametrize(
    "spec,match",
    [("nope", "unknown codec"), ("log:beta=1", "does not accept"), ("log:bits", "bad")],
)
def test_make_codec_rejects_bad_specs(spec, match):
    with pytest.raises(ValueError, match=match):
        tcodec.make_codec(spec)


def test_prng_contract():
    x = torch.linspace(-1, 1, 16)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="needs a generator"):
        tcodec.make_codec("qsgd").codes(x)
    with pytest.raises(ValueError, match="rejects a generator"):
        tcodec.make_codec("log").codes(x, key=gen)
    assert tcodec.QSGDCodec.requires_key and not tcodec.LogQuantCodec.requires_key


# ------------------------------------------------------------------- QSGD
@pytest.mark.parametrize("bits", [4, 8])
def test_qsgd_codec_is_unbiased_over_draws(bits):
    """Statistical: the mean of expand(codes(x)) over 400 draws is within
    4 standard errors of x everywhere (each code's rounding noise is at
    most a half step, so its std is <= 1 / (2 L))."""
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, 256).astype(np.float32))
    codec = tcodec.make_codec("qsgd", bits=bits)
    gen = torch.Generator().manual_seed(123)
    draws = torch.stack([codec.expand(codec.codes(x, key=gen)) for _ in range(400)])
    se = 1.0 / (2 * codec.levels) / 400**0.5
    assert float((draws.mean(0) - x).abs().max()) < 4 * se


@pytest.mark.parametrize("numel", [7, 100])
def test_qsgd_wire_is_packed_and_reproducible(numel):
    """b = 4 codes nibble-packed: bytes = wire_bits / 8 exactly, same as the
    JAX codec's accounting; the same generator seed gives the same bytes."""
    x = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, numel).astype(np.float32))
    codec = tcodec.make_codec("qsgd", bits=4)
    w1 = codec.encode(x, key=torch.Generator().manual_seed(9))
    w2 = codec.encode(x, key=torch.Generator().manual_seed(9))
    assert torch.equal(w1, w2) and w1.dtype == torch.int8
    assert w1.numel() * 8 == codec.wire_bits(numel) == jcodec.QSGDCodec(4).wire_bits(numel)
    codes = codec.decode(w1, numel)
    assert float(codes.abs().max()) <= codec.levels


# ----------------------------------------------------- comm contracts
def test_fused_all_gather_rejects_mixed_dtypes():
    comm = SimComm(N)
    with pytest.raises(ValueError, match="single dtype"):
        comm.fused_all_gather([torch.ones(N, 4, dtype=torch.int8), torch.ones(N, 4)])


def test_fused_pmax_is_f32_only_and_keeps_shapes():
    comm = SimComm(N)
    with pytest.raises(ValueError, match="float32"):
        comm.fused_pmax([torch.ones(N, 4), torch.ones(N, 4, dtype=torch.bfloat16)])
    a = torch.arange(8.0).reshape(N, 4)
    b = torch.arange(6.0).reshape(N, 3, 1)
    ma, mb = comm.fused_pmax([a, b])
    assert torch.equal(ma, torch.tensor([4.0, 5, 6, 7]))
    assert mb.shape == (3, 1) and torch.equal(mb.reshape(-1), torch.tensor([3.0, 4, 5]))


def test_gated_accounting_names_its_slice():
    """The gated tier: an eager record stays Python ints; a gate charges
    its payload where it fired, as an f32 tensor, folded into the
    effective counts."""
    rec = CommRecord()
    rec.add(100, 2)
    assert (rec.effective_bits(), rec.effective_collectives()) == (100, 2)
    assert isinstance(rec.effective_bits(), int)
    rec.add_gated(8, 1, torch.tensor(True))
    rec.add_gated(16, 3, torch.tensor(False))
    rec.add_gated(40, 0, torch.tensor(0.25))
    bits, colls = rec.effective_bits(), rec.effective_collectives()
    assert bits.dtype == torch.float32 and float(bits) == 100 + 8 + 10
    assert float(colls) == 3 and rec.bits_sent == 100


# ------------------------------------------------ quantization with scales
@pytest.mark.parametrize("bits", [4, 8, 12])
def test_quantize_with_scale_matches_jax(bits):
    """Codes and scale exact; the round trip within rtol 1e-6."""
    x = (np.random.default_rng(bits).standard_normal((40, 9)) * 3).astype(np.float32)
    jcfg, tcfg = jquant.LogQuantConfig(bits=bits), tquant.LogQuantConfig(bits=bits)
    jc, js = jquant.quantize_with_scale(jnp.asarray(x), jcfg)
    tc, ts = tquant.quantize_with_scale(torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert float(ts) == float(js)
    np.testing.assert_allclose(
        tquant.roundtrip(torch.from_numpy(x), tcfg).numpy(),
        np.asarray(jquant.roundtrip(jnp.asarray(x), jcfg)),
        rtol=1e-6,
        atol=1e-7,
    )


def test_quantize_with_a_given_scale_and_all_zeros():
    cfg = tquant.LogQuantConfig(bits=8)
    codes, scale = tquant.quantize_with_scale(torch.zeros(5), cfg)
    assert float(scale) == 0.0 and not bool(codes.any())
    x = torch.tensor([0.5, -1.0, 2.0])
    codes, scale = tquant.quantize_with_scale(x, cfg, scale=torch.tensor(4.0))
    want = jquant.quantize_with_scale(jnp.asarray(x.numpy()), jquant.LogQuantConfig(), jnp.float32(4.0))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want[0]))
    back = tquant.dequantize_with_scale(codes, scale, cfg)
    np.testing.assert_allclose(back.numpy(), x.numpy(), rtol=0.05)
