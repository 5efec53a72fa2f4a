"""The port's randomized privacy codecs (``dlog``, ``lrq``) against the JAX
package's, the counterpart of ``tests/test_privacy_codecs.py``.

* Exact: the registry, spec parsing and validation messages; each codec's
  ``requires_key``, ``epsilon_kind``, ``privacy_sigma`` and
  ``epsilon_per_use`` over a grid of configs; the zero-noise configs'
  codes, bytes and ``codec_phase`` against the JAX ``log`` codec; the codes
  of the JAX package's own ``jax.random`` draws fed to the port's transform
  (``noised_codes``) at b 2, 4 and 8, with no code allowed to differ; the
  per-step epsilons (the compressor tests' tree, the 2-conv victim's 80.0 /
  240.0 / 428.977..., gemma3-1b at full width); the planner's privacy
  plans; ``_pareto_gate`` on ``BENCH_privacy.json``'s rows.
* Statistically, over generator draws (the port cannot replay
  ``jax.random``): unbiasedness, lrq's noise rising with its layers,
  dlog's noise std against ``gaussian_sigma``, each at a stated bound.
* The PRNG contract: deterministic codecs reject a generator and
  randomized ones demand one; the same seed gives the same bytes; the P,
  Q and raw streams differ; steps differ; zero noise syncs as the
  deterministic compressor; the composite's state has a ``key`` only
  when a group draws.
"""

import functools
import json
import math
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from benchmarks import gia_ssim as jax_bench
from repro.configs import get_config as jax_get_config
from repro.core import AxisComm
from repro.core import CompressorConfig as JaxCompressorConfig
from repro.core import codec as jcodec
from repro.core import make_compressor as jax_make_compressor
from repro.core.comm import CommRecord as JaxCommRecord
from repro.core.policy import plan_auto as jax_plan_auto
from repro.train import step as jax_step
from repro_torch.bench import gia_ssim as tbench
from repro_torch.configs import get_config
from repro_torch.core import codec as tcodec
from repro_torch.core.comm import CommRecord, SimComm
from repro_torch.core.compressors import (
    PHASE_STREAMS,
    CompressorConfig,
    LeafPolicy,
    leaf_seed,
    make_compressor,
)
from repro_torch.core.composite import CompositeCompressor
from repro_torch.core.policy import plan_auto
from repro_torch.core.privacy import GIAConfig, HarnessConfig, gaussian_sigma
from repro_torch.train.step import make_model_compressor

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 2
# the compressor tests' tree: a plain matrix, a bias, a stacked leaf
SHAPES = {"w": (64, 32), "b": (32,), "scan": (3, 48, 16)}
STACKED = {"w": False, "b": False, "scan": True}
# (k1)'s pin: the per-step epsilon of gemma3-1b at full width, LQ-SGD r1 b8,
# dp_epsilon 48 (dlog on every leaf: 2 x 48 a low-rank leaf, 48 a raw one)
GEMMA_EPS48_PER_STEP = 7056.0

CONFIGS = [
    ("dlog", {}),
    ("dlog", dict(bits=4, dp_epsilon=8.0)),
    ("dlog", dict(dither=False, dp_epsilon=16.0, dp_delta=1e-6)),
    ("dlog", dict(dither=False)),
    ("lrq", {}),
    ("lrq", dict(bits=4, n_layers=3)),
    ("lrq", dict(bits=6, n_layers=1)),
    ("lrq", dict(n_layers=1, dither=False)),
]
ZERO_NOISE = [("dlog", dict(dither=False)), ("lrq", dict(n_layers=1, dither=False))]


def _abstract():
    return {k: torch.empty(s, device="meta") for k, s in SHAPES.items()}


def _jax_abstract():
    return {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in SHAPES.items()}


def _grads(seed, n=N):
    rng = np.random.default_rng(seed)
    return {
        k: torch.from_numpy(rng.standard_normal((n,) + s).astype(np.float32))
        for k, s in SHAPES.items()
    }


# ------------------------------------------------------ registry, knobs
def test_spec_parsing_and_fields_match_jax():
    spec = "dlog:bits=4,dp_epsilon=8"
    got, want = tcodec.make_codec(spec), jcodec.make_codec(spec)
    assert isinstance(got, tcodec.DitheredLogQuantCodec)
    assert (got.bits, got.dp_epsilon, got.dither, got.dp_delta) == (
        want.bits,
        want.dp_epsilon,
        want.dither,
        want.dp_delta,
    )
    assert tcodec.make_codec("lrq:n_layers=2", n_layers=3).n_layers == 3
    assert tcodec.make_codec("lrq").codec_name == "lrq"


@pytest.mark.parametrize(
    "name,knobs",
    [
        ("dlog", dict(dp_epsilon=-1.0)),
        ("dlog", dict(dp_delta=0.0)),
        ("dlog", dict(dp_delta=1.5)),
        ("lrq", dict(n_layers=0)),
        ("lrq", dict(bits=8, n_layers=9)),
        ("lrq", dict(n_layers=2, dither=False)),
    ],
)
def test_validation_messages_match_jax(name, knobs):
    with pytest.raises(ValueError) as want:
        jcodec.make_codec(name, **knobs)
    with pytest.raises(ValueError) as got:
        tcodec.make_codec(name, **knobs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name,knobs", CONFIGS)
def test_privacy_contract_matches_jax(name, knobs):
    got, want = tcodec.make_codec(name, **knobs), jcodec.make_codec(name, **knobs)
    assert got.requires_key == want.requires_key
    assert got.epsilon_kind == want.epsilon_kind
    assert got.privacy_sigma() == want.privacy_sigma()
    for delta in (1e-5, 1e-7):
        assert got.epsilon_per_use(delta) == want.epsilon_per_use(delta)
    for numel in (1, 7, 256):
        assert got.wire_bits(numel) == want.wire_bits(numel)


# ------------------------------------------------ zero noise == log, exactly
@pytest.mark.parametrize("name,knobs", ZERO_NOISE, ids=["dlog0", "lrq0"])
@pytest.mark.parametrize("bits", [4, 8])
def test_zero_noise_codes_and_bytes_are_jax_logs(name, knobs, bits):
    x = (np.random.default_rng(3).standard_normal(257) * 0.3).astype(np.float32)
    zero = tcodec.make_codec(name, bits=bits, **knobs)
    assert not zero.requires_key and zero.privacy_sigma() == 0.0
    assert math.isinf(zero.epsilon_per_use()) and zero.epsilon_kind is None
    log = jcodec.make_codec("log", bits=bits)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(zero.encode(xt).numpy(), np.asarray(log.encode(x)))
    np.testing.assert_array_equal(zero.codes(xt).numpy(), np.asarray(log.codes(x)))


ZERO_NOISE_SHAPES = ((48, 16), (31,))


@functools.cache
def _jax_log_phase(fuse):
    """The JAX ``log`` b4 phase over 4 workers (jitted once a ``fuse``):
    the inputs, outputs and gathered arrays, as numpy."""
    rng = np.random.default_rng(11)
    xs = [rng.standard_normal((4,) + s).astype(np.float32) for s in ZERO_NOISE_SHAPES]

    class Recording(AxisComm):
        def all_gather(self, x):
            g = super().all_gather(x)
            self.log.append(g)
            return g

    def worker(a, b):
        comm = Recording(("data",))
        comm.log = []
        outs = jcodec.codec_phase(
            [a, b],
            [False, False],
            jcodec.make_codec("log", bits=4),
            comm,
            JaxCommRecord(),
            fuse=fuse,
        )
        return outs, comm.log

    phase = jax.jit(jax.vmap(worker, axis_name="data"))
    outs, log = phase(*map(jnp.asarray, xs))
    return xs, [np.asarray(o)[0] for o in outs], [np.asarray(g)[0] for g in log]


@pytest.mark.parametrize("name,knobs", ZERO_NOISE, ids=["dlog0", "lrq0"])
@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_zero_noise_codec_phase_is_jax_logs(name, knobs, fuse):
    """The whole phase (scale pmax, encode, gather, decode, average) of the
    noiseless randomized codecs on the port equals the JAX ``log`` phase:
    the gathered bytes exactly, the outputs within 1e-6."""
    xs, want, want_log = _jax_log_phase(fuse)
    comm = SimComm(4, record=True)
    got = tcodec.codec_phase(
        [torch.from_numpy(x) for x in xs],
        [False, False],
        tcodec.make_codec(name, bits=4, **knobs),
        comm,
        CommRecord(),
        fuse=fuse,
    )
    assert len(comm.gathered) == len(want_log) == (1 if fuse else 2)
    for g, w in zip(comm.gathered, want_log):
        np.testing.assert_array_equal(g.numpy(), w)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)


# ------------------------------------ the JAX draws through the port's transform
def _jax_draws(name, knobs, key, shape):
    """The draws the JAX codec takes from ``key``, as numpy (None where the
    codec takes none): ``(noise, u, layer)``."""
    first, second = jax.random.split(key)
    noise = layer = None
    if name == "dlog":
        if knobs.get("dp_epsilon", 0.0) > 0:
            noise = np.asarray(jax.random.normal(first, shape))
        u = None
        if knobs.get("dither", True):
            u = np.asarray(jax.random.uniform(second, shape))
    else:
        n_layers = knobs.get("n_layers", 2)
        if n_layers > 1:
            layer = np.asarray(jax.random.randint(first, shape, 0, n_layers))
        u = np.asarray(jax.random.uniform(second, shape))
    return noise, u, layer


DRAWN = [
    ("dlog", dict(dp_epsilon=16.0), bits)
    for bits in (2, 4, 8)
] + [
    ("dlog", {}, 4),
    ("dlog", dict(dither=False, dp_epsilon=16.0), 4),
    ("lrq", dict(n_layers=1), 2),
    ("lrq", dict(n_layers=3), 4),
    ("lrq", dict(n_layers=2), 8),
    ("lrq", dict(n_layers=7), 8),
]


@pytest.mark.parametrize("name,knobs,bits", DRAWN)
def test_codes_from_jax_draws_equal_jax_codes(name, knobs, bits):
    """The port's transform of the JAX package's own draws gives the JAX
    codes exactly: no bin-edge flip is allowed (none occurs at these seeds;
    the transform is the JAX arithmetic op for op)."""
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal(4096) * 0.4).clip(-1, 1).astype(np.float32)
    key = jax.random.PRNGKey(7 * bits + len(knobs))
    want = jcodec.make_codec(name, bits=bits, **knobs).codes(x, key=key)
    draws = _jax_draws(name, knobs, key, x.shape)
    draws = [None if d is None else torch.tensor(d) for d in draws]
    codec = tcodec.make_codec(name, bits=bits, **knobs)
    got = codec.noised_codes(torch.from_numpy(x), *draws)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------- per-step epsilons
@pytest.mark.parametrize(
    "knobs",
    [
        dict(dp_epsilon=8.0),
        dict(dp_epsilon=8.0, bits=4, fuse_collectives=True),
        dict(codec="lrq"),
        dict(codec="lrq", lrq_layers=5),
        dict(codec="dlog"),
        dict(codec="log"),
    ],
)
def test_epsilon_per_step_and_bits_match_jax(knobs):
    cfg = dict(name="lq_sgd", rank=1, **knobs)
    comp = make_compressor(CompressorConfig(**cfg), _abstract(), STACKED)
    jcomp = jax_make_compressor(JaxCompressorConfig(**cfg), _jax_abstract(), STACKED)
    assert isinstance(comp, CompositeCompressor)
    for delta in (1e-5, 1e-6):
        got = comp.privacy_epsilon_per_step(delta)
        assert got == jcomp.privacy_epsilon_per_step(delta)
    assert comp.wire_bits_per_step() == jcomp.wire_bits_per_step()


@pytest.mark.parametrize(
    "knobs, want",
    [
        (dict(), ()),
        (dict(codec="log"), ()),
        (dict(dp_epsilon=8.0), ("calibrated",)),
        (dict(codec="lrq"), ("gaussian_equiv",)),
    ],
)
def test_privacy_epsilon_kinds(knobs, want):
    """The compressor names the kinds of its leaves' epsilon claims (what
    the launcher prints beside ``epsilon/step=``)."""
    cfg = CompressorConfig(name="lq_sgd", rank=1, **knobs)
    comp = make_compressor(cfg, _abstract(), STACKED)
    assert comp.privacy_epsilon_kinds() == want


def test_pareto_methods_spend_the_jax_epsilons():
    """The Pareto sweep's rows on the 2-conv victim: the JAX benchmark's
    methods and per-step epsilons (80.0, 240.0, 428.977...), within 1e-9."""
    victim = tbench.setup("cnn", "cpu")
    abstract = {
        k: torch.empty(p.shape, device="meta") for k, p in victim["params"].items()
    }
    jabstract = {
        k: jax.ShapeDtypeStruct(tuple(p.shape), jnp.float32)
        for k, p in victim["params"].items()
    }
    methods, meta = tbench._pareto_methods(abstract)
    jmethods, jmeta = jax_bench._pareto_methods(jabstract)
    assert list(methods) == list(jmethods)
    for name, want in jmeta.items():
        got = meta[name]
        assert {k: v for k, v in got.items() if k not in ("epsilon", "sigma_norm")} == {
            k: v for k, v in want.items() if k not in ("epsilon", "sigma_norm")
        }
        if want["epsilon"] is not None:
            assert abs(got["epsilon"] - want["epsilon"]) <= 1e-9
        if "sigma_norm" in want:
            assert abs(got["sigma_norm"] - want["sigma_norm"]) <= 1e-12
    bench = json.loads((ROOT / "BENCH_privacy.json").read_text())["pareto"]
    for row in bench["rows"]:
        if row["epsilon"] is not None:
            assert abs(meta[row["method"]]["epsilon"] - row["epsilon"]) <= 1e-9
    for name in ("lq_dlog_eps16", "lq_dlog_eps48", "lq_lrq", "lq_det"):
        comp = make_compressor(methods[name], abstract)
        assert comp.wire_bits_per_step() == bench["wire_bits"] == 2056


def test_gemma3_full_width_epsilon_is_the_jax_figure():
    """gemma3-1b at full width on abstract shapes, LQ-SGD r1 b8 at dp_epsilon
    48: the per-step epsilon (chip_smoke (k1)'s pin) and the wire bits
    ((j1)'s 9,236,960: dlog's wire is log's) equal the JAX package's."""
    cfg = dict(name="lq_sgd", rank=1, bits=8, dp_epsilon=48.0)
    jcomp = jax_step.make_model_compressor(
        jax_get_config("gemma3-1b"), JaxCompressorConfig(**cfg)
    )
    comp = make_model_compressor(get_config("gemma3-1b"), CompressorConfig(**cfg))
    got = comp.privacy_epsilon_per_step(1e-5)
    assert got == jcomp.privacy_epsilon_per_step(1e-5) == GEMMA_EPS48_PER_STEP
    assert comp.wire_bits_per_step() == jcomp.wire_bits_per_step() == 9_236_960


# -------------------------------------------------------------- the planner
@pytest.mark.parametrize(
    "knobs",
    [dict(dp_epsilon=64.0), dict(dp_epsilon=8.0), dict(codec="lrq", lrq_layers=3)],
    ids=["eps64", "eps8", "lrq3"],
)
def test_privacy_plan_equals_the_jax_planner(knobs):
    opts = dict(ranks=(1, 2), bits_options=(4, 8), topk_ratios=(0.01,), qsgd_bits=(8,))
    cfg = dict(name="lq_sgd", policy="auto", **knobs)
    pols, rep = plan_auto(_abstract(), STACKED, cfg=CompressorConfig(**cfg), **opts)
    jpols, jrep = jax_plan_auto(
        _jax_abstract(), STACKED, cfg=JaxCompressorConfig(**cfg), **opts
    )
    for p, j in zip(pols, jpols, strict=True):
        for field in ("method", "rank", "bits", "codec", "dp_epsilon", "topk_ratio"):
            assert getattr(p, field) == getattr(j, field), field
    for r, j in zip(rep, jrep, strict=True):
        for field in ("path", "method", "codec", "epsilon", "wire_bits", "raw_bits"):
            assert r[field] == j[field], field
        assert r["est_err"] == pytest.approx(j["est_err"], rel=1e-12)
    if knobs.get("dp_epsilon") == 64.0:  # sigma ~0.15 fits the default budget
        assert any(r["codec"] == "dlog" and r["epsilon"] == 64.0 for r in rep)
    if knobs.get("dp_epsilon") == 8.0:  # sigma ~1.2: no lq_sgd candidate fits
        assert all(r["epsilon"] is None and r["method"] != "lq_sgd" for r in rep)


def test_pareto_gate_returns_the_committed_gate():
    pareto = json.loads((ROOT / "BENCH_privacy.json").read_text())["pareto"]
    assert tbench._pareto_gate(pareto["rows"]) == pareto["gate"]
    assert tbench._pareto_gate(pareto["rows"]) == jax_bench._pareto_gate(pareto["rows"])
    tampered = [dict(r, epsilon=None) for r in pareto["rows"]]
    assert not tbench._pareto_gate(tampered)["passed"]


def test_pareto_bench_runs_on_the_cpu():
    """A cut Pareto sweep on the CPU: the rows carry ``BENCH_privacy.json``'s
    fields, its wire bits and epsilons, and the gate runs on them."""
    cfg = HarnessConfig(
        train_steps=2,
        attack_steps=(1,),
        n_attack_seeds=2,
        gia=GIAConfig(steps=2, lr=0.05, tv_coef=5e-3),
    )
    got = tbench._pareto_bench(device="cpu", cfg=cfg)
    want = json.loads((ROOT / "BENCH_privacy.json").read_text())["pareto"]
    assert set(got) == set(want)
    assert [r["method"] for r in got["rows"]] == [r["method"] for r in want["rows"]]
    for g, w in zip(got["rows"], want["rows"]):
        assert set(g) == set(w)
        assert (g["wire_bits"], g["codec"], g["matched_to"]) == (
            w["wire_bits"],
            w["codec"],
            w["matched_to"],
        )
        assert (g["epsilon"] is None) == (w["epsilon"] is None)
        assert math.isfinite(g["final_loss"])
    assert set(got["gate"]) == set(want["gate"])


# ------------------------------------------------------------ statistically
def _mean_expand(codec, x, draws, seed=7):
    """The mean over ``draws`` independent encodes of expand(codes(x)): one
    generator draws every row of a (draws, n) tensor."""
    gen = torch.Generator().manual_seed(seed)
    rows = x.expand(draws, -1)
    return codec.expand(codec.codes(rows, key=gen).float()).mean(0)


@pytest.mark.parametrize("bits", [4, 8])
def test_dlog_dither_is_unbiased(bits):
    """E over generators of expand(codes(x)) = x (the value domain). With
    3000 draws the mean's std is at most (largest step) / (2 sqrt(3000)),
    0.0045 at b = 4; the bound 0.02 is the JAX test's, 4.4 of those stds."""
    x = torch.linspace(-0.9, 0.9, 41)
    mean = _mean_expand(tcodec.make_codec("dlog", bits=bits), x, 3000)
    np.testing.assert_allclose(mean.numpy(), x.numpy(), atol=0.02)


@pytest.mark.parametrize("n_layers", [1, 2, 3])
def test_lrq_is_unbiased(n_layers):
    """The layer mixture stays unbiased (each layer's rounding is); bound
    0.04 over 4000 draws, the JAX test's."""
    x = torch.linspace(-0.85, 0.85, 35)
    codec = tcodec.make_codec("lrq", bits=6, n_layers=n_layers)
    np.testing.assert_allclose(_mean_expand(codec, x, 4000).numpy(), x, atol=0.04)


def test_lrq_noise_rises_with_layers():
    """The declared sigma and the measured spread of expand(codes(x)) - x
    both rise with the layers (4000 draws of 35 values: each variance has a
    relative std of ~0.4%, far below the 2x steps between layer counts)."""
    x = torch.linspace(-0.85, 0.85, 35)
    spread = []
    for n_layers in (1, 2, 3):
        codec = tcodec.make_codec("lrq", bits=6, n_layers=n_layers)
        rows = x.expand(4000, -1)
        out = codec.expand(codec.codes(rows, key=torch.Generator().manual_seed(1)))
        spread.append(float(((out - rows) ** 2).mean()))
    assert spread[0] < spread[1] < spread[2]
    codecs = [tcodec.make_codec("lrq", bits=8, n_layers=n) for n in (1, 2, 3)]
    sig = [c.privacy_sigma() for c in codecs]
    assert sig[0] < sig[1] < sig[2]


def test_dlog_noise_has_the_calibrated_std():
    """At x = 0.3, b = 8 and dp_epsilon 64 (sigma = gaussian_sigma(64, 1e-5)
    = 0.0757, no saturation within 9 sigma), expand(codes) - x over 20000
    draws has std sqrt(sigma^2 + dither), the dither's part below 0.0038
    (half a level step there): within 3% of sigma, where the sample std's
    own relative std is 0.5%."""
    codec = tcodec.make_codec("dlog", bits=8, dp_epsilon=64.0)
    sigma = gaussian_sigma(64.0, 1e-5)
    assert codec.privacy_sigma() == sigma
    x = torch.full((20000,), 0.3)
    out = codec.expand(codec.codes(x, key=torch.Generator().manual_seed(3)))
    std = float((out - x).std())
    assert abs(std / sigma - 1) < 0.03
    assert abs(float((out - x).mean())) < 4 * sigma / 20000**0.5


# ------------------------------------------------------- the PRNG contract
@pytest.mark.parametrize(
    "spec", ["float32", "log", "dlog:dither=False", "lrq:n_layers=1,dither=False"]
)
def test_deterministic_codecs_reject_a_generator(spec):
    codec = tcodec.make_codec(spec)
    with pytest.raises(ValueError, match="rejects a generator"):
        codec.codes(torch.zeros(4), key=torch.Generator())
    with pytest.raises(ValueError, match="rejects a generator"):
        codec.encode(torch.zeros(4), key=torch.Generator())


@pytest.mark.parametrize(
    "spec", ["qsgd", "dlog", "dlog:dither=False,dp_epsilon=4", "lrq"]
)
def test_randomized_codecs_demand_a_generator(spec):
    codec = tcodec.make_codec(spec)
    with pytest.raises(ValueError, match="needs a generator"):
        codec.codes(torch.zeros(4))
    with pytest.raises(ValueError, match="needs a generator"):
        codec.encode(torch.zeros(4))


@pytest.mark.parametrize(
    "spec", ["dlog:bits=4,dp_epsilon=8", "dlog:bits=8,dp_epsilon=8", "lrq:bits=4"]
)
def test_same_seed_same_bytes_other_seed_other_bytes(spec):
    x = np.random.default_rng(5).standard_normal(513).astype(np.float32)
    x = torch.from_numpy(x) * 0.4
    codec = tcodec.make_codec(spec)

    def enc(seed):
        return codec.encode(x, key=torch.Generator().manual_seed(seed))

    assert torch.equal(enc(1), enc(1))
    assert not torch.equal(enc(1), enc(2))
    assert enc(1).numel() * 8 == codec.wire_bits(x.numel())


def test_randomized_pad_code_is_zero():
    """An odd b <= 4 row is padded with the zero code, as the per-worker
    pack pads it, whatever dlog's noise would draw for a zero value."""
    x = torch.full((N, 7), 0.5)
    comm = SimComm(N, record=True)
    codec = tcodec.make_codec("dlog", bits=4, dp_epsilon=1.0)
    gen = torch.Generator().manual_seed(0)
    tcodec.codec_phase([x], [False], codec, comm, CommRecord(), keys=[gen])
    (wire,) = comm.gathered
    assert wire.shape == (N, 4)
    assert torch.all((wire[:, -1].to(torch.int32) >> 4) & 0xF == 0)


def test_phase_streams_differ_and_avoid_qsgd():
    assert sorted(PHASE_STREAMS) == ["p", "q", "raw"]
    assert 0 not in PHASE_STREAMS.values()  # QSGD's stream
    seeds = {leaf_seed(42, 3, 1, stream=s) for s in (0, *PHASE_STREAMS.values())}
    assert len(seeds) == 4


def _sync(cfg, grads, state=None, seed=42):
    comp = make_compressor(cfg, _abstract(), STACKED)
    state = comp.init_state(seed, N, "cpu") if state is None else state
    out, state, rec = comp.sync(grads, state, SimComm(N))
    return comp, out, state, rec


def test_randomized_sync_differs_by_step_and_zero_noise_is_deterministic():
    """Through the composite: a dlog run draws anew each step (the state's
    step counter seeds the generators) and the same seed redraws the same
    bits; ``codec='log'`` (zero noise) syncs bit for bit as the dedicated
    deterministic compressor, with no key in its state."""
    grads = _grads(1)
    dp = CompressorConfig(name="lq_sgd", dp_epsilon=8.0)
    comp, d1, state, rec = _sync(dp, grads)
    assert state["key"] == 42 and state["step"] == 1
    _, d2, _, _ = _sync(dp, grads, state)
    _, again, _, _ = _sync(dp, grads)
    assert not torch.equal(d1["w"], d2["w"])
    assert all(torch.equal(d1[k], again[k]) for k in SHAPES)
    assert rec.effective_bits() == comp.wire_bits_per_step()
    plain = make_compressor(CompressorConfig(name="lq_sgd"), _abstract(), STACKED)
    assert not isinstance(plain, CompositeCompressor)
    want, _, _ = plain.sync(grads, plain.init_state(42, N, "cpu"), SimComm(N))
    _, got, zstate, _ = _sync(CompressorConfig(name="lq_sgd", codec="log"), grads)
    assert "key" not in zstate
    assert all(torch.equal(got[k], want[k]) for k in SHAPES)
    assert not torch.equal(d1["w"], want["w"])


def test_composite_state_has_a_key_only_when_a_group_draws():
    lazy = CompressorConfig(name="lq_sgd", lazy_thresh=0.1)
    det = make_compressor(lazy, _abstract(), STACKED)
    assert "key" not in det.init_state(0, N, "cpu")
    for knobs in (dict(dp_epsilon=8.0), dict(codec="lrq")):
        cfg = CompressorConfig(name="lq_sgd", **knobs)
        rnd = make_compressor(cfg, _abstract(), STACKED)
        assert rnd.init_state(5, N, "cpu")["key"] == 5
        assert "dlog, lrq" in rnd.graph_refusal()
    # a per-leaf policy: only the bias draws, and the group still needs a key
    pol = lambda path, leaf: LeafPolicy(codec="lrq" if path == "['b']" else None)
    mixed = CompositeCompressor(
        CompressorConfig(name="lq_sgd"), _abstract(), STACKED, policies=pol
    )
    assert mixed.init_state(3, N, "cpu")["key"] == 3


def test_p_q_and_raw_phases_draw_from_their_own_streams(monkeypatch):
    """Every generator a randomized LQ-SGD sync makes is a leaf's P, Q or raw
    stream at the state's step, one for each (leaf, phase)."""
    from repro_torch.core import powersgd

    made = []
    real = powersgd.leaf_generator

    def spy(seed, step, leaf, device, *, stream=0):
        made.append((seed, step, leaf, stream))
        return real(seed, step, leaf, device, stream=stream)

    monkeypatch.setattr(powersgd, "leaf_generator", spy)
    comp, _, state, _ = _sync(CompressorConfig(name="lq_sgd", codec="lrq"), _grads(2))
    _sync(CompressorConfig(name="lq_sgd", codec="lrq"), _grads(2), state)
    lowrank = [i for i, pl in enumerate(comp.plans) if pl.route == "lowrank"]
    raw = [i for i, pl in enumerate(comp.plans) if pl.route != "lowrank"]
    want = set()
    for step in (0, 1):
        want |= {(42, step, i, PHASE_STREAMS[ph]) for i in lowrank for ph in ("p", "q")}
        want |= {(42, step, i, PHASE_STREAMS["raw"]) for i in raw}
    # stream 0 is the warm-start Q's draw at init
    assert sorted(m for m in made if m[3] != 0) == sorted(want)
