"""The port's serving slice against the JAX package, on gemma3-1b smoke (f32).

Weights are the JAX package's seeded init, carried across with
``params_from_jax``; prompts come from numpy. Greedy tokens must be equal
(the port cannot reproduce ``jax.random``, so sampling parity is greedy
only); cache codes and scales equal byte for byte where both sides quantize
the same values; bytes/token equal the wire accounting exactly.
"""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models.model import init_params as jax_init_params
from repro.serving import engine as jengine
from repro.serving import kv_cache as jkv
from repro_torch.configs import get_config
from repro_torch.serving import engine as tengine
from repro_torch.serving import kv_cache as tkv
from repro_torch.weights import params_from_jax

BITS = [0, 8, 4]
_JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("gemma3-1b", smoke=True)
    tcfg = get_config("gemma3-1b", smoke=True)
    pj = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    pt = params_from_jax(pj, tcfg, device="cpu")
    return jcfg, tcfg, pj, pt


def _qcfgs(bits):
    if not bits:
        return None, None
    return jkv.CacheQuantConfig(bits=bits), tkv.CacheQuantConfig(bits=bits)


def _prompts(vocab, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def test_params_from_jax_round_trip(models):
    """Every leaf arrives unchanged; prefill last-position logits within
    atol 1e-4 (f32 matmuls sum in other orders)."""
    jcfg, tcfg, pj, pt = models
    assert torch.equal(pt["embed"], torch.from_numpy(pj["embed"].copy()))
    for r in range(tcfg.repeats):
        for pos in range(len(tcfg.pattern)):
            layer = pt["layers"][r * len(tcfg.pattern) + pos]
            want = pj["scan"][pos]["mixer"]["wq"][r]
            assert torch.equal(layer["mixer"]["wq"], torch.from_numpy(want.copy()))
    tok = _prompts(tcfg.vocab_size, 2, 12)
    jpre = jax.jit(jengine.build_prefill_step(jcfg, 24, cache_dtype=jnp.float32))
    want, _ = jpre(pj, jnp.asarray(tok, jnp.int32))
    tpre = tengine.build_prefill_step(tcfg, 24, cache_dtype=torch.float32)
    got, _ = tpre(pt, torch.from_numpy(tok))
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("bits", BITS)
def test_greedy_tokens_equal_jax(models, bits):
    """Prefill then 8 greedy decode steps: the same tokens, raw or
    log-quantized (q8, q4) cache."""
    jcfg, tcfg, pj, pt = models
    qj, qt = _qcfgs(bits)
    tok = _prompts(tcfg.vocab_size, 2, 12, seed=2)
    n = 8
    jpre = jax.jit(
        jengine.build_prefill_step(jcfg, 24, cache_dtype=jnp.bfloat16, qcfg=qj)
    )
    jgen = jax.jit(jengine.build_generate_fn(jcfg), static_argnums=5)
    logits, caches = jpre(pj, jnp.asarray(tok, jnp.int32))
    first = jengine.greedy_sample(logits)
    _, _, _, sampled = jgen(pj, caches, first, jnp.int32(12), jax.random.PRNGKey(0), n)
    want = np.concatenate([np.asarray(first), np.asarray(sampled)], axis=1)

    tpre = tengine.build_prefill_step(tcfg, 24, cache_dtype=torch.bfloat16, qcfg=qt)
    tgen = tengine.build_generate_fn(tcfg)
    logits, caches = tpre(pt, torch.from_numpy(tok))
    assert tkv.tree_is_quantized(caches) == bool(bits)
    first = tengine.greedy_sample(logits)
    _, _, _, sampled = tgen(pt, caches, first, 12, None, n)
    got = torch.cat([first, sampled], dim=1).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize(
    "shape",
    [(2, 2, 16, 8), (3, 2, 2, 16, 8), (2, 1, 11, 7)],  # plain, stacked scan, odd S/d
)
def test_quantize_kv_byte_equal_to_jax(bits, shape):
    """Codes and scales equal byte for byte; dequant within rtol 1e-6."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    x[0, 0] = 0.0  # all-zero rows: scale 0, codes 0
    qj = jax.jit(jkv.quantize_kv, static_argnums=1)(jnp.asarray(x), bits)
    qt = tkv.quantize_kv(torch.from_numpy(x), bits)
    assert qt.codes.dtype == torch.int8
    assert tuple(qt.codes.shape) == shape[:-1] + (tkv.row_bytes(shape[-1], bits),)
    np.testing.assert_array_equal(qt.codes.numpy(), np.asarray(qj.codes))
    np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(qj.scale))
    np.testing.assert_allclose(
        tkv.dequantize_kv(qt).numpy(),
        np.asarray(jax.jit(jkv.dequantize_kv)(qj)),
        rtol=1e-6,
        atol=1e-7,
    )


@pytest.mark.parametrize("bits", [8, 4])
def test_prefill_quantizes_the_whole_padded_cache(models, bits):
    """Prefill stores every max_seq row: positions past the prompt are zero
    rows with scale 0 and code 0, as in the JAX package. The prompt rows'
    codes match JAX's up to a one-step flip where a value sits within an
    ulp of a bin edge (f32 K/V of the two frameworks differ in the last
    bits); scales within rtol 1e-5."""
    jcfg, tcfg, pj, pt = models
    qj, qt = _qcfgs(bits)
    tok = _prompts(tcfg.vocab_size, 2, 10, seed=3)
    jpre = jax.jit(
        jengine.build_prefill_step(jcfg, 24, cache_dtype=jnp.float32, qcfg=qj)
    )
    _, cj = jpre(pj, jnp.asarray(tok, jnp.int32))
    tpre = tengine.build_prefill_step(tcfg, 24, cache_dtype=torch.float32, qcfg=qt)
    _, ct = tpre(pt, torch.from_numpy(tok))
    leaves_j = jax.tree.leaves(cj, is_leaf=lambda x: isinstance(x, jkv.QuantKV))
    leaves_t = [leaf for _, leaf in tkv.tree_leaves(ct)]
    assert len(leaves_j) == len(leaves_t) == 4
    from repro_torch.core.codec import unpack_nibbles

    for lj, lt in zip(leaves_j, leaves_t):
        assert tuple(lt.codes.shape) == tuple(lj.codes.shape)
        assert lt.codes.shape[-2] == 24
        assert not lt.codes[..., 10:, :].any() and not lt.scale[..., 10:, :].any()
        np.testing.assert_allclose(
            lt.scale.numpy(), np.asarray(lj.scale), rtol=1e-5, atol=0
        )
        a, b = lt.codes, torch.from_numpy(np.array(lj.codes))
        if bits <= 4:
            a, b = unpack_nibbles(a, 2 * a.shape[-1]), unpack_nibbles(b, 2 * b.shape[-1])
        diff = (a.int() - b.int()).abs()
        assert int(diff.max()) <= 1 and int((diff > 0).sum()) <= 4


def test_vector_cache_index_scatters_codes_and_scales(models):
    """A (B,) decode index writes each row at its own position, codes and
    scales both; a constant vector equals the scalar index exactly."""
    _, tcfg, _, pt = models
    qt = tkv.CacheQuantConfig(bits=8)
    tok = torch.from_numpy(_prompts(tcfg.vocab_size, 2, 8, seed=4))
    pre = tengine.build_prefill_step(tcfg, 16, cache_dtype=torch.float32, qcfg=qt)
    dec = tengine.build_decode_step(tcfg)
    logits, caches = pre(pt, tok)
    nxt = tengine.greedy_sample(logits)
    fresh = lambda: pre(pt, tok)[1]  # noqa: E731
    a, _ = dec(pt, fresh(), nxt, 8)
    b, _ = dec(pt, fresh(), nxt, torch.tensor([8, 8]))
    assert torch.equal(a, b)
    before = fresh()
    after = dec(pt, fresh(), nxt, torch.tensor([8, 5]))[1]
    for (_, lb), (_, la) in zip(tkv.tree_leaves(before), tkv.tree_leaves(after)):
        for old, new in ((lb.codes, la.codes), (lb.scale, la.scale)):
            changed = (old != new).flatten(-1).any(-1)  # (R?, B, Hkv, S)
            rows = changed.nonzero()[:, [-3, -1]].unique(dim=0).tolist()
            assert rows == [[0, 8], [1, 5]]


@pytest.mark.parametrize("name,bits,dtype,want", [
    ("bf16", 0, torch.bfloat16, 256.0),
    ("q8", 8, torch.bfloat16, 144.0),
    ("q4", 4, torch.bfloat16, 80.0),
    ("f32", 0, torch.float32, 512.0),
])
def test_bytes_per_token_measured_equals_accounted(name, bits, dtype, want):
    """smoke: 2 layers x (k, v) x 1 kv head x head_dim 32; q8 = 32 + 4
    scale bytes per row, q4 = 16 + 4. Equal to the JAX package's."""
    qj, qt = _qcfgs(bits)
    tcfg = get_config("gemma3-1b", smoke=True)
    ct = tengine.init_serving_caches(tcfg, 2, 32, dtype, qt, device="cpu")
    measured = tkv.cache_bytes_per_token(ct, 2, 32)
    accounted = tkv.cache_bytes_per_token_accounting(ct, 2, 32)
    assert measured == accounted == want
    jcfg = jax_get_config("gemma3-1b", smoke=True)
    cj = jengine.init_serving_caches(jcfg, 2, 32, _JAX_DTYPES[dtype], qj)
    assert jkv.cache_bytes_per_token(cj, 2, 32) == want


@pytest.mark.parametrize("bits", [0, 8])
def test_continuous_scheduler_tokens_equal_jax(models, bits):
    """Staggered requests through 2 slots, decode chunk 3: every request's
    greedy tokens equal the JAX ContinuousScheduler's on the same requests."""
    from repro.serving.scheduler import ContinuousScheduler as JaxScheduler
    from repro.serving.scheduler import Request as JaxRequest
    from repro_torch.serving.scheduler import ContinuousScheduler, Request

    jcfg, tcfg, pj, pt = models
    qj, qt = _qcfgs(bits)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, size=n) for n in (5, 9, 12, 7, 10)]
    kw = dict(slots=2, max_seq=32, decode_chunk=3)
    js = JaxScheduler(jcfg, pj, cache_dtype=jnp.bfloat16, qcfg=qj, **kw)
    want = js.run(
        [JaxRequest(uid=i, prompt=p.astype(np.int32), max_new=6) for i, p in enumerate(prompts)]
    )
    ts = ContinuousScheduler(
        tcfg, pt, cache_dtype=torch.bfloat16, qcfg=qt, device="cpu", **kw
    )
    got = ts.run([Request(uid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)])
    assert got == want
    assert ts.steps == js.steps and ts.pool.n_free == js.pool.n_free


def test_scheduler_prefill_reads_full_logits_of_a_padded_bucket(models):
    """The scheduler prefills one prompt right-padded to a power-of-two
    bucket with full logits and reads position L-1: equal (atol 1e-5) to
    the unpadded prompt's last-position logits, because pad rows sit past
    the causal mask."""
    from repro_torch.serving.scheduler import _bucket

    _, tcfg, _, pt = models
    prompt = torch.from_numpy(_prompts(tcfg.vocab_size, 1, 11, seed=5))
    bucket = _bucket(11, 32)
    padded = torch.zeros((1, bucket), dtype=torch.long)
    padded[0, :11] = prompt[0]
    full = tengine.build_prefill_step(tcfg, 32, full_logits=True)
    logits, _ = full(pt, padded)
    assert bucket == 16 and tuple(logits.shape) == (1, 16, tcfg.vocab_size)
    last, _ = tengine.build_prefill_step(tcfg, 32)(pt, prompt)
    torch.testing.assert_close(logits[:, 10:11], last, atol=1e-5, rtol=0)


def test_working_type_follows_the_config(models):
    """The full config computes in bf16 (weights cast to the activations'
    dtype at each matmul), the smoke config in f32."""
    from repro_torch.models.model import cast_params, forward

    _, tcfg, _, pt = models
    assert get_config("gemma3-1b").dtype == "bfloat16" and tcfg.dtype == "float32"
    tok = torch.from_numpy(_prompts(tcfg.vocab_size, 1, 5, seed=6))
    assert forward(pt, tok, tcfg)[0].dtype == torch.float32
    assert forward(cast_params(pt, torch.bfloat16), tok, tcfg)[0].dtype == torch.bfloat16


def test_temperature_sampling_draws_from_the_generator():
    """Temperature > 0 draws from a torch.Generator: reproducible from its
    seed, and greedy at temperature 0."""
    logits = torch.tensor([[0.0, 10.0, 0.0], [3.0, -40.0, 3.1]])
    assert tengine.temperature_sample(None, logits, 0.0).tolist() == [1, 2]
    draw = lambda: tengine.temperature_sample(  # noqa: E731
        torch.Generator().manual_seed(5), logits.repeat(64, 1), 1.0
    )
    assert torch.equal(draw(), draw())
    assert set(draw()[1::2].tolist()) == {0, 2}


def test_block_pool_accounting():
    pool = tkv.BlockPool(n_blocks=4, block_tokens=16)
    assert pool.blocks_for(1) == 1 and pool.blocks_for(17) == 2
    assert pool.can_alloc(64) and not pool.can_alloc(65)
    got = pool.alloc(owner=7, n_tokens=33)
    assert len(got) == 3 and not pool.can_alloc(32)
    with pytest.raises(RuntimeError):
        pool.alloc(owner=8, n_tokens=32)
    pool.release(7)
    assert pool.can_alloc(64)


def test_serve_launcher_on_cpu():
    """The CLI entry point, fixed batch and continuous, at smoke size."""
    from repro_torch.launch import serve

    out = serve.main(
        "--arch gemma3-1b --smoke --device cpu --cache-bits 4 --batch 2 "
        "--prompt-len 6 --gen 3".split()
    )
    assert tuple(out["tokens"].shape) == (2, 3) and out["bytes_per_token"] == 80.0
    out = serve.main(
        "--arch gemma3-1b --smoke --device cpu --cache-bits 8 --batch 2 "
        "--prompt-len 6 --gen 3 --scheduler continuous --requests 3".split()
    )
    assert sorted(out["tokens"]) == [0, 1, 2] and out["bytes_per_token"] == 144.0


def test_unported_archs_raise_naming_the_slice():
    """Every architecture of the JAX package is ported: deepseek-v3-671b
    (MLA and the MTP head) and musicgen-medium (codebook heads and the
    conditioning prefix), which this test once named as refused, now come
    back full and smoke with the JAX package's widths; only an unknown name
    raises."""
    import dataclasses

    from repro.configs import ARCHS as JAX_ARCHS
    from repro_torch.configs import list_archs

    assert list_archs() == sorted(JAX_ARCHS)
    for name in ("deepseek-v3-671b", "musicgen-medium"):
        for smoke in (False, True):
            got = dataclasses.asdict(get_config(name, smoke))
            assert got == dataclasses.asdict(jax_get_config(name, smoke))
    with pytest.raises(KeyError):
        get_config("no-such-model")
