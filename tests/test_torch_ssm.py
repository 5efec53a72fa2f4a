"""The port's Mamba-2 serving slice against the JAX package, on the CPU in f32.

Inputs and weights come from numpy with fixed seeds (weights: the JAX
package's seeded init, carried across with ``params_from_jax``). Tolerances:

* the plain SSD chunk term against ``ssd_chunk_pallas`` in interpret mode:
  atol 2e-4, rtol 1e-4, the JAX package's own test of the kernel;
* ``ssd_chunked`` and a Mamba-2 block against JAX: atol 2e-5, rtol 1e-5
  (f32 products summed in other orders);
* whole-model logits against JAX: atol 1e-4, rtol 1e-4; greedy tokens and
  bytes/token exactly.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.kernels.ssd_chunk import ssd_chunk_pallas
from repro.models import common as jcommon
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro.models.common import KeyGen
from repro.serving import engine as jengine
from repro.serving import kv_cache as jkv
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import common as tcommon
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.serving import engine as tengine
from repro_torch.serving import kv_cache as tkv
from repro_torch.weights import params_from_jax

ATOL = 2e-5


def _rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, atol=ATOL, rtol=1e-5):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=atol, rtol=rtol
    )


def _chunk_inputs(b, h, nc, q, p, n, seed, groups=None):
    """x, a_cum (a decreasing cumulative log-decay), B, C as numpy f32; B and
    C have ``groups`` in place of the head dim when given."""
    g = groups or h
    x = _rand((b, h, nc, q, p), seed)
    a = -np.cumsum(np.abs(_rand((b, h, nc, q), seed + 1)) * 0.1, -1)
    bm = _rand((b, g, nc, q, n), seed + 2)
    cm = _rand((b, g, nc, q, n), seed + 3)
    return x, a.astype(np.float32), bm, cm


# ------------------------------------------------------------ the SSD chunk


@pytest.mark.parametrize(
    "b,h,nc,q,p,n",
    [
        (1, 2, 3, 16, 8, 4),
        (2, 1, 2, 32, 16, 8),
        (1, 3, 1, 64, 32, 16),
        (1, 2, 3, 64, 32, 16),
    ],
)
def test_ssd_chunk_ref_matches_pallas(b, h, nc, q, p, n):
    """The plain version equals ``ssd_chunk_pallas`` (interpret mode)."""
    x, a, bm, cm = _chunk_inputs(b, h, nc, q, p, n, seed=5)
    want = ssd_chunk_pallas(*map(jnp.asarray, (x, a, bm, cm)), interpret=True)
    got = tref.ssd_chunk_ref(*map(_t, (x, a, bm, cm)))
    assert got.dtype == torch.float32 and got.shape == tuple(want.shape)
    _close(got, want, atol=2e-4, rtol=1e-4)


def test_ssd_chunk_dispatch_reads_groups_as_jnp_repeat():
    """``ops.ssd_chunk`` takes B/C per group: head h reads group h // (H // G),
    jnp.repeat's order. On the CPU it broadcasts and takes the plain version,
    which equals the Pallas kernel given jnp.repeat's broadcast."""
    x, a, bm, cm = _chunk_inputs(2, 4, 2, 16, 8, 4, seed=7, groups=2)
    rep = lambda t: jnp.repeat(jnp.asarray(t), 2, axis=1)
    want = ssd_chunk_pallas(jnp.asarray(x), jnp.asarray(a), rep(bm), rep(cm))
    got = ops.ssd_chunk(*map(_t, (x, a, bm, cm)))
    _close(got, want, atol=2e-4, rtol=1e-4)


def test_ssd_chunk_ref_never_multiplies_inf_by_zero():
    """A steep decay (a_cum down to -200 within a chunk, as dt * A reaches in
    the model) overflows exp above the diagonal; the mask is applied to the
    exponent, so the output stays finite and underflows to 0 where it does."""
    x, _, bm, cm = _chunk_inputs(1, 2, 1, 64, 8, 4, seed=9)
    a = np.broadcast_to(np.linspace(0.0, -200.0, 64, dtype=np.float32), (1, 2, 1, 64))
    bm[..., :32, :] = 0.0  # S = 0 where exp(a_i - a_j) overflows
    got = tref.ssd_chunk_ref(*map(_t, (x, a, bm, cm)))
    want = ssd_chunk_pallas(*map(jnp.asarray, (x, a, bm, cm)), interpret=True)
    assert bool(torch.isfinite(got).all())
    _close(got, want, atol=2e-4, rtol=1e-4)


# ------------------------------------------------------- the chunked forward


def _ssd_inputs(b, s, h, p, n, g, seed):
    x = _rand((b, s, h, p), seed)
    a = -np.abs(_rand((b, s, h), seed + 1)) * 0.3
    return x, a, _rand((b, s, g, n), seed + 2), _rand((b, s, g, n), seed + 3)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [32, 37])
def test_ssd_chunked_matches_jax_and_naive(with_h0, s):
    """The chunked forward (the chunk loop in place of lax.scan; a sequence
    of 37 pads a ragged last chunk) against JAX's and the port's naive
    recurrence: outputs and final states."""
    b, h, p, n, q = 2, 4, 8, 6, 16
    x, a, bm, cm = _ssd_inputs(b, s, h, p, n, h, seed=11)
    h0 = _rand((b, h, p, n), 15) if with_h0 else None
    jh0 = None if h0 is None else jnp.asarray(h0)
    th0 = None if h0 is None else _t(h0)
    yj, hj = jssm.ssd_chunked(*map(jnp.asarray, (x, a, bm, cm)), q, h0=jh0)
    yt, ht = tssm.ssd_chunked(*map(_t, (x, a, bm, cm)), q, h0=th0)
    _close(yt, yj)
    _close(ht, hj)
    yn, hn = tssm.ssd_naive(*map(_t, (x, a, bm, cm)), h0=th0)
    _close(yt, yn.numpy())
    _close(ht, hn.numpy())


def test_ssd_chunked_groups_follow_jnp_repeat():
    """B/C per group (G = 2 of H = 4) in the port equal JAX's chunked forward
    on jnp.repeat's broadcast; Tensor.repeat's order would not."""
    x, a, bm, cm = _ssd_inputs(2, 24, 4, 8, 6, 2, seed=21)
    rep = lambda t: jnp.repeat(jnp.asarray(t), 2, axis=2)
    yj, hj = jssm.ssd_chunked(jnp.asarray(x), jnp.asarray(a), rep(bm), rep(cm), 8)
    yt, ht = tssm.ssd_chunked(*map(_t, (x, a, bm, cm)), 8)
    _close(yt, yj)
    _close(ht, hj)
    tiled = [_t(t).repeat(1, 1, 2, 1) for t in (bm, cm)]
    yw, _ = tssm.ssd_chunked(_t(x), _t(a), *tiled, 8)
    assert not np.allclose(yw.numpy(), np.asarray(yj), atol=1e-3)


# ------------------------------------------------------------ the Mamba block


def _block_cfgs(groups):
    jcfg = jax_get_config("mamba2-370m", smoke=True)
    tcfg = get_config("mamba2-370m", smoke=True)
    if groups != 1:
        jcfg = dataclasses.replace(jcfg, ssm_groups=groups)
        tcfg = dataclasses.replace(tcfg, ssm_groups=groups)
    return jcfg, tcfg


def _block_params(jcfg, seed):
    pj = jssm.init_mamba(KeyGen(jax.random.PRNGKey(seed)), jcfg)
    pj = jax.tree.map(np.asarray, pj)
    return pj, {k: _t(v) for k, v in pj.items()}


def test_gated_rms_norm_matches_jax():
    x, z, w = _rand((2, 5, 64), 1), _rand((2, 5, 64), 2), _rand((64,), 3, 0.1)
    want = jcommon.gated_rms_norm(jnp.asarray(x), jnp.asarray(z), jnp.asarray(w))
    _close(tcommon.gated_rms_norm(_t(x), _t(z), _t(w)), want)


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba_prefill_then_decode_matches_jax(groups):
    """Prefill of 20 tokens (a ragged second chunk of Q = 16) with a cache,
    then three decode steps: every output and the caches (conv window and
    SSM state, written in place in the port) against JAX."""
    jcfg, tcfg = _block_cfgs(groups)
    pj, pt = _block_params(jcfg, 30)
    b, s = 2, 20
    x = _rand((b, s, tcfg.d_model), 31)
    cj = jssm.init_mamba_cache(jcfg, b, jnp.float32)
    ct = tssm.init_mamba_cache(tcfg, b, torch.float32, "cpu")
    fwd = jax.jit(lambda p, x, c: jssm.mamba_forward(p, x, jcfg, cache=c))
    yj, cj = fwd(pj, jnp.asarray(x), cj)
    conv, ssm = ct["conv"], ct["ssm"]
    yt, ct = tssm.mamba_forward(pt, _t(x), tcfg, cache=ct)
    assert ct["conv"] is conv and ct["ssm"] is ssm  # written in place
    _close(yt, yj, atol=5e-5)
    for k in ("conv", "ssm"):
        _close(ct[k], cj[k], atol=5e-5)
    for step in range(3):
        x1 = _rand((b, 1, tcfg.d_model), 40 + step)
        yj, cj = fwd(pj, jnp.asarray(x1), cj)
        yt, ct = tssm.mamba_forward(pt, _t(x1), tcfg, cache=ct)
        _close(yt, yj, atol=5e-5)
        for k in ("conv", "ssm"):
            _close(ct[k], cj[k], atol=5e-5)


def test_short_prompt_pads_the_conv_window():
    """A 2-token prompt (shorter than the conv window of 3) left-pads the
    cached window with zeros, as JAX does; a 1-token prompt with a cache is
    the decode step in both packages."""
    jcfg, tcfg = _block_cfgs(1)
    pj, pt = _block_params(jcfg, 50)
    fwd = jax.jit(lambda p, x, c: jssm.mamba_forward(p, x, jcfg, cache=c))
    for s in (1, 2):
        x = _rand((2, s, tcfg.d_model), 51 + s)
        cj = jssm.init_mamba_cache(jcfg, 2, jnp.float32)
        ct = tssm.init_mamba_cache(tcfg, 2, torch.float32, "cpu")
        yj, cj = fwd(pj, jnp.asarray(x), cj)
        yt, ct = tssm.mamba_forward(pt, _t(x), tcfg, cache=ct)
        _close(yt, yj, atol=5e-5)
        _close(ct["conv"], cj["conv"], atol=5e-5)
        _close(ct["ssm"], cj["ssm"], atol=5e-5)


def test_prefill_then_decode_equals_longer_prefill():
    """In the port alone: prefill(S) + decode(1) gives the logits of
    prefill(S + 1) at its last position (atol 5e-5, the JAX package's own
    check of this property), S = 20 across a chunk boundary."""
    cfg = get_config("mamba2-370m", smoke=True)
    params = tmodel.init_params(cfg, 2, "cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 20)))
    caches = tmodel.init_caches(cfg, 2, 40, torch.float32, "cpu")
    lp, caches = tmodel.forward(params, tok, cfg, caches=caches)
    lt, _ = tmodel.forward(params, tok, cfg)
    _close(lp, lt.numpy(), atol=5e-5)
    nxt = lp[:, -1:].argmax(-1)
    ld, _ = tmodel.forward(params, nxt, cfg, caches=caches, cache_index=20)
    lf, _ = tmodel.forward(params, torch.cat([tok, nxt], 1), cfg)
    _close(ld[:, 0], lf[:, -1].numpy(), atol=5e-5)


# -------------------------------------------------------- the serving slice


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_get_config("mamba2-370m", smoke=True)
    tcfg = get_config("mamba2-370m", smoke=True)
    pj = jax.tree.map(np.asarray, jmodel.init_params(jcfg, jax.random.PRNGKey(0)))
    pt = params_from_jax(pj, tcfg, device="cpu")
    return jcfg, tcfg, pj, pt


def test_configs_equal_jax():
    for smoke_cfg in (False, True):
        want = dataclasses.asdict(jax_get_config("mamba2-370m", smoke=smoke_cfg))
        got = dataclasses.asdict(get_config("mamba2-370m", smoke=smoke_cfg))
        assert got == want


def test_params_from_jax_carries_mamba_leaves(smoke):
    """Every Mamba leaf, unstacked by repeat, and the tied embedding arrive
    unchanged."""
    jcfg, tcfg, pj, pt = smoke
    assert torch.equal(pt["embed"], torch.from_numpy(pj["embed"].copy()))
    assert len(pt["layers"]) == tcfg.n_layers == 2
    for r, layer in enumerate(pt["layers"]):
        want = pj["scan"][0]["mixer"]
        assert sorted(layer["mixer"]) == sorted(want)
        for k, v in layer["mixer"].items():
            assert torch.equal(v, torch.from_numpy(want[k][r].copy())), k
        assert torch.equal(layer["ln1"], torch.from_numpy(pj["scan"][0]["ln1"][r].copy()))
        assert "ffn" not in layer  # d_ff = 0


@pytest.mark.parametrize("prompt_len", [16, 20])
def test_greedy_tokens_equal_jax(smoke, prompt_len):
    """``run_fixed`` against the JAX serve path (prefill, then
    ``build_generate_fn``): prefill logits within 1e-4 and the same 8 greedy
    tokens; a prompt of 20 pads a ragged chunk. bf16 conv window, f32 state."""
    from repro_torch.launch.serve import run_fixed

    jcfg, tcfg, pj, pt = smoke
    tok = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, prompt_len))
    gen = 8
    max_seq = prompt_len + gen
    jpre = jax.jit(jengine.build_prefill_step(jcfg, max_seq))
    jgen = jax.jit(jengine.build_generate_fn(jcfg), static_argnums=5)
    logits, caches = jpre(pj, jnp.asarray(tok, jnp.int32))
    first = jengine.greedy_sample(logits)
    idx = jnp.int32(prompt_len)
    caches, _, _, sampled = jgen(pj, caches, first, idx, jax.random.PRNGKey(0), gen - 1)
    want = np.concatenate([np.asarray(first), np.asarray(sampled)], axis=1)

    out = run_fixed(tcfg, pt, torch.from_numpy(tok), gen=gen)
    _close(out["logits"], logits, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(out["tokens"].numpy(), want)
    ssm_j = np.asarray(caches["scan"][0]["ssm"])
    _close(out["caches"]["scan"][0]["ssm"], ssm_j, atol=1e-4, rtol=1e-4)


def test_cache_bytes_per_token_equal_jax():
    """Batch 4, max_seq 16: conv (2, 4, 3, 288) bf16 + ssm (2, 4, 8, 32, 16)
    f32 = 144896 bytes = 2264.0 bytes/token, measured = accounted = JAX's;
    an 8-bit cache config leaves the SSM cache raw, as in JAX."""
    tcfg = get_config("mamba2-370m", smoke=True)
    jcfg = jax_get_config("mamba2-370m", smoke=True)
    for bits in (0, 8):
        qt = tkv.CacheQuantConfig(bits=bits)
        ct = tengine.init_serving_caches(tcfg, 4, 16, torch.bfloat16, qt, device="cpu")
        assert not tkv.tree_is_quantized(ct)
        measured = tkv.cache_bytes_per_token(ct, 4, 16)
        assert measured == tkv.cache_bytes_per_token_accounting(ct, 4, 16) == 2264.0
        qj = jkv.CacheQuantConfig(bits=bits) if bits else None
        cj = jengine.init_serving_caches(jcfg, 4, 16, jnp.bfloat16, qj)
        assert not jkv.tree_is_quantized(cj)
        assert jkv.cache_bytes_per_token(cj, 4, 16) == measured


def test_serve_launcher_mamba_on_cpu():
    """The CLI entry point serves the smoke Mamba-2 with the fixed scheduler
    (q8 leaves its cache raw); the continuous scheduler refuses it."""
    from repro_torch.launch import serve

    argv = "--arch mamba2-370m --smoke --device cpu --batch 2 --prompt-len 6"
    out = serve.main((argv + " --gen 3 --cache-bits 8").split())
    assert tuple(out["tokens"].shape) == (2, 3)
    assert not tkv.tree_is_quantized(out["caches"])
    assert out["bytes_per_token"] == out["bytes_per_token_accounted"]
    with pytest.raises(ValueError, match="attention-only"):
        serve.main((argv + " --gen 3 --scheduler continuous").split())
