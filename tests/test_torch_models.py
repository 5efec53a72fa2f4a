"""Layer parity of the port's model code against the JAX package, in f32.

Each test builds its inputs and weights with numpy from a fixed seed and runs
them through the JAX function and its port. The numerical hazards found by
reading the JAX code are each named in a test: tanh GeLU, RoPE over halves,
RMSNorm's (1 + w) in f32, unscaled embeddings, SWA caches at full length.
"""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.configs.base import ModelConfig as JaxModelConfig, attn as jax_attn
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import model as jmodel
from repro.models import rope as jrope
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, attn
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import model as tmodel
from repro_torch.models import rope as trope
from repro_torch.weights import params_from_jax

# f32 on the CPU: matmuls sum in other orders in the two frameworks
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


# ------------------------------------------------------------------ RMSNorm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_one_plus_w_in_f32(dtype):
    """x * rsqrt(mean(x^2) + eps) * (1 + w) in f32, cast back; eps 1e-5.
    bf16 outputs may differ by one bf16 ulp (rtol 8e-3) where the f32
    rsqrt of the two libraries differs in its last bit."""
    x, w = _rand((3, 5, 64), 0, 3.0), _rand((64,), 1, 0.5)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jcommon.rms_norm(jnp.asarray(x).astype(jd), jnp.asarray(w), 1e-5)
    got = tcommon.rms_norm(_t(x).to(td), _t(w), 1e-5)
    assert got.dtype == td
    if dtype == "float32":
        _close(got, want, atol=1e-6)
    else:
        _close(got, want, atol=0, rtol=8e-3)
    # (1 + w), not w: a zero weight is the identity scale
    ones = tcommon.rms_norm(_t(x), torch.zeros(64))
    assert float((ones.square().mean(-1) - 1).abs().max()) < 1e-4


# --------------------------------------------------------------------- GeLU
def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to the tanh approximation; torch's default is
    exact. The port uses approximate='tanh' (atol 1e-6 to JAX)."""
    x = _rand((4096,), 2, 3.0)
    want = jax.nn.gelu(jnp.asarray(x))
    got = tcommon.act_fn("gelu")(_t(x))
    _close(got, want, atol=1e-6)
    exact = torch.nn.functional.gelu(_t(x))
    assert float((exact - got).abs().max()) > 1e-4  # the hazard is real


# --------------------------------------------------------------------- RoPE
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_rotates_halves_with_f32_angles(theta):
    """Positions up to 4095, head_dim 32; atol 2e-5 (angles in f32)."""
    b, s, h, d = 2, 6, 3, 32
    pos = np.array([[0, 1, 2, 511, 2047, 4095], [5, 6, 7, 8, 9, 10]], np.int32)
    x = _rand((b, s, h, d), 3)
    cj, sj = jrope.rope_freqs(jnp.asarray(pos), d, theta)
    ct, st = trope.rope_freqs(torch.from_numpy(pos), d, theta)
    _close(ct, cj, atol=1e-6)
    _close(st, sj, atol=1e-6)
    want = jrope.apply_rope(jnp.asarray(x), cj, sj)
    got = trope.apply_rope(_t(x), ct, st)
    _close(got, want)
    # halves, not interleaved pairs, despite the JAX docstring
    xt = _t(x)
    ev, od = xt[..., 0::2], xt[..., 1::2]
    c, s_ = ct[..., :, None, :], st[..., :, None, :]
    inter = torch.stack([ev * c - od * s_, ev * s_ + od * c], -1).flatten(-2)
    assert float((inter - got).abs().max()) > 1e-2


# ---------------------------------------------------------------- GeGLU MLP
def test_geglu_mlp_matches_jax():
    d, f = 64, 192
    p = {
        "gate": _rand((d, f), 4, d**-0.5),
        "up": _rand((d, f), 5, d**-0.5),
        "down": _rand((f, d), 6, f**-0.5),
    }
    x = _rand((2, 7, d), 7)
    want = jmlp.mlp_forward({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), "gelu")
    got = tmlp.mlp_forward({k: _t(v) for k, v in p.items()}, _t(x), "gelu")
    _close(got, want)


# ---------------------------------------------------------------- attention
# one compile per shape instead of JAX's op-by-op dispatch
_jit_attn = jax.jit(jattn.attn_forward, static_argnums=(2, 3))


def _attn_params(cfg, seed):
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": _rand((d, h * hd), seed, d**-0.5),
        "wk": _rand((d, hkv * hd), seed + 1, d**-0.5),
        "wv": _rand((d, hkv * hd), seed + 2, d**-0.5),
        "wo": _rand((h * hd, d), seed + 3, (h * hd) ** -0.5),
        "q_norm": _rand((hd,), seed + 4, 0.3),
        "k_norm": _rand((hd,), seed + 5, 0.3),
    }
    return {k: jnp.asarray(v) for k, v in p.items()}, {k: _t(v) for k, v in p.items()}


@pytest.mark.parametrize("layer", [0, 1])  # 0: SWA window 16, 1: global
def test_attn_forward_train_matches_jax(layer):
    jcfg, tcfg = jax_get_config("gemma3-1b", smoke=True), get_config("gemma3-1b", smoke=True)
    pj, pt = _attn_params(tcfg, 10)
    b, s = 2, 40  # longer than the window of 16
    x = _rand((b, s, tcfg.d_model), 11)
    pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int64)
    want, _ = _jit_attn(pj, jnp.asarray(x), jcfg.pattern[layer], jcfg, positions=jnp.asarray(pos))
    got, _ = tattn.attn_forward(pt, _t(x), tcfg.pattern[layer], tcfg, positions=torch.from_numpy(pos))
    _close(got, want)


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("vector_index", [False, True])
def test_attn_prefill_then_decode_matches_jax(bits, vector_index):
    """Prefill fills the cache, then one decode step appends and attends;
    with a (B,) index each row writes and masks at its own position. Both
    sides quantize the JAX prefill cache, so the caches start byte for byte
    equal; outputs within atol 2e-5."""
    from repro.serving import kv_cache as jkv
    from repro_torch.serving import kv_cache as tkv

    jcfg, tcfg = jax_get_config("gemma3-1b", smoke=True), get_config("gemma3-1b", smoke=True)
    spec_j, spec_t = jcfg.pattern[0], tcfg.pattern[0]
    pj, pt = _attn_params(tcfg, 20)
    b, s, max_seq = 2, 9, 24
    x = _rand((b, s, tcfg.d_model), 21)
    pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int64)
    cj = jattn.init_attn_cache(jcfg, b, max_seq, jnp.float32)
    ct = tattn.init_attn_cache(tcfg, b, max_seq, torch.float32, "cpu")
    yj, cj = _jit_attn(pj, jnp.asarray(x), spec_j, jcfg, positions=jnp.asarray(pos), cache=cj)
    yt, ct = tattn.attn_forward(pt, _t(x), spec_t, tcfg, positions=torch.from_numpy(pos), cache=ct)
    _close(yt, yj)
    if bits:
        # quantize the JAX prefill cache on both sides (as build_prefill_step does)
        ct = {k: tkv.quantize_kv(_t(np.asarray(v)), bits) for k, v in cj.items()}
        cj = {k: jkv.quantize_kv(v, bits) for k, v in cj.items()}
        for k in ("k", "v"):
            np.testing.assert_array_equal(ct[k].codes.numpy(), np.asarray(cj[k].codes))
            np.testing.assert_array_equal(ct[k].scale.numpy(), np.asarray(cj[k].scale))
    else:
        ct = {k: _t(np.asarray(v)) for k, v in cj.items()}
    idx = np.array([s, s - 3]) if vector_index else s
    x1 = _rand((b, 1, tcfg.d_model), 22)
    p1 = np.broadcast_to(np.asarray(idx).reshape(-1, 1), (b, 1)).astype(np.int64)
    ij = jnp.asarray(idx, jnp.int32)
    it = torch.from_numpy(np.asarray(idx)) if vector_index else int(idx)
    yj, cj = _jit_attn(pj, jnp.asarray(x1), spec_j, jcfg, positions=jnp.asarray(p1), cache=cj, cache_index=ij)
    yt, ct = tattn.attn_forward(pt, _t(x1), spec_t, tcfg, positions=torch.from_numpy(p1), cache=ct, cache_index=it)
    _close(yt, yj)
    for k in ("k", "v"):
        if bits:
            # new rows quantized from f32 K/V of the two frameworks: a code may
            # move by one step where q*L sits within an ulp of a half-integer
            dc = np.abs(_codes(ct[k].codes, bits) - _codes(_t_int8(cj[k].codes), bits))
            assert dc.max() <= 1 and (dc > 0).sum() <= 2
            _close(ct[k].scale, cj[k].scale, atol=1e-6)
        else:
            _close(ct[k], cj[k])


def _t_int8(a):
    return torch.from_numpy(np.array(a, np.int8))


def _codes(packed, bits):
    """Stored cache bytes -> signed integer codes (nibbles unpacked)."""
    from repro_torch.core.codec import unpack_nibbles

    if bits <= 4:
        return unpack_nibbles(packed, 2 * packed.shape[-1]).numpy()
    return packed.numpy().astype(np.int32)


def test_decode_attend_vector_index_equals_scalar():
    """A constant (B,) index gives exactly the scalar path's output."""
    q, k, v = _t(_rand((2, 4, 1, 32), 30)), _t(_rand((2, 1, 16, 32), 31)), _t(_rand((2, 1, 16, 32), 32))
    a = tattn.decode_attend(q, k, v, 9, 4)
    b = tattn.decode_attend(q, k, v, torch.tensor([9, 9]), 4)
    assert torch.equal(a, b)
    want = jattn.decode_attend(*(jnp.asarray(t.numpy()) for t in (q, k, v)), jnp.int32(9), 4)
    _close(a, want)


# ------------------------------------------------------------- whole model
def _stack_cfgs():
    """A small stack with lead, a repeated pattern and a tail, so the
    unstacking order of scan leaves is exercised (repeats=2)."""
    kw = dict(
        name="stack", arch_type="dense", source="test", d_model=64, vocab_size=96,
        repeats=2, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96, mlp_act="gelu",
        qk_norm=True, tie_embeddings=True, dtype="float32",
    )
    j = JaxModelConfig(
        pattern=(jax_attn(window=4, rope_theta=1e4), jax_attn(rope_theta=1e6)),
        lead=(jax_attn(window=3),), tail=(jax_attn(window=5),), **kw,
    )
    t = ModelConfig(
        pattern=(attn(window=4, rope_theta=1e4), attn(rope_theta=1e6)),
        lead=(attn(window=3),), tail=(attn(window=5),), **kw,
    )
    return j, t


def _perturbed_jax_params(jcfg, seed):
    """JAX init with every leaf (norms included) moved off its init value,
    so (1 + w) and each layer's position in the stack matter."""
    p = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    leaves, tree = jax.tree.flatten(jax.tree.map(np.asarray, p))
    rng = np.random.default_rng(seed)
    leaves = [a + (rng.standard_normal(a.shape) * 0.05).astype(a.dtype) for a in leaves]
    return jax.tree.unflatten(tree, leaves)


@pytest.mark.parametrize("which", ["smoke", "stack"])
def test_forward_matches_jax_with_unscaled_embeddings(which):
    """Whole-model train-mode logits from the same weights, atol 1e-4.
    Embeddings enter unscaled (no sqrt(d)), as in the JAX package."""
    if which == "smoke":
        jcfg, tcfg = jax_get_config("gemma3-1b", smoke=True), get_config("gemma3-1b", smoke=True)
    else:
        jcfg, tcfg = _stack_cfgs()
    pj = _perturbed_jax_params(jcfg, 0)
    pt = params_from_jax(pj, tcfg, device="cpu")
    tok = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 20))
    want, _, _ = jax.jit(jmodel.forward, static_argnums=2)(pj, jnp.asarray(tok), jcfg)
    got, _ = tmodel.forward(pt, torch.from_numpy(tok), tcfg)
    _close(got, want, atol=1e-4, rtol=1e-4)
    # sqrt(d)-scaled embeddings (Hugging Face's Gemma) would not match
    scaled = dict(pt, embed=pt["embed"] * tcfg.d_model**0.5)
    hid, _ = tmodel.forward(scaled, torch.from_numpy(tok), tcfg, return_hidden=True)
    bad = tmodel.apply_head(pt, hid, tcfg)
    assert float((bad - got).abs().max()) > 1e-2


def test_swa_caches_are_not_capped_at_the_window():
    """Every layer's cache holds max_seq positions, window or not, in the
    JAX tree layout (scan leaves stacked by repeat)."""
    jcfg, tcfg = _stack_cfgs()
    cj = jmodel.init_caches(jcfg, 2, 40, jnp.float32)
    ct = tmodel.init_caches(tcfg, 2, 40, torch.float32, "cpu")
    shapes_j = jax.tree_util.tree_flatten_with_path(cj)[0]
    from repro_torch.serving.kv_cache import tree_leaves

    shapes_t = list(tree_leaves(ct))
    assert len(shapes_j) == len(shapes_t)
    for (_, a), (_, b) in zip(shapes_j, shapes_t):
        assert tuple(a.shape) == tuple(b.shape)
        assert a.shape[-2] == 40


@pytest.mark.parametrize(
    "kw,slice_name",
    [
        (dict(kind="mamba"), "SSM slice"),
        (dict(moe=True), "LM training slice"),
    ],
)
def test_unported_layers_raise_naming_their_slice(kw, slice_name):
    from repro_torch.configs.base import LayerSpec
    from repro_torch.models.blocks import init_layer

    cfg = get_config("gemma3-1b", smoke=True)
    with pytest.raises(NotImplementedError, match=slice_name):
        init_layer(torch.Generator(), LayerSpec(**kw), cfg, "cpu")
