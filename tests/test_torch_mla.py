"""MLA (multi-head latent attention, deepseek-v3) of the port against the JAX
package's ``models/mla.py``, on the CPU in f32, at deepseek-v3-671b's smoke
widths (4 heads, q rank 48, kv rank 32, qk 32 + 16 rope, v 32).

The weights are the JAX package's seeded ``init_mla`` with every leaf moved
off its init value (the zero norms included), carried across as numpy; the
activations come from numpy. Tolerances:

* the train forward and the prefill output (the expanded heads through the
  attention's plain version): atol 1e-5 of the largest |y|, rtol 1e-4 (f32
  matmuls sum in other orders);
* a raw latent cache: rtol 1e-5, atol 1e-6 of the leaf's largest value;
* a q8 latent cache: codes within one step, at most 4 flips over the
  prefill and the 3 decode steps (a row whose f32 value straddles a bin
  edge in the two frameworks), scales rtol 1e-5;
* the absorbed decode's output: atol 1e-5 of the largest |y| while no code
  has flipped, else ``FLIP_Y`` of it: a flipped latent entry moves by up
  to (1 + alpha)^(1/127) - 1 = 1.9% of its row's scale.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from _torch_lm import to_numpy

from repro.configs import get_config as jax_get_config
from repro.configs.base import attn as jax_attn
from repro.models import mla as jmla
from repro.models.common import KeyGen
from repro.serving import kv_cache as jkv
from repro_torch.configs import get_config
from repro_torch.configs.base import attn
from repro_torch.models import mla as tmla
from repro_torch.serving import kv_cache as tkv
from repro_torch.weights import tensor_from_numpy

ARCH = "deepseek-v3-671b"
B, S, MAX_SEQ = 2, 12, 16
FLIP_Y = 2e-2


@functools.cache
def _params():
    """(jcfg, cfg, JAX params (numpy, moved off init), the port's)."""
    jcfg, cfg = jax_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    p = to_numpy(jmla.init_mla(KeyGen(jax.random.PRNGKey(0)), jcfg))
    rng = np.random.default_rng(1)
    pj = {
        k: a + (rng.standard_normal(a.shape) * 0.05).astype(a.dtype)
        for k, a in p.items()
    }
    pt = {k: tensor_from_numpy(a, "cpu") for k, a in pj.items()}
    return jcfg, cfg, pj, pt


def _x(seed, s):
    return np.random.default_rng(seed).standard_normal((B, s, 128)).astype(np.float32)


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    atol = rel * float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=1e-4)


def test_mla_train_forward_matches_jax():
    """No cache: Q and KV latents, the per-head expansion, the attention's
    plain version at qk dim 48 with V padded from 32, and ``wo``."""
    jcfg, cfg, pj, pt = _params()
    x = _x(2, S)
    pos = np.tile(np.arange(S), (B, 1))
    want, _ = jmla.mla_forward(
        pj, jnp.asarray(x), jax_attn(), jcfg, positions=jnp.asarray(pos)
    )
    got, cache = tmla.mla_forward(
        pt, torch.from_numpy(x), attn(), cfg, positions=torch.from_numpy(pos)
    )
    assert cache is None
    _close(got, want)


def _caches(bits):
    jcfg, cfg, _, _ = _params()
    shapes = {"ckv": cfg.kv_lora_rank, "krope": cfg.qk_rope_dim}
    cj = {k: jnp.zeros((B, MAX_SEQ, r), jnp.float32) for k, r in shapes.items()}
    ct = {k: torch.zeros((B, MAX_SEQ, r)) for k, r in shapes.items()}
    if bits:
        cj = jkv.quantize_tree(cj, jkv.CacheQuantConfig(bits=bits))
        ct = tkv.quantize_tree(ct, tkv.CacheQuantConfig(bits=bits))
    return cj, ct


def _cache_flips(got, want, label):
    """Leaf by leaf within the stated allowances; returns the code flips."""
    flips = 0
    for name in ("ckv", "krope"):
        g, w = got[name], want[name]
        if isinstance(g, tkv.QuantKV):
            diff = (g.codes.int() - torch.from_numpy(np.array(w.codes)).int()).abs()
            assert int(diff.max()) <= 1, f"{label} {name}"
            flips += int((diff > 0).sum())
            g, w = g.scale, w.scale
        w = np.asarray(w, np.float32)
        atol = 1e-6 * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=1e-5, atol=atol, err_msg=f"{label} {name}"
        )
    return flips


@pytest.mark.parametrize("index", ["int", "vector"])
@pytest.mark.parametrize("bits", [0, 8])
def test_mla_prefill_and_absorbed_decode_match_jax(bits, index):
    """Prefill of S = 12 tokens into a 16-row latent cache (raw f32, or q8
    rows of 32 and 16 codes), then 3 absorbed decode steps at a scalar
    index (S + i) or at a (B,) tensor of per-row positions (S + i and
    S + i + 1: the second row skips a position, which stays zero and
    visible): outputs and caches within the stated allowances."""
    jcfg, cfg, pj, pt = _params()
    cj, ct = _caches(bits)
    x = _x(3, S)
    pos = np.tile(np.arange(S), (B, 1))
    want, cj = jmla.mla_forward(
        pj, jnp.asarray(x), jax_attn(), jcfg, positions=jnp.asarray(pos), cache=cj
    )
    got, ct = tmla.mla_forward(
        pt,
        torch.from_numpy(x),
        attn(),
        cfg,
        positions=torch.from_numpy(pos),
        cache=ct,
    )
    _close(got, want)
    flips = _cache_flips(ct, cj, "prefill")
    for i in range(3):
        label = f"{index} index, q{bits} step {i}"
        x1 = _x(10 + i, 1)
        if index == "int":
            idx_j, idx_t = jnp.int32(S + i), S + i
            pos1 = np.full((B, 1), S + i)
        else:
            rows = np.array([S + i, S + i + 1])
            idx_j, idx_t = jnp.asarray(rows, jnp.int32), torch.from_numpy(rows)
            pos1 = rows[:, None]
        want, cj = jmla.mla_forward(
            pj,
            jnp.asarray(x1),
            jax_attn(),
            jcfg,
            positions=jnp.asarray(pos1),
            cache=cj,
            cache_index=idx_j,
        )
        got, ct = tmla.mla_forward(
            pt,
            torch.from_numpy(x1),
            attn(),
            cfg,
            positions=torch.from_numpy(pos1),
            cache=ct,
            cache_index=idx_t,
        )
        flips += _cache_flips(ct, cj, label)
        _close(got, want, 1e-5 if flips == 0 else FLIP_Y)
    assert flips <= 4, f"{flips} code flips"


def test_mla_leaves_and_cache_bytes_per_token():
    """The port's MLA leaves have the JAX leaves' names and shapes; its
    latent cache holds (kv rank + rope) values a token and layer, no head
    axis: at full width 512 + 64, which q8 stores as 576 code bytes and two
    4-byte scales."""
    jcfg, cfg, pj, pt = _params()
    assert {k: tuple(v.shape) for k, v in pt.items()} == {
        k: v.shape for k, v in pj.items()
    }
    full = get_config(ARCH)
    caches = tmla.init_mla_cache(full, 1, 4, torch.bfloat16, "meta")
    assert {k: tuple(v.shape) for k, v in caches.items()} == {
        "ckv": (1, 4, 512),
        "krope": (1, 4, 64),
    }
    q8 = tkv.quantize_tree(
        tmla.init_mla_cache(full, 1, 4, torch.bfloat16, "cpu"),
        tkv.CacheQuantConfig(bits=8),
    )
    assert tkv.cache_bytes_per_token(q8, 1, 4) == 512 + 64 + 2 * 4
    assert tkv.cache_bytes_per_token_accounting(q8, 1, 4) == 512 + 64 + 2 * 4
