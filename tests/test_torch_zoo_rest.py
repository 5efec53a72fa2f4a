"""The rest of the model zoo against the JAX package, on the CPU in f32:
deepseek-v3-671b (MLA, a shared expert, the MTP head and loss),
musicgen-medium (codebook embeddings and heads, the conditioning prefix)
and the training of the Mamba-2 models (mamba2-370m, jamba-v0.1-52b).

At each config's smoke widths the weights are the JAX package's seeded init
with every leaf moved off its init value, carried across with
``params_from_jax``; tokens and the conditioning prefix are the JAX
package's stubs' draws (``codec_tokens_stub``, ``conditioning_stub``) or
numpy's. Tolerances:

* train-mode logits (and ``mtp_logits``): atol / rtol 1e-4; the summed
  load-balance loss rtol 1e-5 (f32 matmuls sum in other orders);
* ``lm_loss``'s metrics rtol 1e-5 and its gradients 1e-5 of each leaf's
  largest value (``tests/test_torch_lm_train.py``);
* prefill and 3 decode steps at q8, each step fed JAX's greedy tokens
  (one a codebook for musicgen): the greedy tokens equal, prefill logits
  atol / rtol 1e-4, decode logits within ``FLIP_LOGITS`` of the largest
  (a cache code may flip by one step, ``tests/test_torch_zoo.py``), cache
  codes within one step;
* data, the weights' round trip, parameter counts, plans, wire bits and
  collectives at full width (abstract shapes): exact.
"""

import contextlib
import dataclasses
import functools
import io

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from _torch_lm import (
    assert_leaves_close,
    cache_close,
    jax_collectives,
    jit_o0,
    to_numpy,
    to_port,
    zoo_models,
)

from repro.configs import get_config as jax_get_config
from repro.core import CompressorConfig as JaxCompressorConfig
from repro.core.compressors import build_plans as jax_build_plans
from repro.core.compressors import make_compressor as jax_make_compressor
from repro.data.synthetic import LMDataConfig as JaxLMData
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.models import model as jmodel
from repro.models import multimodal as jmm
from repro.serving import engine as jengine
from repro.serving import kv_cache as jkv
from repro.train import step as jax_step
from repro.train.loss import lm_loss as jax_lm_loss
from repro_torch.configs import get_config
from repro_torch.core.compressors import CompressorConfig, build_plans
from repro_torch.core.tree import flatten_with_paths, tree_leaves, tree_map
from repro_torch.data.synthetic import LMDataConfig, cond_batch, lm_batch
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import model as tmodel
from repro_torch.serving import engine as tengine
from repro_torch.serving import kv_cache as tkv
from repro_torch.train.loss import lm_loss
from repro_torch.train.step import abstract_grads_of, make_model_compressor
from repro_torch.weights import to_jax_layout

NEW = ["deepseek-v3-671b", "musicgen-medium"]
MAMBA = ["mamba2-370m", "jamba-v0.1-52b"]
B, S = 2, 20
FLIP_LOGITS = 2e-2
# full-width trees (cuts as chip_smoke.py takes them): the JAX package's
# parameter count and LQ-SGD r1 b8 wire bits a step (eval_shape of
# init_params)
FULL_WIDTH = {
    "deepseek-v3-671b/4-layers": (dict(repeats=1), 15_797_366_784, 43_602_112),
    "musicgen-medium": ({}, 1_837_254_144, 14_922_976),
    "mamba2-370m": ({}, 368_338_432, 6_671_968),
    # chip_smoke's (m3) / (m4) training cuts: 24 of the 48 layers, then 12,
    # then 6
    "mamba2-370m/24-layers": (dict(repeats=24), 209_913_088, 3_545_440),
    "musicgen-medium/24-layers": (dict(repeats=24), 931_210_752, 7_539_424),
    "mamba2-370m/12-layers": (dict(repeats=12), 130_700_416, 1_982_176),
    "musicgen-medium/12-layers": (dict(repeats=12), 478_189_056, 3_847_648),
    "mamba2-370m/6-layers": (dict(repeats=6), 91_094_080, 1_200_544),
    "musicgen-medium/6-layers": (dict(repeats=6), 251_678_208, 2_001_760),
}


def _inputs(cfg, seed, s=S):
    """(tokens, cond) as numpy: the JAX stubs' draws for musicgen, numpy's
    ids otherwise (cond None)."""
    key = jax.random.PRNGKey(seed)
    if cfg.n_codebooks:
        tok = np.asarray(jmm.codec_tokens_stub(key, B, s, cfg))
        cond = np.asarray(jmm.conditioning_stub(jax.random.fold_in(key, 1), B, cfg))
        return tok, cond
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, s)), None


def _batch(tok, cond, framework):
    if framework == "jax":
        b = {"tokens": jnp.asarray(tok, jnp.int32)}
        if cond is not None:
            b["cond"] = jnp.asarray(cond)
        return b
    b = {"tokens": torch.from_numpy(np.array(tok))}
    if cond is not None:
        b["cond"] = torch.from_numpy(np.array(cond))
    return b


@functools.cache
def _jax_forward(arch):
    jcfg = jax_get_config(arch, smoke=True)
    return jit_o0(lambda p, t, c: jmodel.forward(p, t, jcfg, cond=c))


@pytest.mark.parametrize("arch", NEW)
def test_forward_matches_jax(arch):
    """Train-mode logits ((B, S, V), or (B, S, 4, V) after musicgen's
    conditioning prefix), deepseek's ``mtp_logits`` and the summed
    load-balance loss against the JAX forward's."""
    jcfg, cfg, pj, pt = zoo_models(arch)
    tok, cond = _inputs(cfg, 2)
    want, _, want_aux = _jax_forward(arch)(
        pj, jnp.asarray(tok, jnp.int32), None if cond is None else jnp.asarray(cond)
    )
    b = _batch(tok, cond, "torch")
    got, _, aux = tmodel.forward(
        pt, b["tokens"], cfg, cond=b.get("cond"), return_aux=True
    )
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    assert sorted(aux) == sorted(want_aux)
    if cfg.mtp:
        np.testing.assert_allclose(
            aux["mtp_logits"].numpy(),
            np.asarray(want_aux["mtp_logits"]),
            atol=1e-4,
            rtol=1e-4,
        )
    want_moe = float(want_aux["moe_aux"])
    np.testing.assert_allclose(float(aux["moe_aux"]), want_moe, rtol=1e-5)
    assert (want_moe > 0) == bool(cfg.n_experts)


@functools.cache
def _jax_loss_grad(arch):
    jcfg = jax_get_config(arch, smoke=True)

    def f(p, batch):
        return jax_lm_loss(p, batch, jcfg)

    return jit_o0(jax.value_and_grad(f, has_aux=True))


@pytest.mark.parametrize("head_chunk", [0, 8])
@pytest.mark.parametrize("arch", NEW + MAMBA)
def test_lm_loss_and_grads_match_jax(arch, head_chunk):
    """lm_loss and its gradients in the training tree against
    ``jax.value_and_grad`` of the JAX package's: deepseek's ce, mtp_ce
    (t + 2 under its mask, at 0.3) and moe_aux; musicgen's CE averaged
    over the codebooks after the conditioning prefix; the Mamba-2 models
    through the plain SSD. ``head_chunk`` 8 takes the chunked head only
    where the JAX package does (not with MTP or codebooks): the same
    values either way."""
    jcfg, cfg, pj, _ = zoo_models(arch)
    tok, cond = _inputs(cfg, 4)
    (want, wm), want_grads = _jax_loss_grad(arch)(pj, _batch(tok, cond, "jax"))
    params = tree_map(lambda t: t.requires_grad_(True), to_port(pj))
    loss, m = lm_loss(params, _batch(tok, cond, "torch"), cfg, head_chunk=head_chunk)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    assert sorted(m) == sorted(wm)
    for k in m:
        np.testing.assert_allclose(m[k].item(), float(wm[k]), rtol=1e-5)
    assert ("mtp_ce" in m) == cfg.mtp
    assert_leaves_close(list(grads), jax.tree.leaves(to_numpy(want_grads)), arch)


@functools.cache
def _jax_serving(arch, max_seq):
    jcfg = jax_get_config(arch, smoke=True)
    pre = jengine.build_prefill_step(
        jcfg,
        max_seq,
        cache_dtype=jnp.float32,
        qcfg=jkv.CacheQuantConfig(bits=8),
        full_logits=True,
    )
    return jit_o0(pre), jit_o0(jengine.build_decode_step(jcfg))


@pytest.mark.parametrize("arch", NEW)
def test_prefill_and_three_decode_steps_at_q8_match_jax(arch):
    """Prefill at q8 (deepseek's latent rows ckv and krope, musicgen's K/V
    after its conditioning prefix), then 3 decode steps at index S +
    cond_len + i, each fed JAX's greedy tokens (one a codebook): the same
    greedy tokens, logits and caches within the stated allowances."""
    jcfg, cfg, pj, pt = zoo_models(arch)
    tok, cond = _inputs(cfg, 3)
    max_seq = S + cfg.cond_len + 4
    jpre, jdec = _jax_serving(arch, max_seq)
    jb, tb = _batch(tok, cond, "jax"), _batch(tok, cond, "torch")
    want, cj = jpre(pj, jb["tokens"], jb.get("cond"))
    want = want[:, -1:]
    tpre = tengine.build_prefill_step(
        cfg, max_seq, cache_dtype=torch.float32, qcfg=tkv.CacheQuantConfig(bits=8)
    )
    got, ct = tpre(pt, tb["tokens"], tb.get("cond"))
    assert tkv.tree_is_quantized(ct) and tuple(got.shape) == want.shape
    decode = tengine.build_decode_step(cfg)
    start = S + cfg.cond_len
    for i in range(4):
        label = f"{arch} step {i}"
        w = np.asarray(want)[:, -1]
        atol = 1e-4 if i == 0 else FLIP_LOGITS * float(np.abs(w).max())
        np.testing.assert_allclose(got[:, -1].numpy(), w, atol=atol, rtol=1e-4)
        nxt = np.asarray(jengine.greedy_sample(want))
        np.testing.assert_array_equal(tengine.greedy_sample(got).numpy(), nxt)
        cache_close(ct, cj, label)
        if i == 3:
            break
        want, cj = jdec(pj, cj, jnp.asarray(nxt), jnp.int32(start + i))
        got, ct = decode(pt, ct, torch.from_numpy(nxt).long(), start + i)


def test_musicgen_greedy_generation_matches_the_jax_launcher_loop():
    """``run_fixed`` on musicgen smoke (raw f32 cache, the conditioning
    prefix, a greedy token a codebook through ``DecodeLoop``) against the
    JAX launcher's host loop of prefill + decode steps from index
    prompt_len + cond_len: the same (B, gen, 4) tokens."""
    arch, gen = "musicgen-medium", 5
    jcfg, cfg, pj, pt = zoo_models(arch)
    tok, cond = _inputs(cfg, 5, s=12)
    max_seq = 12 + cfg.cond_len + gen
    pre = jit_o0(jengine.build_prefill_step(jcfg, max_seq, cache_dtype=jnp.float32))
    dec = jit_o0(jengine.build_decode_step(jcfg))
    logits, caches = pre(pj, jnp.asarray(tok, jnp.int32), jnp.asarray(cond))
    out = [jengine.greedy_sample(logits)]
    for i in range(gen - 1):
        logits, caches = dec(pj, caches, out[-1], jnp.int32(12 + cfg.cond_len + i))
        out.append(jengine.greedy_sample(logits))
    want = np.asarray(jnp.concatenate(out, axis=1))
    tb = _batch(tok, cond, "torch")
    got = launch_serve.run_fixed(
        cfg,
        pt,
        tb["tokens"],
        gen=gen,
        cache_dtype=torch.float32,
        cond=tb["cond"],
    )
    assert want.shape == (B, gen, 4)
    np.testing.assert_array_equal(got["tokens"].numpy(), want)


@pytest.mark.parametrize("step", [0, 3])
def test_lm_batch_with_codebooks_and_cond_equal_jax(step):
    """musicgen's training data: the (B, S, 4) codebook grid equals the JAX
    package's ``lm_batch`` element for element, and ``cond_batch`` the JAX
    launcher's numpy draw of the conditioning prefix."""
    kw = dict(vocab_size=256, seq_len=40, batch=3, n_codebooks=4, seed=7)
    got = lm_batch(LMDataConfig(**kw), step)["tokens"]
    want = jax_lm_batch(JaxLMData(**kw), step)["tokens"]
    assert got.shape == (3, 40, 4) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(np.random.SeedSequence([7, step, 1]))
    want_cond = (rng.standard_normal((3, 8, 128)) * 0.02).astype(np.float32)
    got_cond = cond_batch(LMDataConfig(**kw), step, 8, 128)
    np.testing.assert_array_equal(got_cond, want_cond)


@pytest.mark.parametrize("arch", NEW)
def test_weights_round_trip(arch):
    """JAX tree -> the port's serving tree -> its training tree: the JAX
    tree's paths and leaves exactly, MLA leaves, the ``mtp`` subtree, the
    (4, V, d) codebook embedding and (4, d, V) head included."""
    _, cfg, pj, pt = zoo_models(arch)
    got = flatten_with_paths(to_jax_layout(pt, cfg))
    want = jax.tree_util.tree_flatten_with_path(pj)[0]
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    if cfg.mtp:
        assert {"proj", "layer", "norm_h", "norm_e", "final_norm"} == set(pt["mtp"])
    if cfg.n_codebooks:
        assert tuple(pt["embed"].shape) == (4, cfg.vocab_size, cfg.d_model)
        assert tuple(pt["head"].shape) == (4, cfg.d_model, cfg.vocab_size)


@functools.cache
def _jax_abstract(arch, repeats=None):
    jcfg = jax_get_config(arch)
    if repeats is not None:
        jcfg = dataclasses.replace(jcfg, repeats=repeats)
    return jax_step.abstract_grads_of(jcfg)


@pytest.mark.parametrize("name", sorted(FULL_WIDTH))
def test_full_width_plans_bits_and_collectives_match_jax(name):
    """The full-width training tree (deepseek cut to chip_smoke's 3 dense
    layers and 1 MoE layer, with MTP): the JAX tree's leaves, shapes,
    stacked flags and parameter count; LQ-SGD r1 b8 plans every leaf as the
    JAX package does (MLA's, the unstacked mtp subtree, musicgen's (4, d,
    V) head as a (4 d, V) matrix) and ships its bits in its collectives."""
    arch = name.split("/")[0]
    cut, n_params, bits = FULL_WIDTH[name]
    jabs, jflags = _jax_abstract(arch, cut.get("repeats"))
    cfg = dataclasses.replace(get_config(arch), **cut)
    abstract, flags = abstract_grads_of(cfg)
    assert tree_leaves(flags) == jax.tree.leaves(jflags)
    assert sum(w.numel() for w in tree_leaves(abstract)) == n_params
    plans = build_plans(abstract, rank=1, stacked=flags)
    jplans = jax_build_plans(jabs, rank=1, stacked=jflags)
    for p, jp in zip(plans, jplans, strict=True):
        assert (p.path, p.shape, p.route, p.mat_shape, p.eff_rank) == (
            jp.path,
            jp.shape,
            jp.route,
            jp.mat_shape,
            jp.eff_rank,
        )
    if arch == "musicgen-medium":
        head = next(p for p in plans if p.path == "['head']")
        assert head.mat_shape == (4 * 1536, 2048)
    ccfg = dict(name="lq_sgd", rank=1, bits=8)
    jcomp = jax_make_compressor(JaxCompressorConfig(**ccfg), jabs, jflags)
    comp = make_model_compressor(cfg, CompressorConfig(**ccfg))
    assert comp.wire_bits_per_step() == jcomp.wire_bits_per_step() == bits
    assert comp.handler.group_collectives(comp.plans) == jax_collectives(jcomp, jabs)


@pytest.mark.parametrize("arch", NEW + MAMBA)
def test_launcher_trains_at_smoke_widths(arch):
    """``launch.train --smoke --device cpu`` takes two LQ-SGD steps over 2
    workers: deepseek logs mtp_ce and moe_aux, jamba moe_aux, musicgen
    trains on codebook batches with their conditioning prefix."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = launch_train.main(
            f"--arch {arch} --smoke --device cpu --mesh 2x1 --batch 4 --seq 16 "
            "--steps 2 --log-every 1 --runtime sync".split()
        )
    cfg = get_config(arch, smoke=True)
    hist = res["history"]
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert all(("mtp_ce" in h) == cfg.mtp for h in hist)
    assert all(("moe_aux" in h) == bool(cfg.n_experts) for h in hist)
    assert f"arch={cfg.name}" in out.getvalue()


@pytest.mark.parametrize("arch", NEW)
def test_launcher_serves_at_smoke_widths(arch):
    """``launch.serve --smoke --device cpu --cache-bits 8``: deepseek's q8
    latent cache, (32 + 16) codes and two 4-byte scales a token and layer
    over 3 layers; musicgen's (B, gen, 4) codebook tokens after the
    conditioning prefix, K/V of 4 heads x 32 over 2 layers."""
    with contextlib.redirect_stdout(io.StringIO()):
        got = launch_serve.main(
            f"--arch {arch} --smoke --device cpu --batch 2 --prompt-len 8 "
            "--gen 3 --cache-bits 8".split()
        )
    cfg = get_config(arch, smoke=True)
    if cfg.n_codebooks:
        assert tuple(got["tokens"].shape) == (2, 3, 4)
        assert got["bytes_per_token"] == 2 * 2 * 4 * (32 + 4)
    else:
        assert tuple(got["tokens"].shape) == (2, 3)
        assert got["bytes_per_token"] == 3 * (32 + 16 + 2 * 4)
    assert got["bytes_per_token"] == got["bytes_per_token_accounted"]
