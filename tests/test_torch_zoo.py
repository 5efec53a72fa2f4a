"""The model zoo of the port (the untied head and the MoE layers: qwen2-72b,
mistral-nemo-12b, granite-20b, chameleon-34b, mixtral-8x7b, jamba-v0.1-52b)
against the JAX package, on the CPU in f32.

At each config's smoke widths the weights are the JAX package's seeded
init with every leaf moved off its init value (zero biases and norms
included), carried across with ``params_from_jax``; tokens come from
numpy. Tolerances:

* train-mode logits and the summed load-balance loss: atol / rtol 1e-4 and
  rtol 1e-5 (f32 matmuls sum in other orders);
* prefill and 3 decode steps at q8, each step fed JAX's greedy token: the
  greedy tokens equal; prefill logits atol / rtol 1e-4; decode logits
  within ``FLIP_LOGITS`` of the largest: a KV code may flip by one step
  where the two frameworks' f32 K/V straddle a bin edge, as in
  ``tests/test_torch_serving.py``, which moves that K or V entry by up to
  (1 + alpha)^(1/127) - 1 = 1.9%; cache codes within one step, at most 8
  flips, scales and raw leaves rtol 1e-4;
* ``lm_loss`` and its gradients, whole and by head chunks: rtol 1e-5 and
  1e-5 of each leaf's largest value (``tests/test_torch_lm_train.py``);
* parameter counts, LQ-SGD plans, wire bits and collectives at full width
  (abstract shapes): exact;
* one 2-worker LQ-SGD step on mixtral smoke against the JAX step composed
  from its parts: within ``flip_tol``.
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
    flip_tol,
    jax_collectives,
    jit_o0,
    to_numpy,
    to_port,
    zoo_models,
)
from conftest import broadcast_state, simulate_workers

from repro.configs import get_config as jax_get_config
from repro.core import AxisComm
from repro.core import CompressorConfig as JaxCompressorConfig
from repro.core.compressors import build_plans as jax_build_plans
from repro.core.compressors import make_compressor as jax_make_compressor
from repro.serving import engine as jengine
from repro.serving import kv_cache as jkv
from repro.train import optimizer as jax_opt
from repro.train import step as jax_step
from repro.train.loss import lm_loss as jax_lm_loss
from repro_torch.configs import get_config
from repro_torch.core.compressors import CompressorConfig, build_plans
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import model as tmodel
from repro_torch.models.multimodal import vq_tokens_stub
from repro_torch.serving import engine as tengine
from repro_torch.serving import kv_cache as tkv
from repro_torch.train import optimizer as port_opt
from repro_torch.train.loss import lm_loss
from repro_torch.train.step import (
    abstract_grads_of,
    build_train_step,
    make_model_compressor,
)
from repro_torch.weights import compressor_state_from_jax

ZOO = [
    "qwen2-72b",
    "mistral-nemo-12b",
    "granite-20b",
    "chameleon-34b",
    "mixtral-8x7b",
    "jamba-v0.1-52b",
]
TRAINABLE = [a for a in ZOO if a != "jamba-v0.1-52b"]  # Mamba-2 has no backward
# the JAX package's parameter counts (eval_shape of init_params) of five
# full configs and of the cuts that chip_smoke.py serves and trains
FULL_WIDTH_PARAMS = {
    "qwen2-72b": ({}, 72_706_203_648),
    "mistral-nemo-12b": ({}, 12_247_782_400),
    "granite-20b": ({}, 28_167_493_632),
    # chip_smoke's (l1) / (l2) cuts, for time (halved with its phase 19)
    "mistral-nemo-12b/20-layers": (dict(repeats=20), 6_794_982_400),
    "granite-20b/26-layers": (dict(repeats=26), 14_385_739_776),
    "mistral-nemo-12b/10-layers": (dict(repeats=10), 4_068_582_400),
    "granite-20b/13-layers": (dict(repeats=13), 7_494_862_848),
    "chameleon-34b": ({}, 34_293_436_416),
    "mixtral-8x7b": ({}, 46_702_792_704),
    "mixtral-8x7b/16-layers": (dict(repeats=16), 23_482_470_400),
    "mixtral-8x7b/8-layers": (dict(repeats=8), 11_872_309_248),
    "mixtral-8x7b/1-layer": (dict(repeats=1), 1_713_418_240),
    "jamba-v0.1-52b/1-period": (dict(repeats=1), 13_267_656_416),
}
# the JAX package's LQ-SGD r1 b8 wire bits a step of full-width mixtral
MIXTRAL_BITS = {32: 65_116_384, 1: 2_626_336}
B, S, MAX_SEQ = 2, 20, 24
FLIP_LOGITS = 2e-2
def _tokens(cfg, seed=2, s=S):
    if cfg.arch_type == "vlm":
        return vq_tokens_stub(torch.Generator().manual_seed(seed), B, s, cfg).numpy()
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, s))


@functools.cache
def _jax_serving(arch):
    """JAX's q8 prefill (every position's logits) and decode step, jitted
    once; the prefill's logits are the train-mode forward's."""
    jcfg = jax_get_config(arch, smoke=True)
    qcfg = jkv.CacheQuantConfig(bits=8)
    pre = jengine.build_prefill_step(
        jcfg, MAX_SEQ, cache_dtype=jnp.float32, qcfg=qcfg, full_logits=True
    )
    return jit_o0(pre), jit_o0(jengine.build_decode_step(jcfg))


@pytest.mark.parametrize("arch", ZOO)
def test_forward_logits_and_moe_aux_match_jax(arch):
    """Train-mode logits from the same weights against the JAX forward's
    (its prefill's, every position), and the MoE layers' summed
    load-balance loss against the JAX loss's ``moe_aux`` (0 for a dense
    model)."""
    jcfg, cfg, pj, pt = zoo_models(arch)
    tok = _tokens(cfg)
    want, _ = _jax_serving(arch)[0](pj, jnp.asarray(tok, jnp.int32))
    got, _, got_aux = tmodel.forward(pt, torch.from_numpy(tok), cfg, return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    assert ("head" in pt) == (not cfg.tie_embeddings)
    if arch not in TRAINABLE:
        assert float(got_aux["moe_aux"]) > 0
        return
    (_, metrics), _ = _jax_loss_grad(arch)(pj, jnp.asarray(tok, jnp.int32))
    want_aux = float(metrics.get("moe_aux", 0.0))
    np.testing.assert_allclose(float(got_aux["moe_aux"]), want_aux, rtol=1e-5)
    assert (want_aux > 0) == bool(cfg.n_experts)


@pytest.mark.parametrize("arch", ZOO)
def test_prefill_and_three_decode_steps_at_q8_match_jax(arch):
    """Prefill at q8 then 3 decode steps, each fed JAX's greedy token: the
    same greedy tokens, logits and caches (attention K/V log-quantized,
    Mamba-2 conv window and state raw) within the stated allowances."""
    jcfg, cfg, pj, pt = zoo_models(arch)
    tok = _tokens(cfg, seed=3)
    jpre, jdec = _jax_serving(arch)
    want, cj = jpre(pj, jnp.asarray(tok, jnp.int32))
    want = want[:, -1:]
    tpre = tengine.build_prefill_step(
        cfg, MAX_SEQ, cache_dtype=torch.float32, qcfg=tkv.CacheQuantConfig(bits=8)
    )
    got, ct = tpre(pt, torch.from_numpy(tok))
    assert tkv.tree_is_quantized(ct)
    decode = tengine.build_decode_step(cfg)
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
        want, cj = jdec(pj, cj, jnp.asarray(nxt), jnp.int32(S + i))
        got, ct = decode(pt, ct, torch.from_numpy(nxt), S + i)


@functools.cache
def _jax_loss_grad(arch):
    jcfg = jax_get_config(arch, smoke=True)

    def f(p, tokens):
        return jax_lm_loss(p, {"tokens": tokens}, jcfg)

    return jit_o0(jax.value_and_grad(f, has_aux=True))


@pytest.mark.parametrize("head_chunk", [0, 8])
@pytest.mark.parametrize("arch", TRAINABLE)
def test_lm_loss_and_grads_match_jax(arch, head_chunk):
    """lm_loss (cross-entropy plus router_aux_coef x the load-balance loss)
    and its gradients in the training tree (the JAX tree itself), whole and
    by head chunks of 8 positions (an untied head's chunks read ``head``),
    against the JAX package's whole loss."""
    jcfg, cfg, pj, _ = zoo_models(arch)
    tok = _tokens(cfg, seed=4)
    (want, wm), want_grads = _jax_loss_grad(arch)(pj, jnp.asarray(tok, jnp.int32))
    params = tree_map(lambda t: t.requires_grad_(True), to_port(pj))
    loss, m = lm_loss(
        params, {"tokens": torch.from_numpy(tok)}, cfg, head_chunk=head_chunk
    )
    grads = torch.autograd.grad(loss, tree_leaves(params))
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    assert sorted(m) == sorted(wm)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(wm[k]), rtol=1e-5)
    assert_leaves_close(list(grads), jax.tree.leaves(to_numpy(want_grads)), arch)


@functools.cache
def _jax_abstract(arch, repeats=None):
    """The JAX package's full-width tree (eval_shape of init_params) and its
    stacked flags, at ``repeats`` if given."""
    jcfg = jax_get_config(arch)
    if repeats is not None:
        jcfg = dataclasses.replace(jcfg, repeats=repeats)
    return jcfg, *jax_step.abstract_grads_of(jcfg)


@pytest.mark.parametrize("name", sorted(FULL_WIDTH_PARAMS))
def test_full_width_parameter_counts_match_jax(name):
    """The port's tree on the ``meta`` device (nothing allocated) counts the
    JAX package's eval_shape parameters exactly, cuts included."""
    arch = name.split("/")[0]
    cut, want = FULL_WIDTH_PARAMS[name]
    _, shapes, _ = _jax_abstract(arch, cut.get("repeats"))
    assert sum(int(x.size) for x in jax.tree.leaves(shapes)) == want
    cfg = dataclasses.replace(get_config(arch), **cut)
    assert tmodel.count_params(tmodel.init_params(cfg, device="meta")) == want


@pytest.mark.parametrize("layers", sorted(MIXTRAL_BITS))
def test_full_width_mixtral_lq_sgd_plans_bits_and_collectives_match_jax(layers):
    """Full-width mixtral (32 layers, and chip_smoke's 1): the training tree
    has the JAX tree's leaves, shapes and stacked flags, the untied (d, V)
    head among them; every leaf's plan (route, matrix shape, rank) is the
    JAX package's, the (L, E, d, f) expert leaves compressed per layer as
    (E d, f) matrices; LQ-SGD r1 b8 ships the JAX package's bits in its
    collectives."""
    jcfg, jabs, jflags = _jax_abstract("mixtral-8x7b", None if layers == 32 else layers)
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), repeats=layers)
    abstract, flags = abstract_grads_of(cfg)
    assert tree_leaves(flags) == jax.tree.leaves(jflags)
    for t, j in zip(tree_leaves(abstract), jax.tree.leaves(jabs), strict=True):
        assert tuple(t.shape) == tuple(j.shape)
    assert tuple(abstract["head"].shape) == (4096, 32000)
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
    w_up = next(p for p in plans if p.path.endswith("['w_up']"))
    assert w_up.shape == (layers, 8, 4096, 14336) and w_up.mat_shape == (8 * 4096, 14336)
    ccfg = dict(name="lq_sgd", rank=1, bits=8)
    jcomp = jax_make_compressor(JaxCompressorConfig(**ccfg), jabs, jflags)
    comp = make_model_compressor(cfg, CompressorConfig(**ccfg))
    bits = MIXTRAL_BITS[layers]
    assert comp.wire_bits_per_step() == jcomp.wire_bits_per_step() == bits
    assert comp.handler.group_collectives(comp.plans) == jax_collectives(jcomp, jabs)


@functools.cache
def _jax_sync(n):
    jcfg = jax_get_config("mixtral-8x7b", smoke=True)
    ccfg = JaxCompressorConfig(name="lq_sgd", rank=1, bits=8)
    jcomp = jax_step.make_model_compressor(jcfg, ccfg)

    def sync(g, st):
        out, st2, rec = jcomp.sync(g, st, AxisComm(("data",)))
        acct = (rec.effective_bits(), rec.effective_collectives())
        return out, st2, jnp.asarray(acct, jnp.float32)

    return jcomp, jit_o0(lambda g, st: simulate_workers(sync, n, g, st))


def test_two_worker_lq_sgd_step_on_mixtral_matches_the_composed_jax_step():
    """Mixtral smoke, 2 workers x 2 rows, LQ-SGD r1 b8, SGD: each worker's
    gradients into the sync and its loss and moe_aux against
    ``jax.value_and_grad(lm_loss)`` on its rows; then the JAX sync and
    update, fed the port's gradients, against the port's synced gradients,
    compressor state and parameters (within ``flip_tol``), bits and
    collectives exactly."""
    n, lr = 2, 0.05
    arch = "mixtral-8x7b"
    jcfg, cfg, pj, _ = zoo_models(arch)
    jcomp, jsync = _jax_sync(n)
    comp = make_model_compressor(cfg, CompressorConfig(name="lq_sgd", rank=1, bits=8))
    # the port's warm-start Q, carried into the JAX state's tree
    port0 = comp.init_state(1, n, "cpu")
    like = jax.eval_shape(jcomp.init_state, jax.random.PRNGKey(1))
    comp0 = jax.tree.unflatten(
        jax.tree.structure(like), [t[0].numpy() for t in tree_leaves(port0)]
    )
    tokens = np.concatenate([_tokens(cfg, seed=5), _tokens(cfg, seed=6)])
    rows = tokens.reshape(n, B, S)
    outs = [_jax_loss_grad(arch)(pj, jnp.asarray(r, jnp.int32)) for r in rows]
    seen = {}

    def on_sync(grads, synced, comp_state, rec):
        seen.update(grads=grads, synced=synced)

    state = dict(
        params=to_port(pj),
        opt={},
        comp=compressor_state_from_jax(to_numpy(comp0), n, "cpu"),
        step=torch.zeros((), dtype=torch.int32),
    )
    step = build_train_step(cfg, (n, 1), comp, port_opt.sgd(lr), on_sync=on_sync)
    got, m = step(state, {"tokens": torch.from_numpy(tokens)})
    for w, (_, g) in enumerate(outs):
        port_g = [t[w] for t in tree_leaves(seen["grads"])]
        assert_leaves_close(port_g, jax.tree.leaves(to_numpy(g)), f"worker {w}")
    for key in ("loss", "moe_aux"):
        want = np.mean([float(out[0][1][key]) for out in outs])
        np.testing.assert_allclose(float(m[key]), want, rtol=1e-5)
    port_grads = tree_map(lambda t: jnp.asarray(t.numpy()), seen["grads"])
    jgrads = jax.tree.unflatten(jax.tree.structure(pj), tree_leaves(port_grads))
    synced, jcomp_state, acct = jsync(jgrads, broadcast_state(comp0, n))
    synced = jax.tree.map(lambda x: x[0], synced)
    jopt = jax_opt.sgd(lr)
    want_params, _ = jopt.update(synced, jopt.init(pj), pj)
    tol = flip_tol(8, n)
    for label, a, b in (
        ("synced", seen["synced"], synced),
        ("comp", got["comp"], jcomp_state),
        ("params", got["params"], want_params),
    ):
        assert_leaves_close(a, to_numpy(b), label, atol_rel=tol)
    assert float(m["wire_mb_per_step"]) == np.float32(float(acct[0, 0]) / 8e6)
    assert float(m["collectives_per_step"]) == float(acct[0, 1])


def test_launchers_train_mixtral_and_serve_chameleon_at_smoke_widths():
    """``launch.train --arch mixtral-8x7b`` logs moe_aux with the loss;
    ``launch.serve --arch chameleon-34b`` prefills vq_tokens_stub's mixed
    image and text prompts and decodes."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = launch_train.main(
            "--arch mixtral-8x7b --smoke --device cpu --mesh 2x1 --batch 4 "
            "--seq 16 --steps 2 --log-every 1 --runtime sync".split()
        )
    assert len(res["history"]) == 2
    assert all(h["moe_aux"] > 0 for h in res["history"])
    assert "arch=mixtral-8x7b-smoke" in out.getvalue()
    cfg = get_config("chameleon-34b", smoke=True)
    tok = vq_tokens_stub(torch.Generator().manual_seed(0), 2, 8, cfg)
    assert (tok[:, :2] >= 256).all() and (tok[:, 2:] < 256).all()
    with contextlib.redirect_stdout(io.StringIO()):
        got = launch_serve.main(
            "--arch chameleon-34b --smoke --device cpu --batch 2 --prompt-len 8 "
            "--gen 3 --cache-bits 8".split()
        )
    assert tuple(got["tokens"].shape) == (2, 3) and got["bytes_per_token"] == 288.0
