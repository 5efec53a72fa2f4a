"""The port's LM training step against the JAX package's, on the CPU.

At gemma3-1b's smoke widths in f32, with a tail layer and two repeats of
its scan pattern, so the training tree has lead/scan/tail leaves as the
full model does: the same numpy tokens and the JAX package's init go
through both frameworks. Tolerances, all at f32:

* tokens, wire bits, collectives and counters: exact;
* loss: rtol 1e-5; gradients, and synced gradients, compressor state and
  parameters where the sync gets the same gradients: within 1e-5 of each
  leaf's largest value (rtol 1e-4), the two frameworks' f32 matmuls
  summing in other orders;
* a whole LQ-SGD step of each framework from its own gradients: within
  :func:`flip_tol` (a wire code may flip by one step at a bin edge);
* QSGD draws from the port's own generators: its wire bits exactly, and
  its synced gradient within one quantization step of the exact mean.

The full-width training tree and its accounting are held in
``tests/test_torch_lm_layout.py``.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from _torch_lm import (
    BATCH,
    LR,
    SEQ,
    assert_leaves_close,
    flip_tol,
    lm_configs,
    lm_tokens,
    to_numpy,
    to_port,
)
from conftest import broadcast_state, simulate_workers

from repro.core import AxisComm
from repro.core import CompressorConfig as JaxCompressorConfig
from repro.data.synthetic import LMDataConfig as JaxLMData
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.models.model import init_params as jax_init_params
from repro.train import optimizer as jax_opt
from repro.train import step as jax_step
from repro.train.loss import lm_loss as jax_lm_loss
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.comm import SimComm
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.data.synthetic import LMDataConfig, lm_batch
from repro_torch.train import optimizer as port_opt
from repro_torch.train.loss import lm_loss
from repro_torch.train.step import (
    abstract_grads_of,
    build_train_step,
    make_model_compressor,
)
from repro_torch.weights import compressor_state_from_jax

COMPRESSORS = {
    "none": dict(name="none"),
    "powersgd": dict(name="powersgd", rank=2),
    "lq_sgd_b8": dict(name="lq_sgd", rank=1, bits=8),
    "lq_sgd_b4": dict(name="lq_sgd", rank=1, bits=4),
}
@pytest.mark.parametrize(
    "alpha, client", [(0.0, None), (0.3, 0), (0.3, 3)], ids=["iid", "c0", "c3"]
)
def test_lm_batch_tokens_equal_the_jax_package(alpha, client):
    for step in (0, 7):
        want = jax_lm_batch(
            JaxLMData(vocab_size=1000, seq_len=40, batch=3, noniid_alpha=alpha),
            step,
            client=client,
        )["tokens"]
        got = lm_batch(
            LMDataConfig(vocab_size=1000, seq_len=40, batch=3, noniid_alpha=alpha),
            step,
            client=client,
        )["tokens"]
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@functools.cache
def _jax_value_and_grad():
    """The JAX package's ``lm_loss`` and its gradient, jitted once."""
    jcfg, _ = lm_configs()

    def f(p, tokens):
        return jax_lm_loss(p, {"tokens": tokens}, jcfg)

    return jax.jit(jax.value_and_grad(f, has_aux=True))


@pytest.mark.parametrize("head_chunk", [0, 8])
def test_lm_loss_value_and_grads_match_jax(head_chunk):
    """The port's loss, whole and by head chunks of 8 positions, against
    the JAX package's whole loss (its chunked path is the same value)."""
    jcfg, cfg = lm_configs()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tokens = lm_tokens(batch=2)
    (want_loss, _), want_grads = _jax_value_and_grad()(jparams, jnp.asarray(tokens))
    params = tree_map(lambda t: t.requires_grad_(True), to_port(to_numpy(jparams)))
    loss, metrics = lm_loss(
        params, {"tokens": torch.from_numpy(tokens)}, cfg, head_chunk=head_chunk
    )
    grads = torch.autograd.grad(loss, tree_leaves(params))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert metrics["ce"] is metrics["loss"] is loss
    assert_leaves_close(list(grads), jax.tree.leaves(to_numpy(want_grads)), "grad")


@functools.cache
def _jax_sync(name, n):
    """The JAX compressor's sync over n vmap'd workers (``simulate_workers``),
    jitted: (per-worker grads, state) -> (synced, state, [bits, colls])."""
    jcfg, _ = lm_configs()
    jcomp = jax_step.make_model_compressor(
        jcfg, JaxCompressorConfig(**COMPRESSORS[name])
    )

    def sync(g, st):
        out, st2, rec = jcomp.sync(g, st, AxisComm(("data",)))
        acct = (rec.effective_bits(), rec.effective_collectives())
        return out, st2, jnp.asarray(acct, jnp.float32)

    return jcomp, jax.jit(lambda g, st: simulate_workers(sync, n, g, st))


@pytest.mark.parametrize("name", sorted(COMPRESSORS))
def test_one_step_on_four_workers_matches_the_composed_jax_step(name):
    """N = 4: the JAX step from its parts. Each worker's
    ``jax.value_and_grad(lm_loss)`` on its rows against the gradients the
    port's step feeds its sync; then the JAX ``compressor.sync`` under
    vmap'd workers and ``optimizer.update``, fed those same gradients,
    against the port's synced gradients, compressor state and parameters:
    within 1e-5 of each leaf's largest value, or :func:`flip_tol` for
    LQ-SGD, whose factors the two frameworks' matmuls round apart, so a
    code on a bin edge may still flip."""
    n = 4
    jcfg, cfg = lm_configs()
    jcomp, jsync = _jax_sync(name, n)
    comp = make_model_compressor(cfg, CompressorConfig(**COMPRESSORS[name]))
    jopt = jax_opt.sgd(LR)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    comp0 = jcomp.init_state(jax.random.PRNGKey(1))
    tokens = lm_tokens()
    rows = tokens.reshape(n, BATCH // n, SEQ)
    jgrad = _jax_value_and_grad()
    outs = [jgrad(jparams, jnp.asarray(r)) for r in rows]
    seen = {}

    def on_sync(grads, synced, comp_state, rec):
        seen.update(grads=grads, synced=synced, comp=comp_state)

    state = dict(
        params=to_port(to_numpy(jparams)),
        opt={},
        comp=compressor_state_from_jax(to_numpy(comp0), n, "cpu"),
        step=torch.zeros((), dtype=torch.int32),
    )
    step = build_train_step(cfg, (n, 1), comp, port_opt.sgd(LR), on_sync=on_sync)
    got, m = step(state, {"tokens": tokens})
    # the gradients into the sync, worker by worker
    for w, (_, g) in enumerate(outs):
        port_g = [t[w] for t in tree_leaves(seen["grads"])]
        want_g = jax.tree.leaves(to_numpy(g))
        assert_leaves_close(port_g, want_g, f"{name} worker {w} grads")
    want_loss = np.mean([float(loss) for (loss, _), _ in outs])
    np.testing.assert_allclose(float(m["loss"]), want_loss, rtol=1e-5)
    # the JAX sync and update on the port's gradients
    port_grads = tree_map(lambda t: t.numpy(), seen["grads"])
    jgrads = jax.tree.unflatten(
        jax.tree.structure(jparams),
        [jnp.asarray(a) for a in tree_leaves(port_grads)],
    )
    synced, jcomp_state, acct = jsync(jgrads, broadcast_state(comp0, n))
    synced = jax.tree.map(lambda x: x[0], synced)
    want_params, _ = jopt.update(synced, jopt.init(jparams), jparams)
    ccfg = COMPRESSORS[name]
    tol = flip_tol(ccfg["bits"], n) if ccfg["name"] == "lq_sgd" else 1e-5
    for label, a, b in (
        ("synced", seen["synced"], synced),
        ("comp", got["comp"], jcomp_state),
        ("params", got["params"], want_params),
    ):
        assert_leaves_close(a, to_numpy(b), f"{name} {label}", atol_rel=tol)
    assert float(m["wire_mb_per_step"]) == np.float32(float(acct[0, 0]) / 8e6)
    assert float(m["collectives_per_step"]) == float(acct[0, 1])
    assert int(got["step"]) == 1


def test_qsgd_step_ships_the_jax_bits_within_one_quantization_step():
    """QSGD b4 on 4 workers: the port draws its own rounding, so the step
    is held on its wire bits (the JAX package's, exactly) and on the
    synced gradient, within one quantization step (scale / 7) of the exact
    mean of the workers' gradients in every leaf."""
    n = 4
    jcfg, cfg = lm_configs()
    ccfg = dict(name="qsgd", bits=4)
    jcomp = jax_step.make_model_compressor(jcfg, JaxCompressorConfig(**ccfg))
    comp = make_model_compressor(cfg, CompressorConfig(**ccfg))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    seen = {}

    def on_sync(grads, synced, comp_state, rec):
        seen.update(grads=grads, synced=synced, bits=rec.effective_bits())

    params = to_port(to_numpy(jparams))
    state = dict(
        params=params,
        opt={},
        comp=comp.init_state(0, n, "cpu"),
        step=torch.zeros((), dtype=torch.int32),
    )
    step = build_train_step(cfg, (n, 1), comp, port_opt.sgd(LR), on_sync=on_sync)
    _, m = step(state, {"tokens": lm_tokens()})
    assert seen["bits"] == comp.wire_bits_per_step() == jcomp.wire_bits_per_step()
    assert float(m["wire_mb_per_step"]) == np.float32(seen["bits"] / 8e6)
    flags = tree_leaves(abstract_grads_of(cfg)[1])
    for g, s, stacked in zip(
        tree_leaves(seen["grads"]), tree_leaves(seen["synced"]), flags
    ):
        mean = g.mean(0)
        dims = tuple(range(2, g.dim())) if stacked else tuple(range(1, g.dim()))
        scale = g.abs().amax(dim=dims).amax(0) if dims else g.abs().amax()
        if stacked:
            scale = scale.reshape((-1,) + (1,) * (g.dim() - 2))
        assert bool(((s - mean).abs() <= scale / 7 * (1 + 1e-5)).all())


def test_accum_one_is_the_single_pass_bit_for_bit():
    """``accum_steps=1`` is one gradient pass a worker, the same arithmetic
    as a loss, ``autograd.grad``, sync and update written out."""
    n = 2
    jcfg, cfg = lm_configs()
    comp = make_model_compressor(cfg, CompressorConfig(name="lq_sgd", rank=1))
    jparams = to_numpy(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tokens = lm_tokens(batch=4)
    states = [
        dict(
            params=to_port(jparams),
            opt={},
            comp=comp.init_state(3, n, "cpu"),
            step=torch.zeros((), dtype=torch.int32),
        )
        for _ in range(2)
    ]
    got, _ = build_train_step(cfg, (n, 1), comp, port_opt.sgd(LR), accum_steps=1)(
        states[0], {"tokens": tokens}
    )
    ref = states[1]
    leaves = [t.requires_grad_(True) for t in tree_leaves(ref["params"])]
    rows = torch.from_numpy(tokens).reshape(n, -1, SEQ)
    per = [
        torch.autograd.grad(lm_loss(ref["params"], {"tokens": r}, cfg)[0], leaves)
        for r in rows
    ]
    grads = tree_unflatten(ref["params"], [torch.stack(gs) for gs in zip(*per)])
    synced, _, _ = comp.sync(grads, ref["comp"], SimComm(n))
    port_opt.sgd(LR).update(synced, {}, ref["params"])
    for a, b in zip(tree_leaves(got["params"]), tree_leaves(ref["params"])):
        assert torch.equal(a, b)


def test_adam_matches_jax_over_five_steps():
    """Adam's moments, step count and parameters against the JAX package's
    ``adam`` over 5 steps of the same numpy gradients (rtol 1e-6: the bias
    corrections are f32 powers in both)."""
    rng = np.random.default_rng(0)
    shapes = {"w": (16, 8), "b": (8,), "s": (3, 4, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jopt = jax_opt.adam(1e-2, weight_decay=0.01)
    opt = port_opt.adam(1e-2, weight_decay=0.01)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = opt.init(tp)
    assert ts["t"].dtype == torch.int32 and ts["m"]["w"].dtype == torch.float32
    for step in range(5):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        ts = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        assert int(ts["t"]) == int(js["t"]) == step + 1
        for k in shapes:
            pairs = ((tp[k], jp[k]), (ts["m"][k], js["m"][k]), (ts["v"][k], js["v"][k]))
            for got, want in pairs:
                np.testing.assert_allclose(
                    got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7
                )
