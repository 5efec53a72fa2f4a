"""Shared helpers of the LM training parity tests (``test_torch_lm_train.py``,
``test_torch_runtime.py``, the zoo's): the config both frameworks train, the
tokens, the conversions, the stated tolerances and a JAX sync's collective
count on abstract shapes."""

import dataclasses
import functools

import jax
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.core import AxisComm
from repro.data.synthetic import LMDataConfig as JaxLMData
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.models import model as jmodel
from repro.serving import kv_cache as jkv
from repro_torch.configs import get_config
from repro_torch.core.codec import unpack_nibbles
from repro_torch.core.tree import flatten_with_paths, tree_map
from repro_torch.serving import kv_cache as tkv
from repro_torch.weights import params_from_jax, tensor_from_numpy

ARCH = "gemma3-1b"
BATCH, SEQ = 8, 24
LR = 0.05
ALPHA = 10.0  # the log-quant codec's alpha (CompressorConfig's default)


def lm_configs():
    """The smoke config's widths with its local layer repeated twice in the
    scan and its global layer as the tail, in both frameworks: stacked scan
    leaves, an unstacked tail and both attention kinds, in 24 leaves."""
    jcfg, cfg = jax_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    local, glob = jcfg.pattern
    jcfg = dataclasses.replace(jcfg, pattern=(local,), repeats=2, tail=(glob,))
    local, glob = cfg.pattern
    cfg = dataclasses.replace(cfg, pattern=(local,), repeats=2, tail=(glob,))
    return jcfg, cfg


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def to_port(np_tree):
    return tree_map(lambda a: tensor_from_numpy(a, "cpu"), np_tree)


def lm_tokens(step=0, batch=BATCH, vocab=512):
    data = JaxLMData(vocab_size=vocab, seq_len=SEQ, batch=batch)
    return jax_lm_batch(data, step)["tokens"]


def assert_leaves_close(got, want, label, rtol=1e-4, atol_rel=1e-5):
    """Every leaf of ``got`` (tensors) within ``atol_rel`` x the leaf's max
    |x| of ``want`` (numpy), leaf for leaf in flatten order."""
    got_l = flatten_with_paths(got)
    want_l = jax.tree.leaves(want)
    assert len(got_l) == len(want_l), label
    for (path, g), w in zip(got_l, want_l):
        w = np.asarray(w, np.float32)
        g = g.detach().float().numpy()
        atol = atol_rel * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=label + path)


def flip_tol(bits, n):
    """LQ-SGD's wire codes flip by one step where the two frameworks' f32
    factors straddle a bin edge. A flip of one worker's code moves the mean
    code by 1/n level, which scales that factor entry by at most
    (1 + alpha)^(1 / (n L)), L = 2^(b-1) - 1 levels; the bound on what it
    moves (error feedback, synced gradient, parameters) is twice that,
    relative to the leaf's largest value."""
    levels = (1 << (bits - 1)) - 1
    return 2 * ((1 + ALPHA) ** (1 / (n * levels)) - 1)


def jax_collectives(jcomp, abstract):
    """The collectives of one JAX sync, counted while it is traced on
    abstract shapes under a vmap'd worker axis."""
    counts = []

    def one(g, st):
        out, _, rec = jcomp.sync(g, st, AxisComm(("data",)))
        counts.append(rec.effective_collectives())
        return out

    def per_worker(x):
        return jax.ShapeDtypeStruct((1,) + x.shape, x.dtype)

    grads = jax.tree.map(per_worker, abstract)
    state = jax.eval_shape(jcomp.init_state, jax.random.PRNGKey(0))
    states = jax.tree.map(per_worker, state)
    jax.eval_shape(jax.vmap(one, axis_name="data"), grads, states)
    return counts[0]


# The JAX references are compiled with LLVM's optimizations off: a quarter
# less compile time for the same arithmetic (the tests' tolerances hold).
jit_o0 = functools.partial(
    jax.jit,
    compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True,
    },
)


@functools.cache
def zoo_models(arch):
    """(jcfg, cfg, the JAX package's smoke params moved off their init (every
    leaf plus N(0, 0.05^2), numpy), the port's serving tree of them)."""
    jcfg, cfg = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    p = to_numpy(jmodel.init_params(jcfg, jax.random.PRNGKey(0)))
    leaves, tree = jax.tree.flatten(p)
    rng = np.random.default_rng(1)
    leaves = [
        a + (rng.standard_normal(a.shape) * 0.05).astype(a.dtype) for a in leaves
    ]
    pj = jax.tree.unflatten(tree, leaves)
    return jcfg, cfg, pj, params_from_jax(pj, cfg, device="cpu")


def cache_close(got, want, label):
    """A port cache tree against a JAX one, leaf by leaf: codes within one
    step (at most 8 flips), scales and raw leaves rtol 1e-4."""
    leaves_j = jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, jkv.QuantKV))
    leaves_t = [leaf for _, leaf in tkv.tree_leaves(got)]
    assert len(leaves_j) == len(leaves_t), label
    flips = 0
    for lj, lt in zip(leaves_j, leaves_t):
        if isinstance(lt, tkv.QuantKV):
            a, b = lt.codes, torch.from_numpy(np.array(lj.codes))
            if lt.bits <= 4:
                a, b = (unpack_nibbles(c, 2 * c.shape[-1]) for c in (a, b))
            diff = (a.int() - b.int()).abs()
            assert int(diff.max()) <= 1, label
            flips += int((diff > 0).sum())
            lj, lt = lj.scale, lt.scale
        w = np.asarray(lj, np.float32)
        atol = 1e-5 * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(lt.numpy(), w, rtol=1e-4, atol=atol, err_msg=label)
    assert flips <= 8, f"{label}: {flips} code flips"
