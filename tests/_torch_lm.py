"""Shared helpers of the LM training parity tests (``test_torch_lm_train.py``,
``test_torch_runtime.py``): the config both frameworks train, the tokens,
the conversions and the stated tolerances."""

import dataclasses

import jax
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.data.synthetic import LMDataConfig as JaxLMData
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro_torch.configs import get_config
from repro_torch.core.tree import flatten_with_paths, tree_map
from repro_torch.weights import tensor_from_numpy

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
