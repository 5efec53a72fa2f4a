"""gemma3-1b's training tree and its wire accounting at full width, against
the JAX package, on abstract shapes only (nothing is allocated).

The compressor plans, scales, counts bits and collectives per leaf, so the
port's training tree must be the JAX package's: the JAX ``abstract_grads_of``
against the port's ``meta`` tree, 90 leaves of the same paths, shapes,
dtypes and stacked flags, 999,826,048 parameters (hf:google/gemma-3-1b-pt's
widths). Each compressor's ``wire_bits_per_step`` equals the JAX package's
and the figure below exactly; its collectives a step equal those the JAX
sync issues while it is traced on the abstract shapes.
"""

import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs import get_config as jax_get_config
from repro.core import AxisComm
from repro.core import CompressorConfig as JaxCompressorConfig
from repro.train import step as jax_step
from repro_torch.configs import get_config
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.tree import flatten_with_paths, tree_leaves
from repro_torch.train.step import abstract_grads_of, make_model_compressor

ARCH = "gemma3-1b"
# the JAX package's wire_bits_per_step of each compressor at full width
FULL_WIDTH_BITS = {
    "none": (dict(name="none"), 31_994_433_536),
    "lq_sgd_r1_b8": (dict(name="lq_sgd", rank=1, bits=8), 9_236_960),
    "lq_sgd_r1_b4": (dict(name="lq_sgd", rank=1, bits=4), 4_624_864),
    "qsgd_b4": (dict(name="qsgd", bits=4), 4_001_392_352),
}


def _jax_collectives(jcomp, abstract):
    """The collectives of one JAX sync, counted while tracing it on
    abstract shapes under a vmap'd worker axis (nothing is computed)."""
    counts = []

    def one(g, st):
        out, _, rec = jcomp.sync(g, st, AxisComm(("data",)))
        counts.append(rec.effective_collectives())
        return out

    grads = jax.tree.map(lambda x: jax.ShapeDtypeStruct((1,) + x.shape, x.dtype), abstract)
    state = jax.eval_shape(jcomp.init_state, jax.random.PRNGKey(0))
    state = jax.tree.map(lambda x: jax.ShapeDtypeStruct((1,) + x.shape, x.dtype), state)
    jax.eval_shape(jax.vmap(one, axis_name="data"), grads, state)
    return counts[0]


@pytest.fixture(scope="module")
def full_width():
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    jabs, jflags = jax_step.abstract_grads_of(jcfg)
    return jcfg, cfg, jabs, jflags


def test_full_width_training_tree_is_the_jax_layout(full_width):
    """gemma3-1b at full width, shapes only: the port's training tree has
    the JAX tree's 90 leaves, paths, shapes, dtypes and stacked flags."""
    _, cfg, jabs, jflags = full_width
    abstract, flags = abstract_grads_of(cfg)
    jleaves = jax.tree_util.tree_flatten_with_path(jabs)[0]
    leaves = flatten_with_paths(abstract)
    assert len(leaves) == len(jleaves) == 90
    for (path, t), (jpath, j) in zip(leaves, jleaves):
        assert path == jax.tree_util.keystr(jpath)
        assert tuple(t.shape) == tuple(j.shape) and t.device.type == "meta"
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
    assert tree_leaves(flags) == jax.tree.leaves(jflags)
    assert sum(t.numel() for t in tree_leaves(abstract)) == 999_826_048


@pytest.mark.parametrize("name", sorted(FULL_WIDTH_BITS))
def test_full_width_wire_bits_and_collectives_match_jax(full_width, name):
    jcfg, cfg, jabs, _ = full_width
    ccfg, bits = FULL_WIDTH_BITS[name]
    jcomp = jax_step.make_model_compressor(jcfg, JaxCompressorConfig(**ccfg))
    comp = make_model_compressor(cfg, CompressorConfig(**ccfg))
    assert comp.wire_bits_per_step() == jcomp.wire_bits_per_step() == bits
    assert comp.handler.group_collectives(comp.plans) == _jax_collectives(jcomp, jabs)
