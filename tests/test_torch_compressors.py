"""The port's compressors against the JAX package's.

* Plans: for ResNet-18, the same leaves in the same (JAX flatten) order,
  with the same routes, matricized shapes and ranks.
* Threaded sync: none / powersgd / topk / lq_sgd for 3 steps on the pytree
  of ``benchmarks/comm_cost.py --check`` (a plain matrix, a bias, a stacked
  leaf), N = 2 workers, both sides starting from the JAX package's state
  (E = 0 and its warm-start Q). Exact: ``CommRecord`` bits and counts, and
  the static accounting. Within rtol 1e-5 / atol 1e-5 x max |g|: the synced
  outputs and the final E and Q (f32 matmuls sum in another order in the
  two frameworks, and that is carried through three steps).
* QSGD: statistically (unbiased over draws) and exact wire bits; its draws
  are the port's own.
* MB/epoch: the paper's table, equal to ``BENCH_comm_cost.json`` exactly.
"""

import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import AxisComm
from repro.core import CompressorConfig as JaxConfig
from repro.core import make_compressor as jax_make_compressor
from repro.core.compressors import TopKHandler as JaxTopK
from repro.models.resnet import init_resnet18 as jax_init_resnet18
from repro_torch.core.comm import SimComm
from repro_torch.core.compressors import (
    CompressorConfig,
    TopKHandler,
    _numel,
    make_compressor,
)
from repro_torch.core.tree import tree_map
from repro_torch.models.resnet import init_resnet18
from repro_torch.train.data_parallel import mb_per_epoch
from repro_torch.weights import compressor_state_from_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 2
SHAPES = {"w": (64, 32), "b": (32,), "scan": (3, 48, 16)}
STACKED = {"w": False, "b": False, "scan": True}


def _resnet_abstract(n_classes):
    return tree_map(
        lambda t: torch.empty(t.shape, device="meta"),
        init_resnet18(n_classes, device="cpu"),
    )


# -------------------------------------------------------------------- plans
@pytest.mark.parametrize("name", ["powersgd", "lq_sgd", "topk"])
def test_resnet18_plans_match_jax(name):
    """62 leaves, 21 low-rank at rank 1, in JAX flatten order."""
    jax_abs = jax.eval_shape(lambda: jax_init_resnet18(jax.random.PRNGKey(0), 10))
    want = jax_make_compressor(JaxConfig(name=name, rank=1), jax_abs).plans
    got = make_compressor(CompressorConfig(name=name, rank=1), _resnet_abstract(10)).plans
    assert len(got) == len(want) == 62
    assert sum(pl.route == "lowrank" for pl in got) == 21
    for g, w in zip(got, want):
        assert (g.path, g.shape, g.route, g.mat_shape, g.eff_rank, g.stacked) == (
            w.path,
            tuple(w.shape),
            w.route,
            w.mat_shape,
            w.eff_rank,
            w.stacked,
        )
    assert got[0].path == "['fc']['b']" and got[2].path == "['stage0'][0]['bn1']['bias']"


# ---------------------------------------------------------- threaded syncs
CASES = {
    "none": dict(name="none"),
    "powersgd": dict(name="powersgd"),
    "topk": dict(name="topk", topk_ratio=0.05),
    "lq_sgd_b8": dict(name="lq_sgd", bits=8),
    "lq_sgd_b4_fused": dict(name="lq_sgd", bits=4, fuse_collectives=True),
    "lq_sgd_b8_psum_sim_dtm": dict(
        name="lq_sgd", bits=8, wire_accounting="psum_sim", avg_mode="dequant_then_mean"
    ),
}


def _grads(step):
    rng = np.random.default_rng(100 + step)
    return {k: rng.standard_normal((N,) + s).astype(np.float32) for k, s in SHAPES.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_threaded_sync_matches_jax(case):
    kw = dict(rank=2, **CASES[case])
    abstract = {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in SHAPES.items()}
    jcomp = jax_make_compressor(JaxConfig(**kw), abstract, STACKED)
    j0 = jcomp.init_state(jax.random.PRNGKey(42))
    jrecs = []

    def worker(g, st):
        out, st2, rec = jcomp.sync(g, st, AxisComm(("data",)))
        jrecs.append(rec)
        return out, st2

    jstep = jax.jit(jax.vmap(worker, axis_name="data"))
    jstate = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (N,) + x.shape), j0)

    tabstract = {k: torch.empty(s, device="meta") for k, s in SHAPES.items()}
    tcomp = make_compressor(CompressorConfig(**kw), tabstract, STACKED)
    tstate = compressor_state_from_jax(jax.tree.map(np.asarray, j0), N, "cpu")
    assert tcomp.wire_bits_per_step() == jcomp.wire_bits_per_step()
    assert tcomp.physical_bits_by_method() == jcomp.physical_bits_by_method()

    for step in range(3):
        g = _grads(step)
        jout, jstate = jstep({k: jnp.asarray(v) for k, v in g.items()}, jstate)
        comm = SimComm(N)
        tout, tstate, rec = tcomp.sync(
            {k: torch.from_numpy(v) for k, v in g.items()}, tstate, comm
        )
        jrec = jrecs[0]
        assert (rec.bits_sent, rec.n_collectives) == (jrec.bits_sent, jrec.n_collectives)
        assert rec.bits_sent == tcomp.wire_bits_per_step()
        for k in SHAPES:
            w = np.asarray(jout[k])[0]
            np.testing.assert_allclose(
                tout[k].numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(g[k]).max()
            )
    for ns, sub in tstate.items():
        for key, t in sub.items():
            want = np.asarray(jstate[ns][key])
            assert tuple(t.shape) == want.shape
            np.testing.assert_allclose(
                t.numpy(), want, rtol=1e-5, atol=1e-5 * max(np.abs(want).max(), 1)
            )


def test_error_feedback_is_per_worker_and_q_shared():
    """After a sync each worker keeps its own E; Q is one value for all."""
    tabstract = {k: torch.empty(s, device="meta") for k, s in SHAPES.items()}
    comp = make_compressor(CompressorConfig(name="lq_sgd", rank=2), tabstract, STACKED)
    state = comp.init_state(0, N, "cpu")
    g = {k: torch.from_numpy(v) for k, v in _grads(0).items()}
    _, state, _ = comp.sync(g, state, SimComm(N))
    assert not torch.equal(state["err"]["2"][0], state["err"]["2"][1])
    assert torch.equal(state["q"]["2"][0], state["q"]["2"][1])


# ---------------------------------------------------------------------- QSGD
def test_qsgd_compressor_is_unbiased_and_its_bits_exact():
    """Statistical: averaged over 200 syncs, the synced matrix is within 2%
    (relative norm) of the true mean gradient; each sync's bits equal the
    static accounting, which equals the JAX package's; the step advances,
    so consecutive syncs draw differently."""
    kw = dict(name="qsgd", rank=2, bits=4)
    tabstract = {k: torch.empty(s, device="meta") for k, s in SHAPES.items()}
    comp = make_compressor(CompressorConfig(**kw), tabstract, STACKED)
    jabstract = {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in SHAPES.items()}
    assert comp.wire_bits_per_step() == (
        jax_make_compressor(JaxConfig(**kw), jabstract, STACKED).wire_bits_per_step()
    )
    g = {k: torch.from_numpy(v) for k, v in _grads(0).items()}
    state = comp.init_state(3, N, "cpu")
    acc = torch.zeros(SHAPES["w"])
    outs = []
    for _ in range(200):
        out, state, rec = comp.sync(g, state, SimComm(N))
        assert rec.bits_sent == comp.wire_bits_per_step()
        acc += out["w"]
        outs.append(out["w"])
    assert state["step"] == 200 and not torch.equal(outs[0], outs[1])
    want = g["w"].mean(0)
    assert float((acc / 200 - want).norm() / want.norm()) < 0.02


def test_qsgd_same_seed_same_sync():
    tabstract = {k: torch.empty(s, device="meta") for k, s in SHAPES.items()}
    comp = make_compressor(CompressorConfig(name="qsgd", bits=4), tabstract, STACKED)
    g = {k: torch.from_numpy(v) for k, v in _grads(1).items()}
    a, _, _ = comp.sync(g, comp.init_state(5, N, "cpu"), SimComm(N))
    b, _, _ = comp.sync(g, comp.init_state(5, N, "cpu"), SimComm(N))
    assert all(torch.equal(a[k], b[k]) for k in SHAPES)


# ------------------------------------------------------ composite routes
@pytest.mark.parametrize(
    "knob",
    [
        dict(policy="auto"),
        dict(warmup_steps=5),
        dict(lazy_thresh=0.5),
        dict(topology="server", participation=0.5),
        dict(codec="dlog"),
        dict(dp_epsilon=8.0),
    ],
    ids=["auto", "warmup", "lazy", "server", "codec-dlog", "dp-epsilon"],
)
def test_composite_routes_name_their_slice(knob):
    """Per-leaf policies, warm-up, lazy aggregation, server drop-out and the
    randomized codecs build the composite (the JAX package's routing)."""
    from repro_torch.core.composite import CompositeCompressor

    tabstract = {k: torch.empty(s, device="meta") for k, s in SHAPES.items()}
    comp = make_compressor(CompressorConfig(name="lq_sgd", **knob), tabstract, STACKED)
    assert isinstance(comp, CompositeCompressor)


# ------------------------------------------------------------- MB / epoch
DATASETS = {"CIFAR-10": (50_000, 10), "CIFAR-100": (50_000, 100), "MNIST": (60_000, 10)}


@pytest.mark.parametrize("dataset", sorted(DATASETS))
def test_mb_per_epoch_equals_the_committed_table(dataset):
    """Exact: the paper's Size column as ``BENCH_comm_cost.json`` holds it,
    5 workers x 128 per step, rank 1, b = 8; TopK at the ratio that matches
    PowerSGD's compressed-leaf wire under the sparse accounting."""
    want = json.loads((ROOT / "BENCH_comm_cost.json").read_text())["mb_per_epoch"]
    n_train, classes = DATASETS[dataset]
    abstract = _resnet_abstract(classes)
    ps = make_compressor(CompressorConfig(name="powersgd", rank=1), abstract)
    comp_plans = [pl for pl in ps.plans if pl.route == "lowrank"]
    ratio = sum(ps.handler.leaf_wire_bits(pl) for pl in comp_plans) / sum(
        _numel(pl.shape) * (32 + TopKHandler.index_bits(_numel(pl.shape)))
        for pl in comp_plans
    )
    assert TopKHandler.index_bits(4608) == JaxTopK.index_bits(4608)
    methods = {
        "sgd": CompressorConfig(name="none"),
        "powersgd": CompressorConfig(name="powersgd", rank=1),
        "topk": CompressorConfig(name="topk", topk_ratio=ratio),
        "lq_sgd": CompressorConfig(name="lq_sgd", rank=1, bits=8),
    }
    for m, cfg in methods.items():
        got = mb_per_epoch(make_compressor(cfg, abstract), n_train, 5 * 128)
        assert got == want[dataset][m], (dataset, m, got)
    if dataset == "CIFAR-10":
        lq = make_compressor(methods["lq_sgd"], abstract)
        assert lq.wire_bits_per_step() == 370136
