"""What the training step needs to be one CUDA-graph replay, held on the CPU.

The port's counterpart of the JAX launcher's jitted, donated,
rematerialized step (``train/step.py:TrainStep``, ``train_one``): the
donated sync equals the functional one bit for bit; rematerialization
leaves the gradients bit for bit as they were, and both stay within
``tests/_torch_lm.py``'s tolerance of the JAX step's ``remat_scan=True``
gradients; the step reads nothing on the host and updates its whole state
in place; QSGD's draws reproduce from a seed, stay unbiased with QSGD's
variance, and come out the same from the per-leaf generators a graph
registers and reseeds; ``graph=True`` on the CPU raises, and so does a
compressor the graph cannot hold yet. The graphs themselves run on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phases (d)-(f), (j)).
"""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from _torch_lm import (
    LR,
    assert_leaves_close,
    lm_configs,
    lm_tokens,
    to_numpy,
    to_port,
)

from repro.models.model import init_params as jax_init_params
from repro.train.loss import lm_loss as jax_lm_loss
from repro_torch.core.comm import SimComm
from repro_torch.core.compressors import CompressorConfig, make_compressor
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.train.data_parallel import (
    init_mini_cnn,
    mini_cnn_forward,
    train_one,
    worker_grads,
)
from repro_torch.train.loss import lm_loss
from repro_torch.train.optimizer import adam, sgd
from repro_torch.train.runtime import AsyncRunner, RuntimeConfig
from repro_torch.train.step import (
    build_train_step,
    init_train_state,
    make_model_compressor,
)

N = 3
# a stacked leaf (2 layers), a conv kernel, a matrix, and a bias (raw route)
SHAPES = {"s": (2, 24, 40), "c": (3, 3, 4, 8), "w": (48, 32), "b": (32,)}
STACKED = {"s": True, "c": False, "w": False, "b": False}
DONATED = {
    "lq_sgd_r1_b8": dict(name="lq_sgd", rank=1, bits=8),
    "lq_sgd_r1_b4": dict(name="lq_sgd", rank=1, bits=4),
    "powersgd_r2": dict(name="powersgd", rank=2),
    "topk": dict(name="topk", topk_ratio=0.05, min_compress_numel=64),
}
UNIFORM = ("none", "powersgd", "lq_sgd", "topk", "qsgd")


def _abstract():
    return {k: torch.empty(s, device="meta") for k, s in SHAPES.items()}


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {
        k: torch.from_numpy(rng.standard_normal((N,) + s).astype(np.float32))
        for k, s in SHAPES.items()
    }


def _tensor_leaves(tree):
    """The tensors of a state: a compressor's host numbers (QSGD's seed
    and step counter) are replaced, not updated in place."""
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _clone(state):
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, state)


@pytest.mark.parametrize("name", sorted(DONATED))
def test_donated_sync_equals_the_functional_sync(name):
    """Two syncs in a row (the second reads the first's error feedback and
    warm-start Q): the donated sync's synced gradients and new state equal
    the functional sync's bit for bit, its error feedback is the old
    tensor updated in place, and the functional sync leaves its state as
    it was."""
    comp = make_compressor(CompressorConfig(**DONATED[name]), _abstract(), STACKED)
    fun = comp.init_state(0, N, "cpu")
    don = _clone(fun)
    err_before = dict(don["err"])
    for step in range(2):
        g = _grads(step)
        old, kept = fun, _clone(fun)
        want, fun, _ = comp.sync(g, fun, SimComm(N))
        for a, b in zip(tree_leaves(old), tree_leaves(kept), strict=True):
            assert torch.equal(a, b), name
        got, don, _ = comp.sync(g, don, SimComm(N), donate=True)
        for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
            assert torch.equal(a, b), name
        for a, b in zip(tree_leaves(don), tree_leaves(fun), strict=True):
            assert torch.equal(a, b), name
    assert err_before and all(don["err"][k] is v for k, v in err_before.items())


def test_remat_gradients_are_bit_equal_and_match_the_jax_remat_step():
    """``remat=True`` recomputes each repeat of the scanned pattern in the
    backward: the loss and every gradient equal ``remat=False``'s bit for
    bit, and stay within ``assert_leaves_close``'s tolerance of the JAX
    package's ``lm_loss(..., remat_scan=True)`` gradients."""
    jcfg, cfg = lm_configs()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tokens = lm_tokens(batch=2)

    def jax_loss(p, t):
        return jax_lm_loss(p, {"tokens": t}, jcfg, remat_scan=True)

    (want_loss, _), want = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jparams, jnp.asarray(tokens)
    )
    params = tree_map(lambda t: t.requires_grad_(True), to_port(to_numpy(jparams)))
    got = {}
    for remat in (False, True):
        batch = {"tokens": torch.from_numpy(tokens)}
        loss, _ = lm_loss(params, batch, cfg, remat=remat)
        got[remat] = (loss.detach(), torch.autograd.grad(loss, tree_leaves(params)))
    assert torch.equal(got[True][0], got[False][0])
    for a, b in zip(got[True][1], got[False][1], strict=True):
        assert torch.equal(a, b)
    np.testing.assert_allclose(float(got[True][0]), float(want_loss), rtol=1e-5)
    assert_leaves_close(list(got[True][1]), jax.tree.leaves(to_numpy(want)), "remat")


class _NoHostReads:
    """Inside the block every way a tensor is read on the host raises: a
    CUDA graph holds none (the capture would fail, or freeze the value)."""

    NAMES = ("item", "tolist", "__float__", "__int__", "__bool__")

    def __enter__(self):
        self.saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}

        def refuse(*args, **kwargs):
            raise AssertionError("a host read inside the step body")

        for n in self.NAMES:
            setattr(torch.Tensor, n, refuse)

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(torch.Tensor, n, f)


@pytest.mark.parametrize("name", UNIFORM)
def test_lm_step_reads_nothing_on_the_host_and_updates_in_place(name):
    """The eager LM step (the body a graph captures, here on the CPU) with
    Adam over 2 workers: after a first step (the graph's eager warm-up,
    where cached host constants such as the codec's f32 ``log1p(alpha)``
    are made), no host read of a tensor in two more steps, and the state
    returned holds the very tensors passed in, updated in place."""
    _, cfg = lm_configs()
    comp = make_model_compressor(cfg, CompressorConfig(name=name, bits=4))
    opt = adam(1e-3)
    state = init_train_state(cfg, 0, opt, comp, 2, "cpu")
    leaves = _tensor_leaves(state)
    step = build_train_step(cfg, (2, 1), comp, opt, graph=False)
    state, _ = step(state, {"tokens": lm_tokens(0, batch=4)})
    with _NoHostReads():
        for t in (1, 2):
            state, metrics = step(state, {"tokens": lm_tokens(t, batch=4)})
    assert all(a is b for a, b in zip(_tensor_leaves(state), leaves, strict=True))
    assert int(state["step"]) == 3 and int(state["opt"]["t"]) == 3
    assert np.isfinite(float(metrics["loss"]))


@pytest.mark.parametrize("name", UNIFORM)
def test_resnet_step_body_reads_nothing_on_the_host(name):
    """The body ``train_one`` captures on the card (every worker's
    gradients, the donated sync, SGD with momentum in place), on the
    reference's 4-conv net: after an eager first step, no host read in two
    more, and the state stays in place."""
    params = init_mini_cnn(seed=0, device="cpu")
    params = tree_map(lambda t: t.requires_grad_(True), params)
    comp = make_compressor(CompressorConfig(name=name, bits=4), params)
    cstate = comp.init_state(7, 2, "cpu")
    opt = sgd(0.05, momentum=0.9)
    ostate = opt.init(params)
    before = _tensor_leaves((params, ostate, cstate))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 3, 8, 8, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, (2, 3)))
    comm = SimComm(2)

    def body(cstate, ostate):
        losses, grads = worker_grads(mini_cnn_forward, params, x, y)
        synced, cstate, _ = comp.sync(grads, cstate, comm, donate=True)
        comm.pmean(losses)
        return cstate, opt.update(synced, ostate, params)

    cstate, ostate = body(cstate, ostate)
    with _NoHostReads():
        for _ in range(2):
            cstate, ostate = body(cstate, ostate)
    after = _tensor_leaves((params, ostate, cstate))
    assert all(a is b for a, b in zip(after, before, strict=True))


def test_qsgd_generators_reproduce_and_a_graph_draws_what_eager_draws():
    """QSGD draws each leaf's rounding from a generator of (seed, step,
    leaf): two runs of three syncs from one seed are equal step by step,
    consecutive syncs draw differently, and a sync drawing from generators
    made once and reseeded with ``prng_seeds`` before each step (what a
    CUDA graph registers and reseeds between replays) equals the plain sync
    bit for bit, with ``next_host_state`` advancing the counter as ``sync``
    does."""
    comp = make_compressor(CompressorConfig(name="qsgd", bits=4), _abstract(), STACKED)
    runs = []
    for _ in range(2):
        state, outs = comp.init_state(5, N, "cpu"), []
        for _ in range(3):
            out, state, _ = comp.sync(_grads(0), state, SimComm(N), donate=True)
            outs.append(out)
        runs.append(outs)
        assert state["step"] == 3
    for a, b in zip(runs[0], runs[1]):
        assert all(torch.equal(a[k], b[k]) for k in SHAPES)
    assert not torch.equal(runs[0][0]["w"], runs[0][1]["w"])
    state = comp.init_state(5, N, "cpu")
    gens = {k: torch.Generator() for k in comp.prng_seeds(state)}
    assert set(gens) == {
        str(i) for i, pl in enumerate(comp.plans) if pl.route == "lowrank"
    }
    for want in runs[0]:
        for k, seed in comp.prng_seeds(state).items():
            gens[k].manual_seed(seed)
        got, after, _ = comp.sync(_grads(0), {**state, "gen": gens}, SimComm(N))
        assert all(torch.equal(got[k], want[k]) for k in SHAPES)
        state = comp.next_host_state(state)
        assert after["step"] == state["step"]


def test_qsgd_generators_are_unbiased_with_qsgd_variance():
    """Statistical, over 300 syncs of one gradient: the mean synced matrix
    is within 4 standard errors of the workers' mean everywhere, and the
    variance over draws matches QSGD's: each worker's code rounds up with
    probability frac(|x| L / s), a variance of frac (1 - frac) (s / L)^2,
    and the mean of N workers' has 1/N^2 of their sum (the empirical total
    within 10% of it)."""
    comp = make_compressor(CompressorConfig(name="qsgd", bits=4), _abstract(), STACKED)
    g = _grads(2)
    state = comp.init_state(11, N, "cpu")
    draws = []
    for _ in range(300):
        out, state, _ = comp.sync(g, state, SimComm(N), donate=True)
        draws.append(out["w"])
    draws = torch.stack(draws)
    x = g["w"]
    levels = 7
    scale = x.abs().amax()
    y = x.abs() / scale * levels
    frac = y - torch.floor(y)
    var = (frac * (1 - frac)).sum(0) * (scale / levels) ** 2 / N**2
    se = var.sqrt() / 300**0.5
    err = (draws.mean(0) - x.mean(0)).abs()
    assert bool((err <= 4 * se + 1e-6).all())
    ratio = float(draws.var(0, unbiased=True).sum() / var.sum())
    assert 0.9 < ratio < 1.1, ratio


def test_graph_true_on_the_cpu_raises():
    _, cfg = lm_configs()
    comp = make_model_compressor(cfg, CompressorConfig(name="lq_sgd"))
    state = init_train_state(cfg, 0, sgd(LR), comp, 2, "cpu")
    step = build_train_step(cfg, (2, 1), comp, sgd(LR), graph=True)
    with pytest.raises(ValueError, match="CUDA"):
        step(state, {"tokens": lm_tokens(batch=4)})
    with pytest.raises(ValueError, match="CUDA"):
        train_one(
            CompressorConfig(name="lq_sgd"),
            model="cnn",
            n_workers=2,
            batch=2,
            hw=8,
            steps=1,
            device="cpu",
            graph=True,
        )


@pytest.mark.parametrize(
    "knobs,refused",
    [
        (dict(name="lq_sgd"), False),
        (dict(name="qsgd"), False),
        (dict(name="lq_sgd", lazy_thresh=1.0), True),
        (dict(name="lq_sgd", warmup_steps=2), True),
        (dict(name="lq_sgd", topology="server"), True),
        (dict(name="topk", state_dtype="bfloat16"), True),
    ],
)
def test_a_step_the_graph_cannot_hold_yet_names_its_roadmap_item(knobs, refused):
    """The composite (lazy groups, schedules), the server wire and an error
    feedback stored in bf16 (not donated) are not graphed in this slice:
    ``graph_refusal()`` says why and names ROADMAP item 20; the uniform
    compressors over an f32 state are graphed."""
    comp = make_compressor(CompressorConfig(**knobs), _abstract(), STACKED)
    why = comp.graph_refusal()
    assert (why is not None) == refused
    if refused:
        assert "item 20" in why


def test_step_metrics_survive_the_next_step_and_async_reads_them_late():
    """A step's metrics are its own tensors, not buffers the next step
    overwrites (a replay's are copied out): read after the next step, they
    are what they were; ``AsyncRunner``, which reads each step's metrics one
    interval late, records what each step returned."""
    _, cfg = lm_configs()
    comp = make_model_compressor(cfg, CompressorConfig(name="lq_sgd"))
    step = build_train_step(cfg, (2, 1), comp, sgd(LR), graph=False)
    seen = []

    def recorded(state, batch):
        state, metrics = step(state, batch)
        seen.append((metrics, {k: float(v) for k, v in metrics.items()}))
        return state, metrics

    state = init_train_state(cfg, 0, sgd(LR), comp, 2, "cpu")
    runner = AsyncRunner(
        recorded,
        lambda i: {"tokens": lm_tokens(i, batch=4)},
        RuntimeConfig(steps=3, log_every=1, verbose=False),
    )
    runner.run(state)
    assert len(seen) == 3 and seen[0][1]["loss"] != seen[1][1]["loss"]
    for (metrics, at_once), logged in zip(seen, runner.history):
        assert {k: float(v) for k, v in metrics.items()} == at_once
        assert {k: logged[k] for k in at_once} == at_once


def test_step_graph_warms_up_once_then_captures_and_replays():
    """``StepGraph.run(1)`` once a step, as the training steps call it:
    the first step is the eager warm-up, the second is captured and
    replayed, the rest replay (the bookkeeping alone: no card here)."""
    from collections import Counter

    from repro_torch import graphs

    events = []

    class Graph:
        def replay(self):
            events.append("replay")

    sg = object.__new__(graphs.StepGraph)
    sg.__dict__.update(_graphs={}, _warmed=set(), capture_s=0.0)
    sg._warm_up = lambda: events.append("warm-up")
    sg._capture = lambda: (events.append("capture"), (Graph(), Counter()))[1]
    for _ in range(4):
        sg.run(1)
    assert events == ["warm-up", "capture", "replay", "replay", "replay"]
