"""The port's training with every compressor over a ``(data, model)`` mesh on
the CPU, against its one-process run and the JAX package.

ONE spawn of 4 gloo ranks (``_torch_tp_train_wire.py`` through
``_torch_dist.spawn``) trains gemma3-1b's f32 smoke config at 2x2 with
TopK, QSGD b4, LQ-SGD over the dlog (DP epsilon 48) and lrq b4 codecs, a
per-leaf policy of two lazy method groups (a warm-up step, elide and gate
mode, the adaptive thresholds in gate mode), and the server wire at
participation 0.5 (alone, and lazy with ``--agg sparsity``), and mixtral's
smoke config at 2x2 (its expert stacks split on the experts) with TopK and
a lazy LQ-SGD group, 3 SGD steps each, against the one-process port
(``SimComm`` of the data axis) on the same weights and batches:

- step 0's per-worker gradient of every leaf is the block of the
  one-process one (within 1e-5 of the leaf's largest value);
- the randomized codes (QSGD, dlog, lrq) at step 0 are the one process's
  but for the few that sit on a bin edge: each rank draws the whole
  tensor and keeps its block;
- every step's synced gradient, the final compressor state (error
  feedback, warm-start Q, the lazy cache, references, counters and drift
  tracker) and parameters within 1e-5 of the leaf's largest value, or
  what a moved code moves (:func:`_tol`);
- TopK keeps exactly k entries a worker and leaf over a data row's ranks;
  the lazy fire pattern is the one process's on every rank; each rank's
  participation flags are its data row's of the one process's;
- the accounted bits, collectives and DP epsilon are the one process's
  (and the JAX package's), and a data row's physical bits one process's
  plus (M - 1) x the bits replicated over the model axis;
- the new model-axis collectives (``tp.topk.cand``, ``tp.lazy.stats``,
  ``tp.lazy.drift``) run once a group and step.

In the same spawn: TopK and the lazy policy, one step from the JAX
package's state, against the JAX step composed from its parts; the lazy
policy's checkpoints through ``launch/train.py`` both ways across the
mesh; a time pin.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import _torch_dist as td
import _torch_tp_train as tt
import _torch_tp_train_wire as tw
import jax
import jax.numpy as jnp
import numpy as np
import test_torch_tp_train as ttt
from _torch_lm import ALPHA, zoo_models
from conftest import broadcast_state, simulate_workers

from repro.configs import get_config as jax_get_config
from repro.core import AxisComm
from repro.core import CompressorConfig as JaxCompressorConfig
from repro.train import optimizer as jax_opt
from repro.train import step as jax_step
from repro_torch.configs import get_config
from repro_torch.core.compressors import CompressorConfig, ModelSplit
from repro_torch.core.tree import flatten_with_paths
from repro_torch.launch import train as launch_train
from repro_torch.train.step import make_model_compressor

RANKS_S = 120  # the ranks' work, their imports excluded
F32_TOL = ttt.F32_TOL
LOSS_RTOL = ttt.LOSS_RTOL
MAX_FLIPS = ttt.MAX_FLIPS
DATA, MODEL = tw.MESH
PARAM_NS = ("err", "lazy_out", "lazy_ref")


@functools.cache
def _jax_sync(cname, n=DATA):
    """The JAX package's compressor of ``tw.CONFIGS[cname]`` on gemma3-1b
    smoke and its jitted sync over ``n`` vmap'd workers."""
    jcfg = jax_get_config(tw.GEMMA, smoke=True)
    jcomp = jax_step.make_model_compressor(
        jcfg, JaxCompressorConfig(**tw.CONFIGS[cname])
    )

    def sync(g, st):
        out, st2, _ = jcomp.sync(g, st, AxisComm(("data",)))
        return out, st2

    return jcomp, jax.jit(lambda g, st: simulate_workers(sync, n, g, st))


def _jax_step(weights, tokens, cname, jstate):
    """One JAX step of ``cname`` from ``jstate`` composed from its parts:
    per-worker gradients, the sync, SGD."""
    jcomp, jsync = _jax_sync(cname)
    vg = ttt._jax_parts(tw.GEMMA, "none", DATA)[2]
    jparams = jax.tree.map(jnp.asarray, weights)
    rows = np.asarray(tokens).reshape(DATA, tt.BATCH // DATA, tt.SEQ)
    outs = [vg(jparams, jnp.asarray(r)) for r in rows]
    grads = jax.tree.map(lambda *g: jnp.stack(g), *[g for _, g in outs])
    synced, _ = jsync(grads, broadcast_state(jstate, DATA))
    synced = jax.tree.map(lambda x: x[0], synced)
    jopt = jax_opt.sgd(tt.LR)
    params, _ = jopt.update(synced, jopt.init(jparams), jparams)
    host = functools.partial(jax.tree.map, np.asarray)
    # the static tier: a lazy round's payload is charged on its gate
    if getattr(jcomp, "lazy_groups", None):
        bits = jcomp.decision_bits_per_step()
    else:
        bits = jcomp.wire_bits_per_step()
    return dict(
        grads=host(grads),
        synced=host(synced),
        params=host(params),
        wire_bits=bits,
    )


@pytest.fixture(scope="module")
def wire_run(tmp_path_factory):
    """The inputs, the spawn, then the one-process and JAX references while
    the ranks run, and the resume of the ranks' checkpoint."""
    tmp = tmp_path_factory.mktemp("tp_train_wire")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        weights = {arch: zoo_models(arch)[2] for arch in tw.ARCHS}
        tokens = ttt._tokens()
        key = jax.random.PRNGKey(1)
        jstates = {
            c: jax.tree.map(np.asarray, _jax_sync(c)[0].init_state(key))
            for c in tw.JAX_RUNS
        }
        one_ckpt = str(tmp / "one.ckpt")
        one_argv = tw.LAUNCH_ARGS + ["--mesh", "2x1"]
        td.quiet_call(
            launch_train.main,
            one_argv
            + ["--steps", str(tw.CKPT_STEPS), "--ckpt-every", "1"]
            + ["--ckpt-path", one_ckpt],
        )
        inputs = dict(
            weights=weights,
            tokens=tokens,
            jax_q={"policy_jax": jstates["policy_jax"]["q"]},
            one_ckpt=one_ckpt,
        )
        inputs_path = str(tmp / "inputs.pt")
        torch.save(inputs, inputs_path)
        join = td.spawn(
            inputs_path,
            str(tmp),
            world=tw.WORLD,
            target=tw.run_rank,
            extra=(inputs_path,),
        )
        one = {
            run: tw.train(run[0], weights[run[0]], tokens, run[2], (DATA, 1))
            for run in tw.run_names()
        }
        jax_ref = {
            c: _jax_step(weights[tw.GEMMA], tokens[0], c, jstates[c])
            for c in tw.JAX_RUNS
        }
        uninterrupted, _ = td.quiet_call(
            launch_train.main, one_argv + ["--steps", str(tw.LAUNCH_STEPS)]
        )
        ranks = join()
        resumed, _ = td.quiet_call(
            launch_train.main,
            one_argv
            + ["--steps", str(tw.LAUNCH_STEPS), "--resume"]
            + ["--ckpt-path", str(tmp / "tp.ckpt")],
        )
    finally:
        torch.set_num_threads(n)
    return ranks, dict(
        one=one,
        jax=jax_ref,
        uninterrupted=uninterrupted["history"],
        resumed=resumed["history"],
    )


RUN_IDS = [f"{a}-{c}" for a, _, c in tw.run_names()]
RUNS = dict(zip(RUN_IDS, tw.run_names()))
LAZY_IDS = [i for i, r in RUNS.items() if "lazy_thresh" in str(tw.CONFIGS[r[2]])]
CODED_IDS = [i for i, r in RUNS.items() if r[2] in ("qsgd_b4", "dlog", "lrq_b4")]


def _fields(run):
    return tw.CONFIGS[run[2]]


def _plan(run):
    """The compressor of ``run`` on abstract shapes, the smoke config."""
    cfg = get_config(run[0], smoke=True)
    return make_model_compressor(cfg, CompressorConfig(**_fields(run)))


def _tol(run, steps=1):
    """What ``steps`` steps may move a value, relative to its leaf's
    largest: F32_TOL where no code moves (TopK, the f32 factors); where a
    worker's code flips by one step, twice what that moves the mean over
    the n workers of a round (one at the server's participation 0.5): one
    QSGD level, 1 / (n L), and a log code's scale (1 + alpha)^(s / (n L)) -
    1, s = 2 on lrq's coarser layer (L levels)."""
    f = _fields(run)
    if f["name"] == "topk":
        return F32_TOL
    n = 1 if f.get("topology") == "server" else DATA
    levels = (1 << (f.get("bits", 8) - 1)) - 1
    if f["name"] == "qsgd":
        return steps * 2 / (n * levels)
    s = 2 if f.get("codec") == "lrq" else 1
    return steps * 2 * ((1 + ALPHA) ** (s / (n * levels)) - 1)


def _close(got, want, label, tol):
    ttt._close(got, want, label, tol)


@pytest.mark.parametrize("name", RUN_IDS)
def test_step0_gradients_are_the_blocks_of_one_process(wire_run, name):
    ranks, ref = wire_run
    run = RUNS[name]
    ttt.check_step0_gradients(ranks, run, ref["one"][run], name)


@pytest.mark.parametrize("name", CODED_IDS)
def test_randomized_codes_are_one_process_at_step_0(wire_run, name):
    """QSGD's, dlog's and lrq's codes of step 0: each rank draws the whole
    tensor (all workers, the whole leaf or factor) and keeps its block, so
    its codes are the block of one process's, but for at most MAX_FLIPS on
    a bin edge (lrq's coarser layer moves such a code 2 steps)."""
    ranks, ref = wire_run
    run = RUNS[name]
    max_step = 2 if _fields(run).get("codec") == "lrq" else 1
    ttt.check_wire(
        ranks, run, ref["one"][run], run, name, fields=_fields(run), max_step=max_step
    )


def check_state(ranks, run, one, name, tol):
    """The final compressor state of every rank against the blocks of the
    one-process state: the param-shaped namespaces cut as their leaves, the
    per-worker ones at the rank's data row, the rest whole."""
    for res in ranks:
        r = res[run]
        d = r["coords"]["data"]
        assert set(r["comp"]) == set(one["comp"]), name
        for ns, sub in r["comp"].items():
            want = one["comp"][ns]
            if not isinstance(sub, dict):
                assert sub == want, (name, ns)
                continue
            for key, g in sub.items():
                w = want[key]
                label = f"{name} {ns} {key}"
                if ns == "lazy_stale":
                    assert torch.equal(g, w if g.dim() == 0 else w[d : d + 1]), label
                    continue
                if ns == "lazy_ema":
                    _close(g, w, label, tol)
                    continue
                dim = r["dims"][int(key)] if ns in PARAM_NS else None
                if ns == "lazy_out":  # no worker dim
                    _close(g, ttt._block(w, dim, r), label, tol)
                    continue
                w = w[d : d + 1]
                dim = None if dim is None else dim + 1
                _close(g, ttt._block(w, dim, r), label, tol)


@pytest.mark.parametrize("name", RUN_IDS)
def test_synced_state_and_parameters_close_to_one_process(wire_run, name):
    ranks, ref = wire_run
    run = RUNS[name]
    one = ref["one"][run]
    for res in ranks:
        r = res[run]
        for s in range(tt.STEPS):
            got = flatten_with_paths(r["recs"][s]["synced"])
            want = flatten_with_paths(one["recs"][s]["synced"])
            for (path, g), (_, w), dim in zip(got, want, r["dims"], strict=True):
                label = f"{name} step {s} synced {path}"
                _close(g, ttt._block(w, dim, r), label, _tol(run, s + 1))
        got, want = flatten_with_paths(r["params"]), flatten_with_paths(one["params"])
        for (path, g), (_, w), dim in zip(got, want, r["dims"], strict=True):
            label = f"{name} params {path}"
            _close(g, ttt._block(w, dim, r), label, _tol(run, tt.STEPS))
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=LOSS_RTOL)
    check_state(ranks, run, one, name, _tol(run, tt.STEPS))


@pytest.mark.parametrize("name", RUN_IDS)
def test_replicated_leaves_are_bit_identical_across_ranks(wire_run, name):
    ttt.check_replicated(wire_run[0], RUNS[name], name)


@pytest.mark.parametrize("name", [i for i, r in RUNS.items() if r[2] == "topk"])
def test_topk_keeps_k_entries_a_worker_and_leaf(wire_run, name):
    """Each TopK leaf a step: the entries a data row's model ranks keep of
    a split leaf sum to the whole leaf's k, and each keeps k of a whole
    one, as one process keeps k a worker."""
    ranks, ref = wire_run
    run = RUNS[name]
    one = ref["one"][run]["kept"]
    assert one and all(bool((c == k).all()) for k, c in one)
    dims = ranks[0][run]["dims"]
    leaves = [i for i, pl in enumerate(_plan(run).plans) if pl.route == "lowrank"]
    assert len(one) == len(leaves) * tt.STEPS
    rows = {}
    for res in ranks:
        r = res[run]
        assert [k for k, _ in r["kept"]] == [k for k, _ in one]
        rows.setdefault(r["coords"]["data"], []).append([c for _, c in r["kept"]])
    for d, got in rows.items():
        assert len(got) == MODEL
        for j, (k, _) in enumerate(one):
            if dims[leaves[j % len(leaves)]] is None:
                assert all(int(g[j]) == k for g in got), (name, d, j)
            else:
                assert int(sum(g[j] for g in got)) == k, (name, d, j)


@pytest.mark.parametrize("name", LAZY_IDS)
def test_lazy_fire_pattern_is_one_process_on_every_rank(wire_run, name):
    """The staleness counters after every step, whose 0s are the fired
    rounds: the one process's on every rank (its data row's on the server
    wire), in elide and gate mode; the pattern holds a skip."""
    ranks, ref = wire_run
    run = RUNS[name]
    one = [rec["stale"] for rec in ref["one"][run]["recs"]]
    assert any(int(v.max()) > 0 for st in one for v in st.values()), one
    for res in ranks:
        r = res[run]
        d = r["coords"]["data"]
        for s, (got, want) in enumerate(zip((x["stale"] for x in r["recs"]), one)):
            assert set(got) == set(want)
            for m, g in got.items():
                w = want[m] if g.dim() == 0 else want[m][d : d + 1]
                assert torch.equal(g, w), (name, s, m, g, w)


@pytest.mark.parametrize("name", [i for i, r in RUNS.items() if "server" in r[2]])
def test_participation_flags_are_the_data_rows(wire_run, name):
    """Each round's flags on a rank: its data row's of the one process's,
    the same on both model ranks of the row; some worker sat a round out."""
    ranks, ref = wire_run
    run = RUNS[name]
    one = ref["one"][run]["flags"]
    assert len(one) == tt.STEPS and not all(bool(f.all()) for f in one)
    for res in ranks:
        r = res[run]
        d = r["coords"]["data"]
        assert [f.tolist() for f in r["flags"]] == [f[d : d + 1].tolist() for f in one]


def _skipped(run, stale):
    """The lazy groups an elided round skipped (their counter not 0)."""
    f = _fields(run)
    if f.get("lazy_mode", "elide") != "elide" or f.get("topology") == "server":
        return []
    return [m for m, v in stale.items() if int(v) != 0]


@pytest.mark.parametrize("name", RUN_IDS)
def test_bits_collectives_and_epsilon_are_one_process(wire_run, name):
    """Every step: the accounted bits and the data-axis collectives the one
    process's; the physical bits of a data row's model ranks one process's
    plus (M - 1) x the bits replicated over the model axis (but a skipped
    lazy group's); the dedicated and the codec runs' bits and DP epsilon
    the JAX package's."""
    ranks, ref = wire_run
    run = RUNS[name]
    one = ref["one"][run]
    comp = _plan(run)
    split = ModelSplit(None, ranks[0][run]["dims"])
    rows = {}
    for res in ranks:
        r = res[run]
        assert r["wire_bits"] == one["wire_bits"] == comp.wire_bits_per_step()
        for s, rec in enumerate(r["recs"]):
            assert rec["bits"] == one["recs"][s]["bits"], (name, s)
            assert rec["colls"] == one["recs"][s]["colls"], (name, s)
            rows.setdefault((r["coords"]["data"], s), []).append(rec["phys"])
    for (d, s), got in rows.items():
        assert len(got) == MODEL
        skipped = _skipped(run, one["recs"][s]["stale"])
        if skipped:
            rep = comp.model_replicated_bits(split, skipped)
        else:
            rep = comp.model_replicated_bits(split)
        want = one["recs"][s]["phys"] + (MODEL - 1) * rep
        assert sum(got) == want, (name, d, s, sum(got), want)
    f = _fields(run)
    if run[0] == tw.GEMMA and "lazy_thresh" not in str(f) and "topology" not in f:
        jcomp = _jax_sync(run[2])[0]
        assert one["recs"][0]["bits"] == jcomp.wire_bits_per_step()
        eps = comp.privacy_epsilon_per_step()
        assert eps == jcomp.privacy_epsilon_per_step(), (eps, name)
        if f.get("codec") == "dlog":
            assert np.isfinite(eps) and eps > 0


def _split_groups(run, dims, lazy_only=True):
    """The method groups of ``run``'s composite holding a split leaf."""
    comp = _plan(run)
    groups = comp.lazy_groups if lazy_only else comp.groups
    return [m for m, idxs in groups.items() if any(dims[i] is not None for i in idxs)]


@pytest.mark.parametrize("name", RUN_IDS)
def test_new_model_axis_collectives_are_counted_a_step(wire_run, name):
    """``tp.topk.cand``: one gather a split TopK leaf and step;
    ``tp.lazy.stats``: one a lazy group holding a split leaf and step (on
    every rank, skipped rounds too); ``tp.lazy.drift``: one such a group
    and step with adaptive thresholds in gate mode; ``tp.scale``: one a
    QSGD phase with a split leaf and step."""
    run = RUNS[name]
    f = _fields(run)
    for res in wire_run[0]:
        r = res[run]
        calls, dims = r["model_calls"], r["dims"]
        comp = _plan(run)
        if f["name"] == "topk":
            n = sum(
                dims[i] is not None
                for i, pl in enumerate(comp.plans)
                if pl.route == "lowrank"
            )
            assert n > 0 and calls["tp.topk.cand"] == n * tt.STEPS, calls
        else:
            assert "tp.topk.cand" not in calls
        if "lazy_thresh" in str(f):
            groups = _split_groups(run, dims)
            assert groups and calls["tp.lazy.stats"] == len(groups) * tt.STEPS
            if "lazy_adaptive" in str(f):
                assert calls["tp.lazy.drift"] == len(groups) * tt.STEPS
        else:
            assert "tp.lazy.stats" not in calls and "tp.lazy.drift" not in calls
        if f["name"] == "qsgd":
            assert calls["tp.scale"] == tt.STEPS


@pytest.mark.parametrize("cname", tw.JAX_RUNS)
def test_one_step_from_the_jax_state_matches_the_jax_step(wire_run, cname):
    """gemma3-1b at 2x2, one step from the JAX package's state (TopK's zero
    error feedback; the lazy policy's warm-start Q), against the JAX step
    composed from its parts on the whole model: each worker's gradients
    (1e-5 of a leaf's largest value), the synced gradients and the
    parameters, the static bits."""
    ranks, ref = wire_run
    run = (tw.GEMMA, tw.MESH, cname)
    ttt.check_jax_step(ranks, ("jax", cname), ref["jax"][cname], run, _tol(run))


def test_lazy_checkpoints_resume_across_the_mesh(wire_run):
    """``launch/train.py`` with the lazy policy and a warm-up step: a 2x2
    checkpoint (lazy cache, references and counters in the one-process
    layout) resumed in one process, and a one-process checkpoint resumed on
    2x2, each equal to the uninterrupted one-process run; the launcher's
    first steps at 2x2 equal it too."""
    ranks, ref = wire_run
    whole = [h["loss"] for h in ref["uninterrupted"]]
    want = whole[tw.CKPT_STEPS :]
    got = [h["loss"] for h in ref["resumed"]]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    for res in ranks:
        got = [h["loss"] for h in res["launch"]["history"]]
        np.testing.assert_allclose(got, whole[: tw.CKPT_STEPS], rtol=LOSS_RTOL)
        got = [h["loss"] for h in res["resumed"]["history"]]
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert f"# resumed at step {tw.CKPT_STEPS}" in ranks[0]["resumed"]["printed"]


def test_tp_train_wire_file_stays_within_its_time(wire_run):
    for res in wire_run[0]:
        assert res["seconds"] < RANKS_S, res["seconds"]


def test_jax_is_not_imported_by_the_tp_train_wire_rank_helper():
    src = open(tw.__file__).read()
    assert "import jax" not in src and "from repro." not in src


class _OtherRank:
    """A model axis of 2 seen from rank 0: a gather stacks this rank's
    tensor and rank 1's ``other``."""

    size = 2

    def __init__(self, other):
        self.other, self.tags = other, []

    def all_gather(self, x, dim, tag):
        self.tags.append(tag)
        return torch.cat([x, self.other], dim)


def test_model_sum_completes_the_split_leaves_in_one_gather():
    """``lazy.model_sum``: a split leaf's part summed over the ranks, a
    whole leaf's kept, in one gather a call."""
    from repro_torch.core.lazy import model_sum

    mine = [torch.tensor([1.0, 2.0]), torch.tensor([5.0, 6.0])]
    mine.append(torch.tensor([3.0, 4.0]))
    other = torch.stack([torch.tensor([10.0, 20.0]), torch.tensor([30.0, 40.0])])
    comm = _OtherRank(other[None])
    got = model_sum(mine, [True, False, True], comm, "tp.lazy.stats")
    assert comm.tags == ["tp.lazy.stats"]
    assert torch.equal(got[0], torch.tensor([11.0, 22.0]))
    assert torch.equal(got[1], mine[1])
    assert torch.equal(got[2], torch.tensor([33.0, 44.0]))
    assert model_sum(mine, [False] * 3, comm, "x") == mine and len(comm.tags) == 1


@pytest.mark.parametrize("server", [False, True])
def test_a_split_leafs_decision_is_the_whole_leafs(server):
    """A lazy leaf split by columns over 2 model ranks whose innovation
    lies in rank 1's block: rank 0 decides as one process on the whole
    leaf does (it fires), through the model-axis sum of the statistics;
    on its block alone it would skip. A whole leaf beside it is not
    summed."""
    from repro_torch.core import lazy
    from repro_torch.core.comm import CommRecord, SimComm

    gen = torch.Generator().manual_seed(5)
    ref = torch.randn((2, 4, 8), generator=gen)
    x = ref.clone()
    x[:, :, 4:] += 3.0  # the innovation: rank 1's columns
    whole = torch.randn((2, 6), generator=gen)
    blocks = [(x[..., :4], ref[..., :4]), (x[..., 4:], ref[..., 4:])]
    stale = torch.zeros((2,) if server else (), dtype=torch.int32)
    args = dict(threshs=[0.5, 0.5], stale=stale, max_stale=4)

    def decide(xs, refs, **kw):
        if server:
            return lazy.worker_decision(xs, refs, **args, **kw)
        rec = CommRecord()
        return lazy.group_decision(xs, refs, comm=SimComm(2), rec=rec, **args, **kw)

    want = decide([x, whole], [ref, whole])
    innov1, norm1 = lazy._stats([blocks[1][0]], [blocks[1][1]], None, None)
    other = torch.stack([innov1[0], norm1[0]])[None, None]
    comm = _OtherRank(other)
    xs, refs = [blocks[0][0], whole], [blocks[0][1], whole]
    got = decide(xs, refs, model=comm, split=[True, False])
    alone = decide(xs, refs)
    assert comm.tags == ["tp.lazy.stats"]
    assert bool(want.fire.all()) and torch.equal(got.fire, want.fire)
    assert not bool(alone.fire.any())
