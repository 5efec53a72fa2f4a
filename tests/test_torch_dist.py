"""The port's data parallelism across processes, on the CPU over gloo.

One spawn of two gloo ranks (``_torch_dist.py``) does all of the ranks'
work, while this process computes the references; each case below asserts
one part of what they found:

* ``DistComm``'s primitives at 2 ranks x 2 local workers against the JAX
  package's ``AxisComm`` under ``simulate_workers`` (vmap) on the same
  numpy inputs: ``pmax``, ``all_gather``, ``fused_all_gather`` and
  ``fused_pmax`` exact, ``psum`` / ``pmean`` exact on integer-valued f32
  and within 1e-6 relative otherwise; and against ``SimComm(4)`` for
  worker order;
* two syncs of a small tree over 2 x 1 and 2 x 2 ranks against
  ``SimComm(N)``: LQ-SGD r1 b8, b8 with ``bits_q`` 4, b4 fused with
  ``dequant_then_mean``, PowerSGD, TopK, none, QSGD b4, dlog at a budget
  of 8, lrq b4, a per-leaf policy with a warm-up step, lazy groups (elide
  and gate: a fired round, then a skip) and the server wire at
  participation 0.5 with per-worker lazy decisions. Gathered arrays
  (codes, participation and contribution flags) bit-equal, and so are the
  synced gradients and the ranks' state rows where every leaf comes
  through a gather; PowerSGD, TopK, none and QSGD (whose raw leaves
  ``psum`` in the ring's order) within 1e-6 relative; every rank's synced
  gradients the same; lazy counters equal; bits and collectives the
  static accounting, and what a lazy group or the server wire lets
  through the planned figure;
* ``launch.train.main`` (gemma3-1b smoke, ``--mesh 4x1``, LQ-SGD r1 b8, 3
  steps) over the 2 ranks against the one-process run: history and
  parameters bit-equal, the replicas equal, rank 0 alone printing;
* a checkpoint written by the 2 ranks at step 2 resumed here to step 4,
  and one written here resumed by the ranks, each equal to 4 steps at
  once; the same for a lazy composite with a dlog group, whose shared
  leaves (the cached aggregate, the 0-dim counter) are written once;
* ``train_one`` on ResNet-18 (8x8, 2 workers x 2) over the ranks against
  ``SimComm(2)``;
* the refusals: a step over gloo in a CUDA graph, a data axis the ranks do
  not divide, ``DistComm`` without a group.

The references run on one thread, as the ranks do.
"""

import contextlib

import pytest

torch = pytest.importorskip("torch")

import _torch_dist as td
import jax
import jax.numpy as jnp
import numpy as np
from conftest import simulate_workers

from repro.core import AxisComm
from repro_torch.checkpoint.io import _is_rows
from repro_torch.core.comm import DistComm, SimComm
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.lazy import SERVER_DECISION_BITS_PER_GROUP
from repro_torch.core.tree import tree_leaves
from repro_torch.core.wire import PARTICIPATION_FLAG_BITS
from repro_torch.launch import train as launch_train
from repro_torch.train.data_parallel import train_one
from repro_torch.train.trainer import WORKER_ROWS

N_PRIM = 4  # 2 ranks x 2 local workers
PRIM_OPS = ("psum", "pmean", "pmax", "all_gather")
# LQ-SGD quantizes its raw leaves and gathers them, the lazy decision and
# the warm-up mean are taken locally over gathers: exact. PowerSGD, TopK,
# none and QSGD psum their raw leaves in f32, in the ring's order
EXACT_SYNCS = (
    "lq_sgd_b8",
    "lq_sgd_b8_q4",
    "lq_sgd_b4_fused_dtm",
    "dlog",
    "lrq",
    "policy",
    "lazy",
    "lazy_gate",
    "server",
)
PSUM_RTOL = 1e-6


@contextlib.contextmanager
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _inputs(rng, ckpt_parent, lazy_ckpt_parent):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    prims = {
        "float": t(rng.standard_normal((N_PRIM, 3, 5)).astype(np.float32)),
        "integer": t(rng.integers(-50, 50, (N_PRIM, 7)).astype(np.float32)),
        "codes": t(rng.integers(-127, 128, (N_PRIM, 9)).astype(np.int8)),
    }
    fused = tuple(
        t(rng.integers(-127, 128, (N_PRIM,) + s).astype(np.int8))
        for s in ((5,), (2, 3))
    )
    shapes, _ = td.small_tree()
    grads = {
        n: [
            {
                k: t(rng.standard_normal((n,) + s).astype(np.float32))
                for k, s in shapes.items()
            }
            for _ in range(td.SYNC_STEPS)
        ]
        for n in (td.WORLD, 2 * td.WORLD)
    }
    return dict(
        prims=prims,
        fused=fused,
        grads=grads,
        ckpt_parent=ckpt_parent,
        lazy_ckpt_parent=lazy_ckpt_parent,
    )


def _lm(argv, args=td.LM_ARGS):
    run, _ = td.quiet_call(launch_train.main, args + argv)
    return run


def _params(run):
    return [w.detach().clone() for w in tree_leaves(run["state"]["params"])]


def _jax_prims(prims, fused):
    comm = AxisComm(("data",))
    out = {}
    for name, x in prims.items():
        xj = jnp.asarray(x.numpy())
        ops = PRIM_OPS if x.is_floating_point() else ("all_gather",)
        for op in ops:
            y = simulate_workers(getattr(comm, op), N_PRIM, xj)
            out[name, op] = np.asarray(y)[0]  # what worker 0 holds
    a, b = (jnp.asarray(x.numpy()) for x in fused)
    out["fused_all_gather"] = [
        np.asarray(y)[0]
        for y in simulate_workers(
            lambda u, v: comm.fused_all_gather([u, v]), N_PRIM, a, b
        )
    ]
    out["fused_pmax"] = [
        np.asarray(y)[0]
        for y in simulate_workers(
            lambda u, v: comm.fused_pmax([u, v]),
            N_PRIM,
            a.astype(jnp.float32),
            b.astype(jnp.float32),
        )
    ]
    return out


def _sim_prims(prims, fused):
    comm = SimComm(N_PRIM)
    out = {}
    for name, x in prims.items():
        out[name] = {"all_gather": comm.all_gather(x)}
        if x.is_floating_point():
            for op in ("psum", "pmean", "pmax", "metric_mean"):
                out[name][op] = getattr(comm, op)(x)
    out["fused_all_gather"] = comm.fused_all_gather(list(fused))
    out["fused_pmax"] = comm.fused_pmax([x.float() for x in fused])
    return out


def _sim_syncs(grads):
    out = {}
    for k in (1, 2):
        n = k * td.WORLD
        for name, kw in td.SYNC_CFGS.items():
            comm = SimComm(n, record=True)
            comp = td.make_sync(kw)
            steps, state = td.run_syncs(comp, grads[n], comm)
            out[f"{name}_{td.WORLD}x{k}"] = dict(
                synced=[[x.clone() for x in tree_leaves(s)] for s, _ in steps],
                recs=[r for _, r in steps],
                state=state,
                gathered=[g.clone() for g in comm.gathered],
                planned=td.planned(comp),
            )
    return out


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    """Spawn the ranks; compute every reference while they run."""
    tmp = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(0)
    ckpt_parent = str(tmp / "parent.ckpt")
    lazy_ckpt_parent = str(tmp / "parent_lazy.ckpt")
    with _one_thread():
        more = ["--ckpt-every", str(td.CKPT_STEP), "--ckpt-path", ckpt_parent]
        _lm(["--steps", str(td.CKPT_STEP)] + more)
        more = ["--ckpt-every", str(td.CKPT_STEP), "--ckpt-path", lazy_ckpt_parent]
        run = _lm(["--steps", str(td.CKPT_STEP)] + more, td.LAZY_LM_ARGS)
        lazy2 = dict(history=run["history"], params=_params(run))
        inputs = _inputs(rng, ckpt_parent, lazy_ckpt_parent)
        inputs_path = str(tmp / "inputs.pt")
        torch.save(inputs, inputs_path)
        join = td.spawn(inputs_path, str(tmp))
        ref = dict(
            jax=_jax_prims(inputs["prims"], inputs["fused"]),
            sim=_sim_prims(inputs["prims"], inputs["fused"]),
            syncs=_sim_syncs(inputs["grads"]),
        )
        run = _lm(["--steps", str(td.LM_STEPS)])
        ref["lm_history"] = run["history"]
        ref["lm_params"] = _params(run)
        run = _lm(["--steps", str(td.RESUME_STEPS)])
        ref["lm4_history"] = run["history"]
        ref["lm4_params"] = _params(run)
        comm = SimComm(td.RESNET["n_workers"], record=True)
        synced = []
        out = train_one(
            CompressorConfig(name="lq_sgd", rank=1, bits=8),
            comm=comm,
            graph=False,
            on_sync=lambda step, g, st: synced.append(
                [x.clone() for x in tree_leaves(g)]
            ),
            **td.RESNET,
        )
        ref["resnet"] = dict(
            losses=out.losses,
            params=[p.detach().clone() for p in tree_leaves(out.params)],
            synced=synced,
            gathered=comm.gathered,
            bits=out.comp.wire_bits_per_step(),
            collectives=out.comp.handler.group_collectives(out.comp.plans),
        )
        run = _lm(["--steps", str(td.RESUME_STEPS)], td.LAZY_LM_ARGS)
        ref["lazy2"] = lazy2
        ref["lazy4"] = dict(history=run["history"], params=_params(run))
        ranks = join()
        resume = ["--resume", "--ckpt-path", str(tmp / "ranks.ckpt")]
        ref["lm_from_ranks"] = _params(_lm(["--steps", str(td.RESUME_STEPS)] + resume))
        resume = ["--resume", "--ckpt-path", str(tmp / "ranks_lazy.ckpt")]
        run = _lm(["--steps", str(td.RESUME_STEPS)] + resume, td.LAZY_LM_ARGS)
        ref["lazy_from_ranks"] = dict(history=run["history"], params=_params(run))
    ref["ckpt_parent"] = ckpt_parent
    return ranks, ref


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


def _close(a, b, rtol):
    for x, y in zip(a, b, strict=True):
        top = max(float(y.abs().max()), 1e-30)
        if float((x - y).abs().max()) > rtol * top:
            return False
    return True


# ------------------------------------------------------------ the primitives
@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize(
    "name, op",
    [(n, op) for n in ("float", "integer") for op in PRIM_OPS]
    + [("codes", "all_gather")],
)
def test_primitives_match_axis_comm(dist_run, name, op, rank):
    ranks, ref = dist_run
    got = ranks[rank][f"prim_{name}"][op].numpy()
    want = ref["jax"][name, op]
    assert got.shape == want.shape and got.dtype == want.dtype
    if op in ("psum", "pmean") and name == "float":
        np.testing.assert_allclose(got, want, rtol=PSUM_RTOL, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["fused_all_gather", "fused_pmax"])
def test_fused_primitives_match_axis_comm(dist_run, op):
    ranks, ref = dist_run
    for res in ranks:
        for got, want in zip(res[op], ref["jax"][op], strict=True):
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "name, op",
    [("float", op) for op in ("pmax", "all_gather", "metric_mean")]
    + [("integer", op) for op in ("psum", "pmean")]
    + [("codes", "all_gather")],
)
def test_primitives_in_simcomm_order(dist_run, name, op):
    """Global worker order (rank r's worker j is r*k + j) and the exact
    reductions, against ``SimComm(4)``: bit for bit."""
    ranks, ref = dist_run
    for res in ranks:
        assert torch.equal(res[f"prim_{name}"][op], ref["sim"][name][op])


def test_comm_rows_and_repr(dist_run):
    ranks, _ = dist_run
    assert [r["rows_8"] for r in ranks] == [slice(0, 4), slice(4, 8)]
    assert "backend=gloo" in ranks[0]["repr"] and "local_workers=2" in ranks[0]["repr"]
    assert "staged through host memory" in ranks[0]["repr"]


# ---------------------------------------------------------------- the syncs
SYNC_CASES = [f"{n}_{td.WORLD}x{k}" for k in (1, 2) for n in td.SYNC_CFGS]


def _rows_of(ns, key, v, rows):
    """This rank's part of SimComm's state leaf ``ns/key``: its workers'
    rows of a per-worker leaf, the whole of a shared one."""
    per_worker = _is_rows(WORKER_ROWS, f"['comp']['{ns}']['{key}']", v)
    return v[rows] if per_worker else v


def _accounts(recs):
    """The comparable part of ``run_syncs``' accounting: everything but the
    lazy counters, which are tensors."""
    return [acct[:4] for acct in recs]


@pytest.mark.parametrize("case", SYNC_CASES)
def test_sync_over_ranks_matches_simcomm(dist_run, case):
    ranks, ref = dist_run
    want = ref["syncs"][case]
    name = case.rsplit("_", 1)[0]
    k = int(case.rsplit("x", 1)[1])
    rows = [slice(r * k, (r + 1) * k) for r in range(td.WORLD)]
    for r, res in enumerate(ranks):
        got = res[f"sync_{case}"]
        # every gather on the wire: the (N, ...) stack in global order
        assert len(got["gathered"]) == len(want["gathered"])
        assert _equal(got["gathered"], want["gathered"]), f"rank {r}: gathers"
        for t, (g, w) in enumerate(zip(got["synced"], want["synced"], strict=True)):
            if name in EXACT_SYNCS:
                assert _equal(g, w), f"rank {r} step {t}: synced"
            else:
                assert _close(g, w, PSUM_RTOL), f"rank {r} step {t}: synced"
        # this rank's state rows: its workers' of SimComm's; shared leaves whole
        assert got["state"].keys() == want["state"].keys()
        for ns, sub in want["state"].items():
            if not isinstance(sub, dict):
                assert got["state"][ns] == sub, f"rank {r}: {ns}"
                continue
            for key, v in sub.items():
                mine, v = got["state"][ns][key], _rows_of(ns, key, v, rows[r])
                if name in EXACT_SYNCS:
                    assert torch.equal(mine, v), f"rank {r}: state {ns}/{key}"
                else:
                    assert _close([mine], [v], PSUM_RTOL)
        # the lazy counters after each step, and the accounting
        for t, (g, w) in enumerate(zip(got["recs"], want["recs"], strict=True)):
            assert g[4].keys() == w[4].keys()
            for m, c in w[4].items():
                want_c = c[rows[r]] if c.dim() else c
                assert torch.equal(g[4][m], want_c), f"rank {r} step {t}: stale"
        assert _accounts(got["recs"]) == _accounts(want["recs"])
        assert got["planned"] == want["planned"]
        if name not in td.FORMER_REFUSALS:
            fired, _ = got["planned"]
            assert _accounts(got["recs"]) == [fired + fired] * td.SYNC_STEPS
    # the replicas: every rank holds the same synced gradients
    a, b = (r[f"sync_{case}"]["synced"] for r in ranks)
    assert all(_equal(x, y) for x, y in zip(a, b, strict=True))


@pytest.mark.parametrize("name", td.FORMER_REFUSALS)
def test_former_refusals_sync_with_the_planned_accounting(dist_run, name):
    """Each compressor that raised across ranks before it was ported: no
    refusal, and each step's bits and collectives the static accounting.
    A lazy group fires at round 0 (its counter is born at the cap) and
    then skips, sending its decision alone; the server wire sends its two
    flags every round and the payload at the share of workers whose fresh
    upload reached the server (the step's second gather)."""
    ranks, _ = dist_run
    for k in (1, 2):
        for res in ranks:
            got = res[f"sync_{name}_{td.WORLD}x{k}"]
            assert got["refusal"] is None
            (bits, colls), (side, n_side) = got["planned"]
            per_step = len(got["gathered"]) // td.SYNC_STEPS
            for t, (b, c, eff_b, eff_c, stale) in enumerate(got["recs"]):
                if name == "server":
                    flags = got["gathered"][t * per_step + 1]
                    static = PARTICIPATION_FLAG_BITS + SERVER_DECISION_BITS_PER_GROUP
                    assert (b, c) == (static, colls + 1)
                    assert eff_b == static + float(flags.mean()) * (bits - side)
                    assert eff_c == c
                elif name.startswith("lazy"):
                    fired = (bits, colls) if t == 0 else (side, n_side)
                    assert (eff_b, eff_c) == fired, f"step {t}"
                    assert [int(x) for x in stale.values()] == [t]
                else:
                    assert (b, c, eff_b, eff_c) == (bits, colls, bits, colls)


# ------------------------------------------------------------- the launcher
def test_launcher_history_over_ranks_equals_one_process(dist_run):
    ranks, ref = dist_run

    def strip(h):
        return [{k: v for k, v in m.items() if k != "wall_s"} for m in h]

    assert len(ref["lm_history"]) == td.LM_STEPS
    for res in ranks:
        assert strip(res["lm_history"]) == strip(ref["lm_history"])


def test_launcher_params_over_ranks_equal_one_process(dist_run):
    ranks, ref = dist_run
    for res in ranks:
        assert _equal(res["lm_params"], ref["lm_params"])


def test_launcher_replicas_equal_across_ranks(dist_run):
    ranks, _ = dist_run
    a, b = ranks
    assert _equal(a["lm_params"], b["lm_params"])
    # the compressor state is per worker: each rank holds its own rows
    assert a["lm_comp"].keys() == b["lm_comp"].keys()
    for ns in a["lm_comp"]:
        for x in a["lm_comp"][ns]:
            assert x.shape[0] == 2


def test_launcher_prints_on_rank_zero_only(dist_run):
    ranks, _ = dist_run
    printed0, printed1 = (r["lm_printed"] for r in ranks)
    assert "# comm: DistComm(backend=gloo, world=2" in printed0
    assert "arch=gemma3-1b-smoke" in printed0
    assert sum(ln.startswith("step ") for ln in printed0.splitlines()) == td.LM_STEPS
    assert printed1 == ""


@pytest.mark.parametrize("direction", ["ranks_to_one", "one_to_ranks"])
def test_checkpoint_crosses_world_sizes(dist_run, direction):
    """A checkpoint written at step 2 by the 2 ranks (or by one process),
    resumed by one process (or by the ranks) to step 4, equals 4 steps at
    once, bit for bit."""
    ranks, ref = dist_run
    if direction == "ranks_to_one":
        assert _equal(ref["lm_from_ranks"], ref["lm4_params"])
    else:
        for res in ranks:
            assert _equal(res["lm_resumed_params"], ref["lm4_params"])
            got = [m["loss"] for m in res["lm_resumed_history"]]
            want = [m["loss"] for m in ref["lm4_history"][td.CKPT_STEP :]]
            assert got == want


@pytest.mark.parametrize("where", ["ranks", "one_process"])
def test_checkpoint_of_another_worker_count_raises(dist_run, where):
    """The 4-worker checkpoint resumed under ``--mesh 2x1`` (over the 2
    ranks, one worker each, or in one process) raises on every rank: no
    rank keeps 2 of the 4 workers' error feedback and warm-start Q."""
    ranks, ref = dist_run
    if where == "ranks":
        for res in ranks:
            msg = res["lm_resume_2x1"]
            assert msg is not None and "[4] workers in the checkpoint, 2 wanted" in msg
    else:
        resume = ["--resume", "--ckpt-path", ref["ckpt_parent"], "--mesh", "2x1"]
        with pytest.raises(ValueError, match="in the checkpoint"):
            _lm(["--steps", str(td.RESUME_STEPS)] + resume)


# -------------------------------------------------------------- the ResNet
@pytest.mark.parametrize("what", ["losses", "params", "synced", "gathered"])
def test_train_one_over_ranks_matches_simcomm(dist_run, what):
    ranks, ref = dist_run
    want = ref["resnet"]
    for res in ranks:
        got = res["resnet"]
        if what == "losses":
            assert got["losses"] == want["losses"]
        elif what == "params":
            assert _equal(got["params"], want["params"])
        elif what == "synced":
            for g, w in zip(got["synced"], want["synced"], strict=True):
                assert _equal(g, w)
        else:
            assert _equal(got["gathered"], want["gathered"])
            assert got["bits"] == [want["bits"]] * td.RESNET["steps"]
            assert got["collectives"] == [want["collectives"]] * td.RESNET["steps"]


# ------------------------------------------------- the lazy composite's run
@pytest.mark.parametrize("what", ["history", "params"])
def test_lazy_launcher_over_ranks_equals_one_process(dist_run, what):
    """``launch.train`` with a lazy composite and a dlog group: 2 steps
    over the ranks equal 2 in one process, bit for bit."""
    ranks, ref = dist_run
    for res in ranks:
        if what == "history":
            got, want = res["lazy_lm_history"], ref["lazy2"]["history"]
            assert [strip_wall(m) for m in got] == [strip_wall(m) for m in want]
        else:
            assert _equal(res["lazy_lm_params"], ref["lazy2"]["params"])


@pytest.mark.parametrize("direction", ["ranks_to_one", "one_to_ranks"])
def test_lazy_checkpoint_crosses_world_sizes(dist_run, direction):
    """The lazy composite's checkpoint at step 2 (its cached aggregate and
    symmetric counter written once, its references by worker) resumed to
    step 4 across world sizes equals 4 steps at once, a skipped round and
    the forced fire after it included."""
    ranks, ref = dist_run
    want = ref["lazy4"]
    tail = [strip_wall(m) for m in want["history"][td.CKPT_STEP :]]
    if direction == "ranks_to_one":
        got = [ref["lazy_from_ranks"]]
    else:
        got = [
            dict(
                history=r["lazy_lm_resumed_history"],
                params=r["lazy_lm_resumed_params"],
            )
            for r in ranks
        ]
    for g in got:
        assert _equal(g["params"], want["params"])
        assert [strip_wall(m) for m in g["history"]] == tail
    # the run fired, skipped and was forced to fire again
    fired = [m["collectives_per_step"] > 1 for m in want["history"]]
    assert fired[0] and not all(fired) and any(fired[1:])


def strip_wall(m):
    return {k: v for k, v in m.items() if k != "wall_s"}


# ------------------------------------------------------------ the refusals
def test_gloo_refuses_a_cuda_graph(dist_run):
    ranks, _ = dist_run
    assert "gloo" in ranks[0]["graph_refusal"]


def test_mesh_the_ranks_do_not_divide_raises(dist_run):
    ranks, _ = dist_run
    assert "data axis of 3 over 2 ranks" in ranks[0]["mesh_3"]


def test_distcomm_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        DistComm(2)


def test_dist_file_stays_within_its_time(dist_run):
    """The ranks' own work, from their rendezvous to their results."""
    ranks, _ = dist_run
    assert max(r["seconds"] for r in ranks) < td.JOIN_S


def test_jax_is_not_imported_by_the_rank_helper():
    src = open(td.__file__).read()
    assert "import jax" not in src and "from repro." not in src
