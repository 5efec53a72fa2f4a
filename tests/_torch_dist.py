"""The rank side of ``test_torch_dist.py``: what each spawned process of a
gloo process group runs, and the spawn itself.

A rank imports ``torch`` and the port, never JAX: the parent makes the
inputs with numpy, writes them with ``torch.save``, spawns the ranks (the
``spawn`` start method), and reads back what each rank wrote to
``<out>/rank<r>.pt``. The ranks rendezvous through a ``FileStore`` under
the test's temporary directory (no TCP port to collide on under
pytest-xdist), run on one thread each (the parent computes its
references on one thread too: a CPU convolution's gradient rounds
differently on more), and every join has its own deadline.
"""

import contextlib
import io
import multiprocessing as mp
import os
import time

import torch
import torch.distributed as dist

WORLD = 2
JOIN_S = 240  # a rank that has not exited by then fails the test
SEED = 5

# the syncs of the tests: the compressor configs (CompressorConfig fields)
SYNC_CFGS = {
    "lq_sgd_b8": dict(name="lq_sgd", rank=1, bits=8),
    "lq_sgd_b8_q4": dict(name="lq_sgd", rank=1, bits=8, bits_q=4),
    "lq_sgd_b4_fused_dtm": dict(
        name="lq_sgd",
        rank=1,
        bits=4,
        fuse_collectives=True,
        avg_mode="dequant_then_mean",
    ),
    "powersgd": dict(name="powersgd", rank=1),
    "topk": dict(name="topk", topk_ratio=0.25),
    "none": dict(name="none"),
}
SYNC_STEPS = 2
# the compressors over several ranks that raise, naming ROADMAP item 15
REFUSED_CFGS = {
    "qsgd": dict(name="qsgd", bits=4),
    "dlog": dict(name="lq_sgd", rank=1, codec="dlog", dp_epsilon=8.0),
    "lrq": dict(name="lq_sgd", rank=1, bits=4, codec="lrq"),
    "policy": dict(name="lq_sgd", policy="w=powersgd,*=lq_sgd:bits=8"),
    "lazy": dict(name="lq_sgd", rank=1, lazy_thresh=2.0),
    "server": dict(name="lq_sgd", rank=1, topology="server"),
}

# launch.train over the ranks (every rank's argv; the one-process runs in
# the parent take the same)
LM_ARGS = [
    "--arch", "gemma3-1b", "--smoke", "--device", "cpu", "--mesh", "4x1",
    "--batch", "4", "--seq", "32", "--compressor", "lq_sgd", "--rank", "1",
    "--bits", "8", "--log-every", "1",
]  # fmt: skip
LM_STEPS, CKPT_STEP, RESUME_STEPS = 3, 2, 4

# train_one on a small ResNet (the launcher's tiny CPU run)
RESNET = dict(model="resnet18", n_workers=2, batch=2, hw=8, steps=2, device="cpu")


def small_tree():
    """The gradient tree the sync tests compress: a low-rank matrix, a
    stacked (2, 8, 6) leaf compressed per layer, and a raw bias (shapes;
    ``min_compress_numel`` 16 routes the first two to the low-rank path)."""
    return {"b": (6,), "stack": (2, 8, 6), "w": (12, 10)}, {
        "b": False,
        "stack": True,
        "w": False,
    }


def make_sync(cfg_kw):
    """The compressor of ``cfg_kw`` over :func:`small_tree`."""
    from repro_torch.core.compressors import CompressorConfig, make_compressor

    shapes, flags = small_tree()
    abstract = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    cfg = CompressorConfig(min_compress_numel=16, **cfg_kw)
    return make_compressor(cfg, abstract, flags)


def run_syncs(comp, grads, comm, steps=SYNC_STEPS):
    """``steps`` donated syncs of the per-worker ``grads`` (one tree a step,
    this process's rows) over ``comm``; returns each step's synced tree,
    the final state and each step's (bits, collectives), with the gathers
    in ``comm.gathered``."""
    state = comp.init_state(SEED, comm.local_size(), "cpu")
    out = []
    for g in grads[:steps]:
        synced, state, rec = comp.sync(g, state, comm, donate=True)
        out.append((synced, (rec.bits_sent, rec.n_collectives)))
    return out, state


def rows_of(tree, comm):
    """This process's workers' rows of a tree of (N, ...) tensors."""
    return {k: v[comm.workers()].clone() for k, v in tree.items()}


def quiet_call(fn, *args, **kwargs):
    """``fn`` with its standard output kept (returned beside its result)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*args, **kwargs)
    return res, buf.getvalue()


def _host(tree):
    from repro_torch.core.tree import tree_leaves

    return [x.detach().to("cpu", copy=True) for x in tree_leaves(tree)]


def _refusals(res):
    from repro_torch.core.comm import DistComm
    from repro_torch.launch.mesh import make_mesh

    comm = DistComm(1)
    grads = {k: torch.zeros((1,) + s) for k, s in small_tree()[0].items()}
    for name, kw in REFUSED_CFGS.items():
        comp = make_sync(kw)
        state = comp.init_state(SEED, 1, "cpu")
        try:
            comp.sync(grads, state, comm)
            res[f"refusal_{name}"] = None
        except NotImplementedError as e:
            res[f"refusal_{name}"] = str(e)
    res["graph_refusal"] = comm.graph_refusal()
    try:
        make_mesh((3, 1), "cpu")
        res["mesh_3"] = None
    except ValueError as e:
        res["mesh_3"] = str(e)


def _primitives(res, inputs):
    from repro_torch.core.comm import DistComm

    comm = DistComm(2)
    for name, x in inputs["prims"].items():
        mine = x[comm.workers()]
        out = {"all_gather": comm.all_gather(mine)}
        if x.is_floating_point():
            for op in ("psum", "pmean", "pmax", "metric_mean"):
                out[op] = getattr(comm, op)(mine)
        res[f"prim_{name}"] = out
    a, b = inputs["fused"]
    w = comm.workers()
    res["fused_all_gather"] = comm.fused_all_gather([a[w], b[w]])
    res["fused_pmax"] = comm.fused_pmax([a[w].float(), b[w].float()])
    res["rows_8"] = comm.rows(8)
    res["repr"] = repr(comm)


def _syncs(res, inputs):
    from repro_torch.core.comm import DistComm

    for k in (1, 2):
        for name, kw in SYNC_CFGS.items():
            comm = DistComm(k, record=True)
            comp = make_sync(kw)
            grads = [rows_of(g, comm) for g in inputs["grads"][k * WORLD]]
            steps, state = run_syncs(comp, grads, comm)
            res[f"sync_{name}_{WORLD}x{k}"] = dict(
                synced=[_host(s) for s, _ in steps],
                recs=[r for _, r in steps],
                state=state,
                gathered=[g.clone() for g in comm.gathered],
                bits=comp.wire_bits_per_step(),
                collectives=comp.handler.group_collectives(comp.plans),
            )


def _launcher(res, out_dir, ckpt_parent):
    from repro_torch.launch import train as launch_train

    argv = LM_ARGS + ["--dist-backend", "gloo"]
    run, printed = quiet_call(launch_train.main, argv + ["--steps", str(LM_STEPS)])
    res["lm_history"] = run["history"]
    res["lm_params"] = _host(run["state"]["params"])
    res["lm_comp"] = {k: _host(v) for k, v in run["state"]["comp"].items()}
    res["lm_printed"] = printed
    ck = os.path.join(out_dir, "ranks.ckpt")
    more = ["--steps", str(CKPT_STEP), "--ckpt-every", str(CKPT_STEP)]
    quiet_call(launch_train.main, argv + more + ["--ckpt-path", ck])
    resume = ["--steps", str(RESUME_STEPS), "--resume", "--ckpt-path", ckpt_parent]
    run, _ = quiet_call(launch_train.main, argv + resume)
    res["lm_resumed_params"] = _host(run["state"]["params"])
    res["lm_resumed_history"] = run["history"]
    # the 4-worker checkpoint under a mesh of 2 workers (1 a rank): raises
    try:
        quiet_call(launch_train.main, argv + resume + ["--mesh", "2x1"])
        res["lm_resume_2x1"] = None
    except ValueError as e:
        res["lm_resume_2x1"] = str(e)


def _resnet(res):
    from repro_torch.core.comm import DistComm
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.train.data_parallel import train_one

    comm = DistComm(RESNET["n_workers"] // WORLD, record=True)
    synced = []
    out = train_one(
        CompressorConfig(name="lq_sgd", rank=1, bits=8),
        comm=comm,
        graph=False,
        on_sync=lambda step, g, st: synced.append(_host(g)),
        **RESNET,
    )
    res["resnet"] = dict(
        losses=out.losses,
        acc=out.acc,
        params=_host(out.params),
        synced=synced,
        gathered=[g.clone() for g in comm.gathered],
        bits=[st.rec.bits_sent for st in out.steps],
        collectives=[st.rec.n_collectives for st in out.steps],
    )


def run_rank(rank, world, store, inputs_path, out_dir):
    """One rank's work (the target of the spawn): everything it finds goes
    to ``<out_dir>/rank<rank>.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank, world_size=world
    )
    try:
        inputs = torch.load(inputs_path, weights_only=False)
        res = {"rank": rank, "t0": time.time()}
        _primitives(res, inputs)
        _syncs(res, inputs)
        _refusals(res)
        _resnet(res)
        _launcher(res, out_dir, inputs["ckpt_parent"])
        res["seconds"] = time.time() - res["t0"]
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def lm_smoke_steps(comm, device, graph=None, steps=3):
    """gemma3-1b at smoke widths over ``comm``'s 4 workers (2 rows x 64
    tokens each, this process's rows of each global batch), LQ-SGD r1 b8,
    Adam, with deterministic algorithms on: (every step's metrics, the
    final parameters and every gather on the host, whether the step was a
    graph replay)."""
    from repro_torch.configs import get_config
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.data.synthetic import LMDataConfig, lm_batch
    from repro_torch.train.optimizer import adam
    from repro_torch.train.step import (
        build_train_step,
        init_train_state,
        make_model_compressor,
    )
    from repro_torch.train.trainer import local_rows

    cfg = get_config("gemma3-1b", smoke=True)
    comp = make_model_compressor(cfg, CompressorConfig(name="lq_sgd", rank=1))
    data = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=64, batch=8)
    opt = adam(1e-3)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        state = init_train_state(cfg, 0, opt, comp, comm.local_size(), device)
        mesh = (comm.size(), 1)
        step = build_train_step(cfg, mesh, comp, opt, comm=comm, graph=graph)
        metrics = []
        for i in range(steps):
            state, m = step(state, local_rows(lm_batch(data, i), comm))
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        torch.use_deterministic_algorithms(False)
    return metrics, _host(state["params"]), _host(comm.gathered), step.graph is not None


def nccl_lm_rank(rank, world, store, out_dir):
    """One rank of the card test's NCCL process group (one card a rank):
    :func:`lm_smoke_steps` graphed, written to ``<out_dir>/nccl<rank>.pt``."""
    from repro_torch.core.comm import DistComm

    torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl", store=dist.FileStore(store, world), rank=rank, world_size=world
    )
    try:
        comm = DistComm(4 // world, record=True)
        out = lm_smoke_steps(comm, f"cuda:{rank}")
        torch.save(out, os.path.join(out_dir, f"nccl{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(inputs_path, out_dir, world=WORLD, target=None):
    """Start ``world`` ranks on :func:`run_rank` (or ``target``, e.g.
    :func:`nccl_lm_rank`); returns ``join()``, which waits for each up to
    its deadline, kills what is left, raises unless every rank exited with
    0, and returns what each rank wrote."""
    ctx = mp.get_context("spawn")
    store = os.path.join(out_dir, "store")
    if target is None:
        args = [(r, world, store, inputs_path, out_dir) for r in range(world)]
        target = run_rank
    else:
        args = [(r, world, store, out_dir) for r in range(world)]
    procs = [ctx.Process(target=target, args=a) for a in args]
    for p in procs:
        p.start()

    def join():
        deadline = time.time() + JOIN_S
        for p in procs:
            p.join(max(1.0, deadline - time.time()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        codes = [p.exitcode for p in procs]
        if hung or any(c != 0 for c in codes):
            raise RuntimeError(f"ranks hung {hung}, exit codes {codes}")
        name = "rank" if target is run_rank else "nccl"
        return [
            torch.load(os.path.join(out_dir, f"{name}{r}.pt"), weights_only=False)
            for r in range(world)
        ]

    return join
