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
    # the randomized codecs, per-leaf policies with a warm-up, lazy groups
    # (a fired round, then a skipped one) and the server wire with drop-out
    # and per-worker lazy decisions
    "qsgd": dict(name="qsgd", bits=4),
    "dlog": dict(name="lq_sgd", rank=1, codec="dlog", dp_epsilon=8.0),
    "lrq": dict(name="lq_sgd", rank=1, bits=4, codec="lrq"),
    "policy": dict(
        name="lq_sgd", policy="w=powersgd,*=lq_sgd:bits=8", warmup_steps=1
    ),
    "lazy": dict(name="lq_sgd", rank=1, lazy_thresh=2.0),
    "lazy_gate": dict(name="lq_sgd", rank=1, lazy_thresh=2.0, lazy_mode="gate"),
    "server": dict(
        name="lq_sgd",
        rank=1,
        topology="server",
        participation=0.5,
        lazy_thresh=1.5,
    ),
}
SYNC_STEPS = 2
# the configs that raised across ranks before they were ported
FORMER_REFUSALS = ("qsgd", "dlog", "lrq", "policy", "lazy", "lazy_gate", "server")

# launch.train over the ranks (every rank's argv; the one-process runs in
# the parent take the same)
LM_ARGS = [
    "--arch", "gemma3-1b", "--smoke", "--device", "cpu", "--mesh", "4x1",
    "--batch", "4", "--seq", "32", "--compressor", "lq_sgd", "--rank", "1",
    "--bits", "8", "--log-every", "1",
]  # fmt: skip
LM_STEPS, CKPT_STEP, RESUME_STEPS = 3, 2, 4
# the same over a lazy composite whose ffn leaves ship by dlog: a fired
# round, skips, a forced fire (max_stale 2) across the checkpoint at step 2
LAZY_LM_ARGS = LM_ARGS + [
    "--lazy-thresh", "2.0", "--max-stale", "2", "--policy",
    "ffn=lq_sgd:codec=dlog:dp_epsilon=8:lazy_thresh=2.0:max_stale=2",
]  # fmt: skip

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
    the final state and each step's accounting (bits, collectives, then
    the effective ones, then the lazy counters), with the gathers in
    ``comm.gathered``."""
    state = comp.init_state(SEED, comm.local_size(), "cpu")
    out = []
    for g in grads[:steps]:
        synced, state, rec = comp.sync(g, state, comm, donate=True)
        stale = {m: c.clone() for m, c in state.get("lazy_stale", {}).items()}
        acct = (
            rec.bits_sent,
            rec.n_collectives,
            float(rec.effective_bits()),
            float(rec.effective_collectives()),
            stale,
        )
        out.append((synced, acct))
    return out, state


def planned(comp):
    """A sync's static accounting: ((bits, collectives) of a round where
    every group fires, (bits, collectives) of the lazy decisions alone)."""
    if not hasattr(comp, "groups"):
        colls = comp.handler.group_collectives(comp.plans)
        return (comp.wire_bits_per_step(), colls), (0, 0)
    colls = sum(
        comp.handlers[m].group_collectives([comp.plans[i] for i in idxs])
        for m, idxs in comp.groups.items()
    )
    n_lazy = len(comp.lazy_groups)
    fired = (comp.wire_bits_per_step(), colls + n_lazy)
    return fired, (comp.decision_bits_per_step(), n_lazy)


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

    res["graph_refusal"] = DistComm(1).graph_refusal()
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
                planned=planned(comp),
                refusal=comp.dist_refusal(),
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


def _lazy_launcher(res, out_dir, ckpt_parent):
    """The lazy composite with a dlog group through ``launch.train``: 2
    steps with a checkpoint at step 2, and the one-process checkpoint
    ``ckpt_parent`` resumed here to step 4."""
    from repro_torch.launch import train as launch_train

    argv = LAZY_LM_ARGS + ["--dist-backend", "gloo"]
    ck = os.path.join(out_dir, "ranks_lazy.ckpt")
    more = ["--steps", str(CKPT_STEP), "--ckpt-every", str(CKPT_STEP)]
    run, _ = quiet_call(launch_train.main, argv + more + ["--ckpt-path", ck])
    res["lazy_lm_history"] = run["history"]
    res["lazy_lm_params"] = _host(run["state"]["params"])
    resume = ["--steps", str(RESUME_STEPS), "--resume", "--ckpt-path", ckpt_parent]
    run, _ = quiet_call(launch_train.main, argv + resume)
    res["lazy_lm_resumed_params"] = _host(run["state"]["params"])
    res["lazy_lm_resumed_history"] = run["history"]


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
        _lazy_launcher(res, out_dir, inputs["lazy_ckpt_parent"])
        res["seconds"] = time.time() - res["t0"]
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# the card tests' compressors (CompressorConfig fields)
CARD_CFGS = {
    "lq_sgd": dict(name="lq_sgd", rank=1),
    "qsgd": dict(name="qsgd", bits=4),
    "dlog": dict(name="lq_sgd", rank=1, codec="dlog", dp_epsilon=8.0),
}


def lm_smoke_steps(comm, device, graph=None, steps=3, name="lq_sgd"):
    """gemma3-1b at smoke widths over ``comm``'s 4 workers (2 rows x 64
    tokens each, this process's rows of each global batch), the compressor
    ``CARD_CFGS[name]`` (LQ-SGD r1 b8), Adam, with deterministic algorithms
    on: (every step's metrics, the final parameters and every gather on
    the host, whether the step was a graph replay)."""
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
    comp = make_model_compressor(cfg, CompressorConfig(**CARD_CFGS[name]))
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


def card_lm_rank(rank, world, store, out_dir, backend, name):
    """One rank of a card test's process group: NCCL with one card a rank,
    or gloo with every rank on card 0; :func:`lm_smoke_steps` of the
    compressor ``name`` (graphed where the comm allows), written to
    ``<out_dir>/card<rank>.pt``."""
    from repro_torch.core.comm import DistComm

    device = f"cuda:{rank}" if backend == "nccl" else "cuda:0"
    torch.cuda.set_device(device)
    dist.init_process_group(
        backend, store=dist.FileStore(store, world), rank=rank, world_size=world
    )
    try:
        comm = DistComm(4 // world, record=True)
        out = lm_smoke_steps(comm, device, name=name)
        torch.save(out, os.path.join(out_dir, f"card{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(inputs_path, out_dir, world=WORLD, target=None, extra=()):
    """Start ``world`` ranks on :func:`run_rank` (or ``target``, e.g.
    :func:`card_lm_rank`, called with ``extra`` after its rank, world,
    store and directory); returns ``join()``, which waits for each up to
    its deadline, kills what is left, raises unless every rank exited with
    0, and returns what each rank wrote."""
    ctx = mp.get_context("spawn")
    store = os.path.join(out_dir, "store")
    if target is None:
        args = [(r, world, store, inputs_path, out_dir) for r in range(world)]
        target = run_rank
    else:
        args = [(r, world, store, out_dir, *extra) for r in range(world)]
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
        name = "rank" if target is run_rank else "card"
        return [
            torch.load(os.path.join(out_dir, f"{name}{r}.pt"), weights_only=False)
            for r in range(world)
        ]

    return join
