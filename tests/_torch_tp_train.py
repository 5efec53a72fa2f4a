"""The rank side of ``test_torch_tp_train.py``: what each of the four spawned
gloo ranks runs for tensor-parallel training, on the CPU.

A rank imports ``torch`` and the port, never JAX. The parent writes the
inputs with ``torch.save`` (each architecture's weights as numpy arrays in
the JAX training layout, the token batches, the JAX compressor state of
the one case held to the JAX package, a one-process checkpoint), spawns
the ranks through ``_torch_dist.spawn`` (a ``FileStore`` rendezvous, one
thread a rank) and reads back ``<out>/card<r>.pt``. The one-process runs
the parent compares with go through :func:`train_run` too, over a
``SimComm``.
"""

import os
import time

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4
ARCHS = ("gemma3-1b", "mistral-nemo-12b", "qwen2-72b", "granite-20b")
MESHES = ((2, 2), (1, 4))
# the compressors of the runs (CompressorConfig fields)
COMPRESSORS = {
    "none": dict(name="none"),
    "powersgd": dict(name="powersgd", rank=2),
    "lq_sgd_b8": dict(name="lq_sgd", rank=1, bits=8),
    "lq_sgd_b4": dict(name="lq_sgd", rank=1, bits=4),
}
STEPS = 3
BATCH, SEQ = 4, 16
LR = 0.05
SEED = 3
# the run held to the JAX package's step directly (one step)
JAX_RUN = ("gemma3-1b", (2, 2), "lq_sgd_b8")
# launch/train.py under the ranks and in one process
LAUNCH_ARGS = [
    "--arch", "gemma3-1b", "--smoke", "--device", "cpu", "--batch", "4",
    "--seq", "16", "--log-every", "1", "--runtime", "sync",
]  # fmt: skip
LAUNCH_MESH = ["--mesh", "2x2", "--dist-backend", "gloo"]
LAUNCH_STEPS, CKPT_STEPS = 4, 2
# the launcher's other compressors, wires and loops at 2x2, each against
# its one-process --mesh 2x1 run: argv after LAUNCH_ARGS + LAUNCH_MESH
LAUNCH_CASES = {
    "topk": ["--compressor", "topk"],
    "qsgd": ["--compressor", "qsgd"],
    "dlog": ["--codec", "dlog", "--dp-epsilon", "8"],
    "policy": ["--policy", "w=powersgd,*=lq_sgd:bits=8"],
    "lazy": ["--lazy-thresh", "2.0"],
    "server": ["--wire", "server", "--participation", "0.5"],
    "server_full": ["--wire", "server"],
    "async": ["--runtime", "async"],
    "microbatch": ["--microbatch", "2"],
}
CASE_STEPS = 2


def run_names():
    """Every (arch, mesh, compressor) run of the spawn, in its order."""
    return [(a, m, c) for m in MESHES for a in ARCHS for c in COMPRESSORS]


def _host(tree):
    from repro_torch.core.tree import tree_map

    return tree_map(lambda t: t.detach().clone() if torch.is_tensor(t) else t, tree)


def train_run(
    arch,
    weights,
    tokens,
    cname,
    mesh_shape,
    *,
    comm=None,
    mesh=None,
    jax_comp=None,
    steps=STEPS,
    cfg=None,
    ccfg=None,
    jax_q=None,
):
    """``steps`` steps of ``arch`` (smoke, f32, or ``cfg``) from the numpy
    ``weights`` (the JAX training layout) on ``tokens`` (a list of global
    batches: (BATCH, SEQ) token tensors, or batch dicts, a conditioning
    prefix beside), SGD at ``LR``, the compressor ``COMPRESSORS[cname]`` (or
    the ``CompressorConfig`` fields ``ccfg``): over a ``SimComm`` of the
    mesh's data axis in one process (no ``mesh``), or as this rank of
    ``mesh`` (a ``DataMesh`` over the process group), its blocks cut from
    the same weights. ``jax_comp`` (numpy, without a worker dim): the JAX
    package's compressor state, cut to the rank's blocks, in place of the
    port's draw; ``jax_q`` (numpy by leaf index) its warm-start Q alone,
    over the port's state of a composite. Returns, on the host: step 0's
    per-worker gradients into the sync, every step's synced gradients,
    CommRecord numbers, lazy staleness counters and metrics, the final
    error feedback, compressor state and parameters, and the data-axis
    gathers."""
    from repro_torch.configs import get_config
    from repro_torch.core.comm import ModelAxis, ModelComm, SimComm
    from repro_torch.core.compressors import CompressorConfig, model_split
    from repro_torch.core.tree import tree_map
    from repro_torch.launch.mesh import make_comm, make_model_comm
    from repro_torch.launch.sharding import Spec
    from repro_torch.train.optimizer import sgd
    from repro_torch.train.step import (
        build_train_step,
        make_model_compressor,
        train_param_specs,
    )
    from repro_torch.train.trainer import local_rows
    from repro_torch.weights import compressor_state_from_jax, train_state_from_jax

    cfg = cfg if cfg is not None else get_config(arch, smoke=True)
    fields = ccfg if ccfg is not None else COMPRESSORS[cname]
    comp = make_model_compressor(cfg, CompressorConfig(**fields))
    data, model = mesh_shape
    tp = split = None
    if mesh is None:
        comm = comm if comm is not None else SimComm(data, record=True)
        specs = None
    else:
        comm = make_comm(mesh, record=True)
        specs = train_param_specs(cfg, model)
        tp = ModelAxis(comm=make_model_comm(mesh), seq=ModelComm(), specs=specs)
        split = model_split(tp.comm, specs)
    np_state = dict(params=weights, opt={}, comp={}, step=np.zeros((), np.int32))
    state_specs = None
    if specs is not None:
        state_specs = dict(params=specs, opt={}, comp={}, step=Spec())
    state = train_state_from_jax(np_state, "cpu", specs=state_specs, mesh=mesh)
    params = tree_map(lambda w: w.requires_grad_(True), state["params"])
    k = comm.local_size()
    if jax_comp is None:
        comp_state = comp.init_state(SEED, k, "cpu", model=split)
    else:
        cspecs = comp.state_pspecs(jax_comp, specs) if specs is not None else None
        comp_state = compressor_state_from_jax(
            jax_comp, k, "cpu", specs=cspecs, mesh=mesh
        )
    if jax_q is not None:  # whole on every rank
        comp_state["q"] = {
            i: torch.from_numpy(np.asarray(q)).expand((k,) + q.shape).clone()
            for i, q in jax_q.items()
        }
    opt = sgd(LR)
    state = dict(
        params=params,
        opt=opt.init(params),
        comp=comp_state,
        step=torch.zeros((), dtype=torch.int32),
    )
    recs = []

    def on_sync(grads, synced, comp_state, rec):
        recs.append(
            dict(
                grads=_host(grads) if not recs else None,
                synced=_host(synced),
                bits=rec.bits_sent,
                phys=rec.phys_bits,
                colls=rec.n_collectives,
                stale=_host(comp_state.get("lazy_stale", {})),
            )
        )

    step = build_train_step(
        cfg, mesh_shape, comp, opt, comm=comm, on_sync=on_sync, graph=False, tp=tp
    )
    losses, metrics = [], []
    for i in range(steps):
        batch = tokens[i] if isinstance(tokens[i], dict) else {"tokens": tokens[i]}
        state, m = step(state, local_rows(batch, comm))
        losses.append(float(m["loss"]))
        metrics.append({k: float(v) for k, v in m.items()})
    out = dict(
        recs=recs,
        losses=losses,
        metrics=metrics,
        params=_host(state["params"]),
        err=_host(state["comp"].get("err", {})),
        q=_host(state["comp"].get("q", {})),
        comp=_host(state["comp"]),
        gathered=_host(comm.gathered),
        wire_bits=comp.wire_bits_per_step(),
        refusal=step.graph_refusal(),
    )
    if tp is not None:
        out.update(
            coords=mesh.coords,
            sizes=mesh.sizes,
            dims=split.dims,
            replicated_bits=comp.model_replicated_bits(split),
            model_calls=tp.comm.stats()["calls"],
        )
    return out


def _runs(res, inputs):
    from repro_torch.launch.mesh import make_mesh

    meshes = {}
    for arch, shape, cname in run_names():
        if shape not in meshes:  # every rank makes the groups, in one order
            meshes[shape] = make_mesh(shape, "cpu")
        t0 = time.perf_counter()
        out = train_run(
            arch,
            inputs["weights"][arch],
            inputs["tokens"],
            cname,
            shape,
            mesh=meshes[shape],
        )
        out["seconds"] = time.perf_counter() - t0
        res[(arch, shape, cname)] = out
    arch, shape, cname = JAX_RUN
    res["jax"] = train_run(
        arch,
        inputs["weights"][arch],
        inputs["tokens"],
        cname,
        shape,
        mesh=meshes[shape],
        jax_comp=inputs["jax_comp"],
        steps=1,
    )


def _launcher(res, inputs, out_dir):
    from repro_torch.launch import train as launch_train

    from _torch_dist import quiet_call

    ckpt = os.path.join(out_dir, "tp.ckpt")
    argv = LAUNCH_ARGS + LAUNCH_MESH + ["--steps", str(CKPT_STEPS)]
    argv += ["--ckpt-every", "1", "--ckpt-path", ckpt]
    out, printed = quiet_call(launch_train.main, argv)
    res["launch"] = dict(history=out["history"], printed=printed)
    # the one-process checkpoint (written by the parent), resumed on 2x2
    argv = LAUNCH_ARGS + LAUNCH_MESH + ["--steps", str(LAUNCH_STEPS), "--resume"]
    argv += ["--ckpt-path", inputs["one_ckpt"]]
    out, printed = quiet_call(launch_train.main, argv)
    res["resumed"] = dict(history=out["history"], printed=printed)


def case_argv(name, mesh=LAUNCH_MESH):
    """The launcher's argv of ``LAUNCH_CASES[name]`` over ``mesh``."""
    return LAUNCH_ARGS + mesh + ["--steps", str(CASE_STEPS), *LAUNCH_CASES[name]]


def _launch_cases(res):
    from repro_torch.launch import train as launch_train

    from _torch_dist import quiet_call

    res["cases"] = {
        name: quiet_call(launch_train.main, case_argv(name))[0]["history"]
        for name in LAUNCH_CASES
    }


def run_rank(rank, world, store, out_dir, inputs_path):
    """One rank's work (the target of ``_torch_dist.spawn``): everything it
    finds goes to ``<out_dir>/card<rank>.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank, world_size=world
    )
    try:
        inputs = torch.load(inputs_path, weights_only=False)
        res = {"rank": rank, "t0": time.time()}
        _runs(res, inputs)
        _launcher(res, inputs, out_dir)
        _launch_cases(res)
        res["seconds"] = time.time() - res["t0"]
        torch.save(res, os.path.join(out_dir, f"card{rank}.pt"))
    finally:
        dist.destroy_process_group()


# the card tests: gemma3-1b smoke at 1x2 over NCCL, one card a rank (and
# mixtral and deepseek smoke in its place: CARD_ZOO)
CARD_RUN = ("gemma3-1b", (1, 2), "lq_sgd_b8")
CARD_ZOO = ("mixtral-8x7b", "deepseek-v3-671b")
# and the other compressors over it: TopK and QSGD b4 (one graph a step),
# a lazy LQ-SGD group (the composite: eager)
CARD_COMPRESSORS = {
    "topk": dict(name="topk"),
    "qsgd_b4": dict(name="qsgd", bits=4),
    "lazy": dict(name="lq_sgd", rank=1, bits=8, lazy_thresh=2.0, max_stale=1),
}


def card_weights(arch=CARD_RUN[0]):
    """``arch`` smoke's seeded init in the training layout, as numpy."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.train.step import init_train_params

    cfg = get_config(arch, smoke=True)
    params = init_train_params(cfg, 1, "cpu")
    return tree_map(lambda t: t.detach().numpy(), params)


def card_tokens():
    rng = np.random.default_rng(11)
    return [torch.from_numpy(rng.integers(0, 512, (BATCH, SEQ))) for _ in range(STEPS)]


def card_tp_train(device, mesh=None, graph=None, arch=CARD_RUN[0], cname=None):
    """:func:`train_run`'s step of ``arch`` (smoke, token ids below 512) on
    ``device`` (one process, or this rank of ``mesh``), graphed where the
    comm and the compressor allow (``graph``), LQ-SGD b8 or
    ``CARD_COMPRESSORS[cname]``: losses, step 0's gradients and every
    step's synced gradients, final parameters."""
    from repro_torch.configs import get_config
    from repro_torch.core.comm import ModelAxis, ModelComm, SimComm
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.core.tree import tree_map
    from repro_torch.launch.mesh import make_comm, make_model_comm
    from repro_torch.launch.sharding import Spec
    from repro_torch.train.optimizer import sgd
    from repro_torch.train.step import (
        build_train_step,
        make_model_compressor,
        train_param_specs,
    )
    from repro_torch.weights import train_state_from_jax

    _, shape, lq = CARD_RUN
    fields = COMPRESSORS[lq] if cname is None else CARD_COMPRESSORS[cname]
    cfg = get_config(arch, smoke=True)
    comp = make_model_compressor(cfg, CompressorConfig(**fields))
    tp, specs, split = None, None, None
    if mesh is None:
        comm = SimComm(shape[0])
    else:
        from repro_torch.core.compressors import model_split

        comm = make_comm(mesh)
        specs = train_param_specs(cfg, shape[1])
        tp = ModelAxis(comm=make_model_comm(mesh), seq=ModelComm(), specs=specs)
        split = model_split(tp.comm, specs)
    np_state = dict(
        params=card_weights(arch), opt={}, comp={}, step=np.zeros((), np.int32)
    )
    st_specs = None if specs is None else dict(params=specs, opt={}, comp={}, step=Spec())
    params = train_state_from_jax(np_state, device, specs=st_specs, mesh=mesh)["params"]
    params = tree_map(lambda w: w.requires_grad_(True), params)
    opt = sgd(LR)
    state = dict(
        params=params,
        opt=opt.init(params),
        comp=comp.init_state(SEED, comm.local_size(), device, model=split),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )
    seen = []

    def on_sync(grads, synced, comp_state, rec):
        seen.append(
            dict(
                grads=tree_map(lambda t: t.detach().cpu(), grads) if not seen else None,
                synced=tree_map(lambda t: t.detach().cpu(), synced),
            )
        )

    step = build_train_step(
        cfg, shape if mesh else (shape[0], 1), comp, opt, comm=comm,
        on_sync=on_sync, graph=graph, tp=tp,
    )  # fmt: skip
    losses = []
    for batch in card_tokens():
        state, m = step(state, {"tokens": batch.to(device)})
        losses.append(float(m["loss"]))
    out = dict(
        losses=losses,
        seen=seen,
        params=tree_map(lambda t: t.detach().cpu(), state["params"]),
        graphed=step.graph is not None,
    )
    step.release()
    return out


def card_tp_train_rank(rank, world, store, out_dir, arch=CARD_RUN[0], cname=None):
    """One NCCL rank of the card test of ``arch`` (and ``cname``, as
    :func:`card_tp_train` takes it): the graphed tensor-parallel step (its
    model-axis and data-axis collectives captured) and the eager one, to
    ``<out_dir>/card<r>.pt``."""
    import gc

    from repro_torch.launch.mesh import make_mesh

    device = f"cuda:{rank}"
    torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl", store=dist.FileStore(store, world), rank=rank, world_size=world
    )
    try:
        mesh = make_mesh(CARD_RUN[1], device)
        res = dict(
            graphed=card_tp_train(device, mesh, arch=arch, cname=cname),
            eager=card_tp_train(device, mesh, graph=False, arch=arch, cname=cname),
            coords=mesh.coords,
            sizes=mesh.sizes,
        )
        torch.save(res, os.path.join(out_dir, f"card{rank}.pt"))
    finally:
        gc.collect()  # the step graphs hold the communicators they captured
        dist.destroy_process_group()
