"""The rank side of ``test_torch_tp_train_zoo.py``: what each of the four
spawned gloo ranks runs to train the rest of the zoo tensor-parallel, on the
CPU.

A rank imports ``torch`` and the port, never JAX. The parent writes the
inputs with ``torch.save`` (each architecture's weights as numpy arrays in
the JAX training layout, the JAX compressor state of the run held to the JAX
package), spawns the ranks through ``_torch_dist.spawn`` (a ``FileStore``
rendezvous, one thread a rank) and reads back ``<out>/card<r>.pt``. Every
run goes through ``_torch_tp_train.train_run``, as the parent's one-process
references do; the batches come from :func:`batches` on both sides.
"""

import dataclasses
import os
import time

import _torch_tp_train as tt
import numpy as np
import torch
import torch.distributed as dist

WORLD = 4
ARCHS = (
    "mixtral-8x7b",
    "deepseek-v3-671b",
    "jamba-v0.1-52b",
    "musicgen-medium",
    "mamba2-370m",
)
MESHES = ((2, 2), (1, 4))
COMPRESSORS = ("none", "lq_sgd_b8")  # keys of _torch_tp_train.COMPRESSORS
# beside them: musicgen's codebooks on the b4 wire, and mixtral with its
# load-balance loss at a coefficient of AUX_COEF (the configs' 0.01 would
# hide an M-fold aux gradient under the tolerance)
B4_RUN = ("musicgen-medium", (2, 2), "lq_sgd_b4")
AUX_RUN = ("mixtral-8x7b", (2, 2), "none")
AUX_COEF = 1.0
# the run held to the JAX package's step directly (one step)
JAX_RUN = ("deepseek-v3-671b", (2, 2), "lq_sgd_b8")
# launch/train.py under the ranks, a checkpoint resumed in one process
LAUNCH_ARGS = [
    "--arch", "mixtral-8x7b", "--smoke", "--device", "cpu", "--batch", "4",
    "--seq", "16", "--log-every", "1", "--runtime", "sync",
]  # fmt: skip
LAUNCH_MESH = ["--mesh", "2x2", "--dist-backend", "gloo"]
LAUNCH_STEPS, CKPT_STEPS = 3, 2
BATCH_SEED = 23


def run_names():
    """Every (arch, mesh, compressor) run of the spawn, in its order."""
    runs = [(a, m, c) for m in MESHES for a in ARCHS for c in COMPRESSORS]
    return runs + [B4_RUN]


def config(arch, aux=False):
    """``arch``'s smoke config (f32), with ``aux`` the router's load-balance
    loss at AUX_COEF."""
    from repro_torch.configs import get_config

    cfg = get_config(arch, smoke=True)
    return dataclasses.replace(cfg, router_aux_coef=AUX_COEF) if aux else cfg


def batches(arch):
    """``tt.STEPS`` global batches of ``arch``: (BATCH, SEQ[, cb]) token ids
    and, with a conditioning prefix, its (BATCH, L, d) f32 rows."""
    cfg = config(arch)
    rng = np.random.default_rng(BATCH_SEED)
    shape = (tt.BATCH, tt.SEQ) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
    out = []
    for _ in range(tt.STEPS):
        b = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, shape))}
        if cfg.cond_len:
            cond = rng.standard_normal((tt.BATCH, cfg.cond_len, cfg.d_model))
            b["cond"] = torch.from_numpy(cond.astype(np.float32))
        out.append(b)
    return out


def _runs(res, inputs):
    from repro_torch.launch.mesh import make_mesh

    meshes = {}
    for arch, shape, cname in run_names():
        if shape not in meshes:  # every rank makes the groups, in one order
            meshes[shape] = make_mesh(shape, "cpu")
        t0 = time.perf_counter()
        out = tt.train_run(
            arch,
            inputs["weights"][arch],
            batches(arch),
            cname,
            shape,
            mesh=meshes[shape],
        )
        out["seconds"] = time.perf_counter() - t0
        res[(arch, shape, cname)] = out
    arch, shape, cname = AUX_RUN
    res["aux"] = tt.train_run(
        arch,
        inputs["weights"][arch],
        batches(arch),
        cname,
        shape,
        mesh=meshes[shape],
        cfg=config(arch, aux=True),
    )
    arch, shape, cname = JAX_RUN
    res["jax"] = tt.train_run(
        arch,
        inputs["weights"][arch],
        batches(arch),
        cname,
        shape,
        mesh=meshes[shape],
        jax_comp=inputs["jax_comp"],
        steps=1,
    )


def _launcher(res, out_dir):
    from _torch_dist import quiet_call
    from repro_torch.launch import train as launch_train

    argv = LAUNCH_ARGS + LAUNCH_MESH + ["--steps", str(CKPT_STEPS)]
    argv += ["--ckpt-every", "1", "--ckpt-path", os.path.join(out_dir, "tp.ckpt")]
    out, printed = quiet_call(launch_train.main, argv)
    res["launch"] = dict(history=out["history"], printed=printed)


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
        _launcher(res, out_dir)
        res["seconds"] = time.time() - res["t0"]
        torch.save(res, os.path.join(out_dir, f"card{rank}.pt"))
    finally:
        dist.destroy_process_group()
