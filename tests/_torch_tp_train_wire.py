"""The rank side of ``test_torch_tp_train_wire.py``: what each of the four
spawned gloo ranks runs to train with every compressor over a ``(data,
model)`` mesh, on the CPU.

A rank imports ``torch`` and the port, never JAX. The parent writes the
inputs with ``torch.save`` (each architecture's weights as numpy arrays in
the JAX training layout, the token batches, the JAX warm-start Q of the
composite held to the JAX package, a one-process checkpoint), spawns the
ranks through ``_torch_dist.spawn`` (a ``FileStore`` rendezvous, one thread
a rank) and reads back ``<out>/card<r>.pt``. Every run goes through
``_torch_tp_train.train_run`` inside :func:`recording`, as the parent's
one-process references do.
"""

import contextlib
import os
import time

import _torch_tp_train as tt
import torch
import torch.distributed as dist

WORLD = 4
MESH = (2, 2)
# a per-leaf policy whose two method groups are lazy: the power iteration
# on the leaves named w*, 'down' among them, LQ-SGD b8 on the rest
POLICY = (
    "w=powersgd:lazy_thresh=2.0:max_stale=1,"
    "*=lq_sgd:bits=8:lazy_thresh=2.0:max_stale=1"
)
ADAPTIVE = POLICY.replace("max_stale=1", "max_stale=1:lazy_adaptive=2.0")
# CompressorConfig fields by run name
CONFIGS = {
    "topk": dict(name="topk"),
    "qsgd_b4": dict(name="qsgd", bits=4),
    "dlog": dict(name="lq_sgd", rank=1, bits=8, codec="dlog", dp_epsilon=48.0),
    "lrq_b4": dict(name="lq_sgd", rank=1, bits=4, codec="lrq"),
    # a warm-up step, then skips and forced fires (max_stale 1)
    "policy_lazy": dict(name="lq_sgd", policy=POLICY, warmup_steps=1),
    "policy_gate": dict(
        name="lq_sgd", policy=ADAPTIVE, warmup_steps=1, lazy_mode="gate"
    ),
    "server": dict(
        name="lq_sgd", rank=1, bits=8, topology="server", participation=0.5
    ),
    "server_lazy": dict(
        name="lq_sgd",
        rank=1,
        bits=8,
        topology="server",
        participation=0.5,
        agg="sparsity",
        lazy_thresh=1.5,
        max_stale=1,
    ),
    "lazy": dict(name="lq_sgd", rank=1, bits=8, lazy_thresh=2.0, max_stale=1),
    # held to the JAX step: the policy from the JAX warm-start Q, no warm-up
    "policy_jax": dict(name="lq_sgd", policy=POLICY),
}
GEMMA, MIXTRAL = "gemma3-1b", "mixtral-8x7b"
ARCHS = (GEMMA, MIXTRAL)
GEMMA_RUNS = (
    "topk",
    "qsgd_b4",
    "dlog",
    "lrq_b4",
    "policy_lazy",
    "policy_gate",
    "server",
    "server_lazy",
)
# mixtral's expert stacks (L, E, D, F) split on E at 2x2 (the spawn's four
# ranks make no 1x2 mesh beside its 2x2 one)
MIXTRAL_RUNS = ("topk", "lazy")
# one step each from the JAX state, against the JAX step composed from its
# parts: TopK (zero error feedback) and the lazy policy (the JAX warm Q)
JAX_RUNS = ("topk", "policy_jax")
# launch/train.py with the lazy policy: a 2x2 checkpoint resumed in one
# process and a one-process checkpoint resumed on 2x2
LAUNCH_ARGS = tt.LAUNCH_ARGS + ["--policy", POLICY, "--warmup", "1"]
LAUNCH_STEPS, CKPT_STEPS = 4, 2


def run_names():
    """Every (arch, mesh, config) run of the spawn, in its order."""
    runs = [(GEMMA, MESH, c) for c in GEMMA_RUNS]
    return runs + [(MIXTRAL, MESH, c) for c in MIXTRAL_RUNS]


@contextlib.contextmanager
def recording():
    """Inside the block: each server round's participation flags of this
    process's workers (``ServerWire.prepare``) and, for each TopK leaf a
    step, ``k`` and each worker's count of kept entries of this process's
    block (``compressors.topk_mask``), in call order."""
    from repro_torch.core import compressors, wire

    seen = {"flags": [], "kept": []}
    prepare, mask = wire.ServerWire.prepare, compressors.topk_mask

    def rec_prepare(self, rec):
        seen["flags"].append(self.active().cpu())
        return prepare(self, rec)

    def rec_mask(flat, k, block=None):
        out = mask(flat, k, block)
        seen["kept"].append((k, out.sum(1).cpu()))
        return out

    wire.ServerWire.prepare, compressors.topk_mask = rec_prepare, rec_mask
    try:
        yield seen
    finally:
        wire.ServerWire.prepare, compressors.topk_mask = prepare, mask


def train(arch, weights, tokens, cname, mesh_shape, *, mesh=None, **kw):
    """``tt.train_run`` of ``CONFIGS[cname]`` under :func:`recording`, with
    what it recorded."""
    with recording() as seen:
        out = tt.train_run(
            arch,
            weights,
            tokens,
            cname,
            mesh_shape,
            mesh=mesh,
            ccfg=CONFIGS[cname],
            **kw,
        )
    out.update(seen)
    return out


def _runs(res, inputs):
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(MESH, "cpu")
    for arch, shape, cname in run_names():
        t0 = time.perf_counter()
        out = train(
            arch, inputs["weights"][arch], inputs["tokens"], cname, shape, mesh=mesh
        )
        out["seconds"] = time.perf_counter() - t0
        res[(arch, shape, cname)] = out
    for cname in JAX_RUNS:
        res[("jax", cname)] = train(
            GEMMA,
            inputs["weights"][GEMMA],
            inputs["tokens"],
            cname,
            MESH,
            mesh=mesh,
            jax_q=inputs["jax_q"].get(cname),
            steps=1,
        )


def _launcher(res, inputs, out_dir):
    from repro_torch.launch import train as launch_train

    from _torch_dist import quiet_call

    argv = LAUNCH_ARGS + tt.LAUNCH_MESH + ["--steps", str(CKPT_STEPS)]
    argv += ["--ckpt-every", "1", "--ckpt-path", os.path.join(out_dir, "tp.ckpt")]
    out, printed = quiet_call(launch_train.main, argv)
    res["launch"] = dict(history=out["history"], printed=printed)
    argv = LAUNCH_ARGS + tt.LAUNCH_MESH + ["--steps", str(LAUNCH_STEPS), "--resume"]
    argv += ["--ckpt-path", inputs["one_ckpt"]]
    out, printed = quiet_call(launch_train.main, argv)
    res["resumed"] = dict(history=out["history"], printed=printed)


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
        res["seconds"] = time.time() - res["t0"]
        torch.save(res, os.path.join(out_dir, f"card{rank}.pt"))
    finally:
        dist.destroy_process_group()
