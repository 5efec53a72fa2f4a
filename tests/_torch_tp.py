"""The rank side of ``test_torch_tp.py``: what each of the four spawned gloo
ranks runs for tensor-parallel serving, on the CPU.

A rank imports ``torch`` and the port, never JAX. The parent writes the
inputs with ``torch.save`` (each architecture's weights as numpy arrays,
each run's prompts and the one-process tokens the teacher-forced decode
feeds), spawns the ranks through ``_torch_dist.spawn`` (a ``FileStore``
rendezvous, one thread a rank) and reads back ``<out>/card<r>.pt``.
"""

import gc
import os
import time

import torch
import torch.distributed as dist

WORLD = 4
PROMPT, GEN = 24, 8  # max_seq 32: whole over 1, 2 and 4 sequence shards
TEACHER = 4  # teacher-forced decode steps
ARCHS = (
    "gemma3-1b",
    "mistral-nemo-12b",
    "qwen2-72b",
    "granite-20b",
    "chameleon-34b",
)
# run -> (arch, (data, model) mesh, cache bits, global batch), in mesh order
RUNS = {
    "gemma3_1x4_q8": ("gemma3-1b", (1, 4), 8, 4),  # sequence over model
    "granite_1x4_q8": ("granite-20b", (1, 4), 8, 4),  # MQA
    "gemma3_2x2_q4": ("gemma3-1b", (2, 2), 4, 4),  # batch over data
    "gemma3_2x2_b1": ("gemma3-1b", (2, 2), 8, 1),  # sequence over data + model
    "mistral_2x2_q8": ("mistral-nemo-12b", (2, 2), 8, 4),  # heads over model
    "qwen2_2x2_q8": ("qwen2-72b", (2, 2), 8, 4),  # sharded biases
    "chameleon_2x2_q8": ("chameleon-34b", (2, 2), 8, 4),  # VLM ids
    "gemma3_4x1_q8": ("gemma3-1b", (4, 1), 8, 4),  # data parallel only
}
# launch/serve.py under the ranks and in one process
LAUNCH_ARGS = [
    "--arch", "gemma3-1b", "--smoke", "--device", "cpu", "--batch", "4",
    "--prompt-len", "16", "--gen", "4", "--cache-bits", "8",
    "--cache-dtype", "float32",
]  # fmt: skip
LAUNCH_MESH = ["--mesh", "2x2", "--dist-backend", "gloo"]


def _host_cache(caches):
    """(path, codes or raw, scale or None) of every cache leaf, on the host."""
    from repro_torch.serving.kv_cache import QuantKV, tree_leaves

    out = []
    for path, leaf in tree_leaves(caches):
        if isinstance(leaf, QuantKV):
            out.append((path, leaf.codes.clone(), leaf.scale.clone()))
        else:
            out.append((path, leaf.clone(), None))
    return out


def serve(cfg, params, tokens, bits, shard=None):
    """One fixed-batch run (prefill, ``GEN - 1`` greedy decode steps) of
    ``tokens`` (this rank's rows with ``shard``): the prefill logits,
    tokens, final caches and bytes/token (a rank's share)."""
    from repro_torch.launch.serve import run_fixed
    from repro_torch.serving.kv_cache import CacheQuantConfig

    qcfg = CacheQuantConfig(bits=bits) if bits else None
    out = run_fixed(
        cfg, params, tokens, gen=GEN, qcfg=qcfg, cache_dtype=torch.float32, shard=shard
    )
    return dict(
        logits=out["logits"],
        tokens=out["tokens"],
        caches=_host_cache(out["caches"]),
        bytes=out["bytes_per_token"],
        bytes_accounted=out["bytes_per_token_accounted"],
    )


def teacher_forced(cfg, params, tokens, bits, teacher, shard=None):
    """A fresh prefill of ``tokens``, then ``TEACHER`` decode steps fed
    ``teacher``'s tokens: their logits, (B, TEACHER, V)."""
    from repro_torch.serving.engine import build_decode_step, build_prefill_step
    from repro_torch.serving.kv_cache import CacheQuantConfig

    qcfg = CacheQuantConfig(bits=bits) if bits else None
    pre = build_prefill_step(
        cfg, PROMPT + GEN, cache_dtype=torch.float32, qcfg=qcfg, shard=shard
    )
    dec = build_decode_step(cfg, shard)
    _, caches = pre(params, tokens)
    steps = []
    for i in range(TEACHER):
        logits, _ = dec(params, caches, teacher[:, i : i + 1], PROMPT + i)
        steps.append(logits)
    return torch.cat(steps, dim=1)


def _runs(res, inputs):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving.engine import serve_shard
    from repro_torch.weights import params_from_jax, shard_params

    meshes = {}
    for name, (arch, shape, bits, batch) in RUNS.items():
        if shape not in meshes:  # every rank makes the groups, in one order
            meshes[shape] = make_mesh(shape, "cpu")
        mesh = meshes[shape]
        cfg = get_config(arch, smoke=True)
        t0 = time.perf_counter()
        shard = serve_shard(cfg, mesh, batch, cache_dtype=torch.float32)
        params = params_from_jax(inputs["weights"][arch], cfg, device="cpu")
        params = shard_params(params, shard.param_specs, mesh)
        rows = shard.rows()
        tokens = inputs["prompts"][name][rows]
        teacher = inputs["teacher"][name][rows]
        out = serve(cfg, params, tokens, bits, shard)
        out["teacher_logits"] = teacher_forced(
            cfg, params, tokens, bits, teacher, shard
        )
        out.update(
            rows=(rows.start, rows.stop),
            sizes=mesh.sizes,
            coords=mesh.coords,
            cache_specs=shard.cache_specs,
            seq_shards=shard.seq_shards(),
            copies=shard.copies(),
            model_calls=shard.axis.comm.stats()["calls"],
            seq_calls=(
                shard.axis.seq.stats()["calls"]
                if shard.axis.seq is not shard.axis.comm
                else None
            ),
            seconds=time.perf_counter() - t0,
        )
        res[name] = out


def _launcher(res):
    from repro_torch.launch import serve as launch_serve

    from _torch_dist import quiet_call

    out, printed = quiet_call(launch_serve.main, LAUNCH_ARGS + LAUNCH_MESH)
    res["launch"] = dict(
        tokens=out["tokens"],
        rows=out["shard"].rows(),
        bytes=out["bytes_per_token"],
        printed=printed,
    )


def _refusal(fn):
    try:
        fn()
    except (NotImplementedError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _refusals(res, inputs):
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving.engine import DecodeLoop, serve_shard
    from repro_torch.weights import params_from_jax, shard_params

    from _torch_dist import quiet_call

    out = {"mesh_1x2": _refusal(lambda: make_mesh((1, 2), "cpu"))}
    out["mesh_3x2"] = _refusal(lambda: make_mesh((3, 2), "cpu"))
    mesh = make_mesh((2, 2), "cpu")
    train = [
        "--arch", "gemma3-1b", "--smoke", "--device", "cpu", "--mesh", "2x2",
        "--batch", "4", "--seq", "16", "--steps", "1", "--production-mesh",
    ]  # fmt: skip
    out["train"] = _refusal(lambda: quiet_call(launch_train.main, train))
    cfg = get_config("gemma3-1b", smoke=True)
    shard = serve_shard(cfg, mesh, 4, cache_dtype=torch.float32)
    params = shard_params(
        params_from_jax(inputs["weights"]["gemma3-1b"], cfg, device="cpu"),
        shard.param_specs,
        mesh,
    )
    caches = shard.zero_caches(cfg, PROMPT + GEN, torch.float32, "cpu")
    out["graph_under_gloo"] = _refusal(
        lambda: DecodeLoop(cfg, params, caches, 2, 2, graph=True, shard=shard)
    )
    res["refusals"] = out


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
        _launcher(res)
        _refusals(res, inputs)
        res["seconds"] = time.time() - res["t0"]
        torch.save(res, os.path.join(out_dir, f"card{rank}.pt"))
    finally:
        dist.destroy_process_group()


# the card tests: smoke configs at 1x2 over NCCL, one card a rank
CARD_BITS = 8


def card_prompts():
    import numpy as np

    rng = np.random.default_rng(7)
    return torch.from_numpy(rng.integers(0, 512, (4, PROMPT)))


def card_serve(device, shard=None, graph=None, arch="gemma3-1b"):
    """``arch``'s smoke config (the seeded init, seed 1, cut to ``shard``'s
    shards) through ``run_fixed`` on ``device``: prefill logits, tokens
    and caches on the host (a raw leaf's scale None)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_fixed
    from repro_torch.models.model import init_params
    from repro_torch.serving.kv_cache import CacheQuantConfig
    from repro_torch.weights import init_sharded_params

    cfg = get_config(arch, smoke=True)
    tokens = card_prompts()
    if shard is None:
        params = init_params(cfg, 1, device)
    else:
        params = init_sharded_params(cfg, 1, device, shard.param_specs, shard.mesh)
        tokens = tokens[shard.rows()]
    out = run_fixed(
        cfg,
        params,
        tokens.to(device),
        gen=GEN,
        qcfg=CacheQuantConfig(bits=CARD_BITS),
        cache_dtype=torch.float32,
        graph=graph,
        shard=shard,
    )
    caches = [
        (p, c.cpu(), None if s is None else s.cpu())
        for p, c, s in _host_cache(out["caches"])
    ]
    return dict(
        logits=out["logits"].cpu(),
        tokens=out["tokens"].cpu(),
        caches=caches,
        bytes=out["bytes_per_token"],
    )


def card_tp_rank(rank, world, store, out_dir, arch="gemma3-1b"):
    """One NCCL rank of a card test: the graphed decode (its model-axis
    collectives captured) and the eager one, to ``<out_dir>/card<r>.pt``."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving.engine import serve_shard

    device = f"cuda:{rank}"
    torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl", store=dist.FileStore(store, world), rank=rank, world_size=world
    )
    try:
        from repro_torch.configs import get_config

        mesh = make_mesh((1, world), device)
        cfg = get_config(arch, smoke=True)
        shard = serve_shard(cfg, mesh, 4, cache_dtype=torch.float32)
        res = dict(
            graphed=card_serve(device, shard, arch=arch),
            eager=card_serve(device, shard, graph=False, arch=arch),
            rows=shard.rows(),
            sizes=mesh.sizes,
            coords=mesh.coords,
            cache_specs=shard.cache_specs,
        )
        torch.save(res, os.path.join(out_dir, f"card{rank}.pt"))
    finally:
        # the decode graphs hold the NCCL communicator they captured, whose
        # destruction waits for them: free them (reference cycles) first
        gc.collect()
        dist.destroy_process_group()
