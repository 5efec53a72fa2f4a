"""The rank side of ``test_torch_tp_zoo.py``: what each of the four spawned
gloo ranks runs for tensor-parallel serving of the rest of the zoo (MoE,
MLA, Mamba-2, codebooks and the conditioning prefix) and of the continuous
scheduler, on the CPU.

A rank imports ``torch`` and the port, never JAX. The parent writes the
inputs with ``torch.save`` (each architecture's weights as numpy arrays,
each run's prompts, conditioning prefix and the one-process tokens the
teacher-forced decode feeds), spawns the ranks through
``_torch_dist.spawn`` (a ``FileStore`` rendezvous, one thread a rank) and
reads back ``<out>/card<r>.pt``.
"""

import os
import time

import torch
import torch.distributed as dist

WORLD = 4
PROMPT, GEN = 24, 8  # max_seq 32 (+ cond_len): whole over 1, 2 and 4 shards
TEACHER = 4  # teacher-forced decode steps
ARCHS = (
    "mixtral-8x7b",
    "jamba-v0.1-52b",
    "deepseek-v3-671b",
    "mamba2-370m",
    "musicgen-medium",
    "gemma3-1b",
)
# run -> (arch, (data, model) mesh, cache bits, global batch), in mesh order
RUNS = {
    # 2 of 4 experts a rank, the table over both data rows; KV heads split
    "mixtral_2x2_q8": ("mixtral-8x7b", (2, 2), 8, 4),
    # Mamba-2 heads and conv channels, MoE and attention in one stack
    "jamba_2x2_q8": ("jamba-v0.1-52b", (2, 2), 8, 4),
    # the latent rows over model, 2 experts a rank, the shared expert split
    "deepseek_2x2_q8": ("deepseek-v3-671b", (2, 2), 8, 4),
    # the latent rows over data + model: the batch of 1 does not split
    "deepseek_2x2_b1": ("deepseek-v3-671b", (2, 2), 8, 1),
    "mamba2_2x2_raw": ("mamba2-370m", (2, 2), 0, 4),
    # codebooks, the conditioning prefix, KV heads over model
    "musicgen_2x2_q4": ("musicgen-medium", (2, 2), 4, 4),
    # one expert a rank, the K/V sequence over model (2 KV heads)
    "mixtral_1x4_q8": ("mixtral-8x7b", (1, 4), 8, 4),
    "jamba_1x4_q4": ("jamba-v0.1-52b", (1, 4), 4, 4),
    "deepseek_1x4_q8": ("deepseek-v3-671b", (1, 4), 8, 4),
    "mamba2_1x4_raw": ("mamba2-370m", (1, 4), 0, 4),
    "musicgen_1x4_q8": ("musicgen-medium", (1, 4), 8, 4),
}
# the continuous scheduler at 2x2 -> (arch, cache bits): requests of these
# prompt lengths, GEN new tokens each, through CONT_SLOTS slots
CONT = {
    "gemma3_cont": ("gemma3-1b", 8),  # the K/V sequence over model
    "mixtral_cont": ("mixtral-8x7b", 8),  # one table over the whole grid
    "deepseek_cont": ("deepseek-v3-671b", 8),  # the latent rows over model
}
CONT_LENS = (5, 9, 12, 7, 10, 14)
CONT_SLOTS, CONT_CHUNK, CONT_MAX_SEQ = 4, 3, 32
# what the continuous scheduler refuses over ranks, as in one process
CONT_REFUSED = ("mamba2-370m", "jamba-v0.1-52b", "musicgen-medium")
# launch/serve.py under the ranks and in one process
LAUNCH_ARGS = [
    "--arch", "jamba-v0.1-52b", "--smoke", "--device", "cpu", "--batch", "4",
    "--prompt-len", "16", "--gen", "4", "--cache-bits", "8",
    "--cache-dtype", "float32",
]  # fmt: skip
LAUNCH_CONT_ARGS = [
    "--arch", "mixtral-8x7b", "--smoke", "--device", "cpu", "--batch", "4",
    "--prompt-len", "16", "--gen", "5", "--requests", "6", "--cache-bits", "8",
    "--cache-dtype", "float32", "--scheduler", "continuous",
]  # fmt: skip
LAUNCH_MESH = ["--mesh", "2x2", "--dist-backend", "gloo"]


def host_cache(caches):
    """(path, codes or raw, scale or None) of every cache leaf, on the host."""
    from repro_torch.serving.kv_cache import QuantKV, tree_leaves

    out = []
    for path, leaf in tree_leaves(caches):
        if isinstance(leaf, QuantKV):
            out.append((path, leaf.codes.clone(), leaf.scale.clone()))
        else:
            out.append((path, leaf.clone(), None))
    return out


def _qcfg(bits):
    from repro_torch.serving.kv_cache import CacheQuantConfig

    return CacheQuantConfig(bits=bits) if bits else None


def serve(cfg, params, tokens, bits, cond=None, shard=None):
    """One fixed-batch run (prefill after ``cond``, ``GEN - 1`` greedy decode
    steps) of ``tokens`` (this rank's rows with ``shard``): the prefill
    logits, tokens, final caches and bytes/token (a rank's share)."""
    from repro_torch.launch.serve import run_fixed

    out = run_fixed(
        cfg,
        params,
        tokens,
        gen=GEN,
        qcfg=_qcfg(bits),
        cache_dtype=torch.float32,
        cond=cond,
        shard=shard,
    )
    return dict(
        logits=out["logits"],
        tokens=out["tokens"],
        caches=host_cache(out["caches"]),
        bytes=out["bytes_per_token"],
        bytes_accounted=out["bytes_per_token_accounted"],
    )


def teacher_forced(cfg, params, tokens, bits, teacher, cond=None, shard=None):
    """A fresh prefill of ``tokens``, then ``TEACHER`` decode steps fed
    ``teacher``'s tokens: their logits, (B, TEACHER[, cb], V)."""
    from repro_torch.serving.engine import build_decode_step, build_prefill_step

    start = PROMPT + cfg.cond_len
    pre = build_prefill_step(
        cfg, start + GEN, cache_dtype=torch.float32, qcfg=_qcfg(bits), shard=shard
    )
    dec = build_decode_step(cfg, shard)
    _, caches = pre(params, tokens, cond)
    steps = []
    for i in range(TEACHER):
        logits, _ = dec(params, caches, teacher[:, i : i + 1], start + i)
        steps.append(logits)
    return torch.cat(steps, dim=1)


def continuous(cfg, params, prompts, bits, shard=None):
    """The requests of ``prompts`` (GEN new tokens each) through the
    continuous scheduler's CONT_SLOTS slots: every request's tokens, the
    chunks run, the pages left and the bytes/token (a rank's share)."""
    from repro_torch.serving.kv_cache import cache_bytes_per_token
    from repro_torch.serving.scheduler import ContinuousScheduler, Request

    sched = ContinuousScheduler(
        cfg,
        params,
        slots=CONT_SLOTS,
        max_seq=CONT_MAX_SEQ,
        cache_dtype=torch.float32,
        qcfg=_qcfg(bits),
        decode_chunk=CONT_CHUNK,
        device="cpu",
        shard=shard,
    )
    reqs = [Request(uid=i, prompt=p, max_new=GEN) for i, p in enumerate(prompts)]
    tokens = sched.run(reqs)
    copies = shard.copies if shard is not None else 1
    return dict(
        tokens=tokens,
        steps=sched.steps,
        free=sched.pool.n_free,
        bytes=cache_bytes_per_token(sched.caches, CONT_SLOTS, CONT_MAX_SEQ, copies),
    )


def _stats(comm):
    return comm.stats()["calls"] if comm.size > 1 else {}


def _layout(params):
    """What a rank's first MoE layer and first MLA layer hold: its experts
    and its heads' columns of ``wq_b``."""
    out = {}
    for p in params["layers"]:
        ffn, mixer = p.get("ffn", {}), p["mixer"]
        if "w_gate" in ffn:
            out.setdefault("experts", ffn["w_gate"].shape[0])
        if "wq_b" in mixer:
            out.setdefault("wq_b_cols", mixer["wq_b"].shape[1])
    return out


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
        cond = inputs["cond"][name]
        cond = cond[rows] if cond is not None else None
        teacher = inputs["teacher"][name][rows]
        out = serve(cfg, params, tokens, bits, cond, shard)
        out["teacher_logits"] = teacher_forced(
            cfg, params, tokens, bits, teacher, cond, shard
        )
        axis = shard.axis
        out.update(
            rows=(rows.start, rows.stop),
            sizes=mesh.sizes,
            coords=mesh.coords,
            cache_specs=shard.cache_specs,
            seq_shards=shard.seq_shards(),
            model_calls=_stats(axis.comm),
            seq_calls=_stats(axis.seq) if axis.seq is not axis.comm else None,
            data_calls=_stats(axis.data),
            layout=_layout(params),
            seconds=time.perf_counter() - t0,
        )
        res[name] = out


def _continuous_runs(res, inputs):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving.engine import serve_shard
    from repro_torch.weights import params_from_jax, shard_params

    mesh = make_mesh((2, 2), "cpu")
    for name, (arch, bits) in CONT.items():
        cfg = get_config(arch, smoke=True)
        t0 = time.perf_counter()
        shard = serve_shard(cfg, mesh, CONT_SLOTS, cache_dtype=torch.float32)
        params = params_from_jax(inputs["weights"][arch], cfg, device="cpu")
        params = shard_params(params, shard.param_specs, mesh)
        out = continuous(cfg, params, inputs["cont_prompts"], bits, shard)
        out.update(
            rows=shard.rows(),
            data_calls=_stats(shard.axis.data),
            seconds=time.perf_counter() - t0,
        )
        res[name] = out


def _refusal(fn):
    try:
        fn()
    except (NotImplementedError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _launchers(res):
    from repro_torch.launch import serve as launch_serve

    from _torch_dist import quiet_call

    out, printed = quiet_call(launch_serve.main, LAUNCH_ARGS + LAUNCH_MESH)
    res["launch"] = dict(
        tokens=out["tokens"],
        rows=out["shard"].rows(),
        bytes=out["bytes_per_token"],
        printed=printed,
    )
    out, printed = quiet_call(launch_serve.main, LAUNCH_CONT_ARGS + LAUNCH_MESH)
    res["launch_cont"] = dict(
        tokens=out["tokens"], bytes=out["bytes_per_token"], printed=printed
    )
    refused = {}
    for arch in CONT_REFUSED:
        argv = LAUNCH_CONT_ARGS + LAUNCH_MESH
        argv = argv[:1] + [arch] + argv[2:]
        refused[arch] = _refusal(lambda argv=argv: quiet_call(launch_serve.main, argv))
    res["cont_refusals"] = refused


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
        _continuous_runs(res, inputs)
        _launchers(res)
        res["seconds"] = time.time() - res["t0"]
        torch.save(res, os.path.join(out_dir, f"card{rank}.pt"))
    finally:
        dist.destroy_process_group()
