"""Serving launcher: quantized KV cache, fixed batch or continuous batching.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch gemma3-1b --batch 4 --prompt-len 1024 --gen 32 --cache-bits 8

``--scheduler fixed`` runs a batched prefill and then a decode loop (all
requests the same length); ``continuous`` runs the paged admit/decode/retire
loop (per-request lengths, slot reuse). ``--cache-bits 4|8`` stores the KV
cache as log-quant codes + per-row scales; 0 keeps the raw
``--cache-dtype``. ``--arch mamba2-370m`` serves with the fixed scheduler
only (the continuous one refuses SSM stacks, as the JAX package's does),
and its cache, a conv window and an SSM state per layer, stays raw
whatever ``--cache-bits``; so does jamba-v0.1-52b's Mamba-2 layers', while
its attention layer's K/V are quantized. A VLM's fixed-batch prompts
(chameleon-34b) are the mixed image and text ids of
``models.multimodal.vq_tokens_stub``. deepseek-v3-671b caches MLA's latent
rows (``ckv``, ``krope``; quantized like K/V). musicgen-medium (fixed
scheduler only, as in the JAX package) prefills the (B, L, 4) codebook
grid of ``codec_tokens_stub`` after the conditioning prefix of
``conditioning_stub``, and decodes one greedy token a codebook from
position L + cond_len. Runs on the card unless ``--device cpu`` is given;
weights come from a seeded init. On the card both schedulers decode by
replaying a CUDA graph of the decode step (``repro_torch.graphs``); on the
CPU the steps run eagerly. :func:`run_fixed` and :func:`run_continuous` are
the two paths as functions, for callers that bring their own weights and
prompts; their ``graph=False`` gives the eager decode on the card, for
comparisons.

Tensor-parallel serving over a ``(data, model)`` mesh of processes:

    python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.serve --arch gemma3-1b --mesh 1x2 ...

``--mesh DxM`` spans D x M ranks (rank d * M + m); under torchrun without
``--mesh`` the mesh is (1, world), every rank on the model axis, the JAX
launcher's default. Each rank draws the seeded init and keeps its shards
(``weights.init_sharded_params``), takes its data group's rows of the
batch (``launch/sharding.py:batch_spec``) and holds its shard of the cache
(``serving/engine.py:cache_specs``); rank 0 prints, the bytes/token its
share (the ranks' shares sum to the one-process figure). Over gloo (ranks
sharing a card, or the CPU) the decode runs eagerly, which the launcher
asks for and prints; over NCCL it replays a graph with the collectives
captured. Every architecture serves so with the fixed scheduler (MoE
expert-parallel, MLA's latent cache and Mamba-2's state split as the JAX
package splits them, codebooks and the ``cond`` prefix), and the token
LMs with ``--scheduler continuous`` (the grid's slots over the data axis,
every request's tokens gathered to every rank after the run). Training
over the same mesh: ``launch/train.py --mesh DxM``. ``--production-mesh``
serves on the H100 production mesh (32 x 8 over 256 ranks; with
``--multi-pod`` 64 x 8 over 512) under a torchrun of that many ranks, and
raises at another world size (``launch/mesh.py:make_production_mesh``).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import init_distributed, make_mesh
from repro_torch.launch.train import launch_mesh, parse_mesh
from repro_torch.models.common import DTYPES, resolve_device
from repro_torch.models.model import init_params
from repro_torch.models.multimodal import (
    codec_tokens_stub,
    conditioning_stub,
    vq_tokens_stub,
)
from repro_torch.serving.engine import (
    ServeShard,
    build_generate_fn,
    build_prefill_step,
    greedy_sample,
    serve_shard,
)
from repro_torch.serving.kv_cache import (
    CacheQuantConfig,
    cache_bytes_per_token,
    cache_bytes_per_token_accounting,
    tree_is_quantized,
)
from repro_torch.serving.scheduler import ContinuousScheduler, Request
from repro_torch.weights import init_sharded_params

__all__ = ["run_fixed", "run_continuous", "launch_inputs", "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_fixed(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    *,
    gen: int,
    qcfg: CacheQuantConfig | None = None,
    cache_dtype: torch.dtype = torch.bfloat16,
    temperature: float = 0.0,
    graph: bool | None = None,
    cond: torch.Tensor | None = None,
    shard: ServeShard | None = None,
) -> dict[str, Any]:
    """Batched prefill of ``tokens`` (B, L), or (B, L, cb) with codebooks,
    after the conditioning prefix ``cond`` (B, cond_len, d) where given,
    then ``gen - 1`` decode steps from position L + cond_len, replayed from
    a CUDA graph on the card unless ``graph=False``.

    Returns the prefill's last-position logits, the caches, the ``gen``
    tokens of each row, bytes/token (measured and accounted) and the host
    seconds of prefill and of decode, each ending in a device sync;
    ``decode_s`` includes the graph's capture, whose host seconds
    ``capture_s`` also gives on their own.

    ``shard`` (``serving.engine.serve_shard``): this rank's part of a
    tensor-parallel run, ``params`` its shards and ``tokens`` its rows
    (``shard.rows()``); the caches are its shard, bytes/token its share,
    and ``collective_s`` the host seconds inside the model-axis
    collectives (in prefill and decode together)."""
    device = tokens.device
    prompt_len = tokens.shape[1]
    b = shard.batch if shard is not None else tokens.shape[0]
    copies = shard.copies if shard is not None else 1
    start = prompt_len + (cond.shape[1] if cond is not None else 0)
    max_seq = start + gen
    prefill = build_prefill_step(
        cfg, max_seq, cache_dtype=cache_dtype, qcfg=qcfg, shard=shard
    )
    generate = build_generate_fn(
        cfg, temperature=temperature, graph=graph, shard=shard
    )
    t0 = time.perf_counter()
    logits, caches = prefill(params, tokens, cond)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    first = greedy_sample(logits)
    sample_gen = torch.Generator(device=device).manual_seed(2)
    t0 = time.perf_counter()
    caches, _, _, sampled = generate(params, caches, first, start, sample_gen, gen - 1)
    toks = torch.cat([first, sampled], dim=1)
    _sync(device)
    t_decode = time.perf_counter() - t0
    return {
        "logits": logits,
        "caches": caches,
        "tokens": toks,
        "bytes_per_token": cache_bytes_per_token(caches, b, max_seq, copies),
        "bytes_per_token_accounted": cache_bytes_per_token_accounting(
            caches, b, max_seq, copies
        ),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "capture_s": generate.capture_s,
        "collective_s": (
            shard.axis.collective_host_s() if shard is not None else 0.0
        ),
    }


def run_continuous(
    cfg: ModelConfig,
    params: dict,
    prompts: list[np.ndarray],
    *,
    gen: int,
    slots: int,
    qcfg: CacheQuantConfig | None = None,
    cache_dtype: torch.dtype = torch.bfloat16,
    temperature: float = 0.0,
    graph: bool | None = None,
    shard: ServeShard | None = None,
) -> dict[str, Any]:
    """Every prompt as a request of ``gen`` new tokens through ``slots``
    decode slots of the continuous scheduler, on the device of ``params``,
    its decode chunks replayed from a CUDA graph on the card unless
    ``graph=False``. Returns each request's tokens, the scheduler,
    bytes/token (measured and accounted) and the host seconds of the whole
    run and, within them, of the graph's capture (``capture_s``).

    ``shard`` (``serving.engine.serve_shard`` of ``slots`` rows): this
    rank's part of a run over a mesh, ``params`` its shards; every rank
    gets the same prompts and returns every request's tokens; the cache's
    positions are rounded up to a multiple of its sequence shards;
    bytes/token are its share, ``collective_s`` the host seconds inside
    the collectives."""
    device = params["embed"].device
    max_seq = max(len(p) for p in prompts) + gen
    if shard is not None:
        max_seq = -(-max_seq // shard.seq_shards()) * shard.seq_shards()
    sched = ContinuousScheduler(
        cfg,
        params,
        slots=slots,
        max_seq=max_seq,
        cache_dtype=cache_dtype,
        qcfg=qcfg,
        temperature=temperature,
        device=device,
        graph=graph,
        shard=shard,
    )
    copies = shard.copies if shard is not None else 1
    reqs = [Request(uid=i, prompt=p, max_new=gen) for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    done = sched.run(reqs)
    _sync(device)
    return {
        "tokens": done,
        "scheduler": sched,
        "bytes_per_token": cache_bytes_per_token(sched.caches, slots, max_seq, copies),
        "bytes_per_token_accounted": cache_bytes_per_token_accounting(
            sched.caches, slots, max_seq, copies
        ),
        "seconds": time.perf_counter() - t0,
        "capture_s": sched.capture_s,
        "collective_s": (
            shard.axis.collective_host_s() if shard is not None else 0.0
        ),
    }


def launch_inputs(
    cfg: ModelConfig, batch: int, prompt_len: int
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The fixed scheduler's seeded prompts on the host, (B, L) or (B, L,
    cb), and the conditioning prefix where ``cfg`` has one (else None): a
    VLM's mixed image and text ids, a codebook grid, or uniform ids."""
    gen = torch.Generator().manual_seed(0)
    if cfg.n_codebooks:
        tokens = codec_tokens_stub(gen, batch, prompt_len, cfg)
    elif cfg.arch_type == "vlm":
        tokens = vq_tokens_stub(gen, batch, prompt_len, cfg)
    else:
        tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen)
    cond = conditioning_stub(gen, batch, cfg) if cfg.cond_len else None
    return tokens, cond


def main(argv: list[str] | None = None) -> dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument(
        "--batch",
        type=int,
        default=4,
        help="decode slots (fixed: batch; continuous: grid size)",
    )
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument(
        "--requests",
        type=int,
        default=None,
        help="continuous only: total requests (default 2x batch)",
    )
    ap.add_argument("--cache-dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument(
        "--cache-bits",
        type=int,
        default=0,
        choices=(0, 4, 8),
        help="log-quant the KV cache (0 = raw --cache-dtype)",
    )
    ap.add_argument("--scheduler", default="fixed", choices=("fixed", "continuous"))
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument(
        "--repeats",
        type=int,
        default=None,
        help="cut the scanned layer pattern to R repeats (the depth only; "
        "the widths stay the config's)",
    )
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument(
        "--mesh",
        default=None,
        help="'DxM': data x model ranks under torchrun (default 1xworld "
        "there, one process without it)",
    )
    ap.add_argument(
        "--dist-backend",
        default=None,
        choices=("nccl", "gloo"),
        help="under torchrun: the process group's backend (default nccl on "
        "CUDA, gloo on the CPU)",
    )
    ap.add_argument(
        "--production-mesh",
        action="store_true",
        help="the H100 production mesh, 32x8 over 256 ranks (in place of --mesh)",
    )
    ap.add_argument(
        "--multi-pod",
        action="store_true",
        help="the production mesh of two scalable units, 64x8 over 512 ranks",
    )
    args = ap.parse_args(argv)
    created = init_distributed(args.dist_backend, args.device)
    try:
        if args.dist_backend and not dist.is_initialized():
            raise ValueError(
                "--dist-backend needs a process group: run under torchrun "
                "(python -m torch.distributed.run)"
            )
        return _serve(args)
    finally:
        if created:
            # a decode graph that captured NCCL collectives holds its
            # communicator, whose destruction waits for the graph: free the
            # graphs (reference cycles) first
            gc.collect()
            dist.destroy_process_group()


def _serve(args: argparse.Namespace) -> dict[str, Any]:
    world = dist.get_world_size() if dist.is_initialized() else 1
    if args.production_mesh or args.multi_pod:
        mesh = launch_mesh(args)
    else:
        shape = parse_mesh(args.mesh) if args.mesh else (1, world)
        mesh = make_mesh(shape, args.device)
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    device = resolve_device(mesh.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.repeats is not None:
        cfg = dataclasses.replace(cfg, repeats=args.repeats)
    cache_dtype = DTYPES[args.cache_dtype]
    qcfg = CacheQuantConfig(bits=args.cache_bits) if args.cache_bits else None
    shard = graph = None
    if mesh.distributed or mesh.model > 1:
        shard = serve_shard(cfg, mesh, args.batch, cache_dtype=cache_dtype)
        say(
            f"# mesh: {{'data': {mesh.data}, 'model': {mesh.model}}} over "
            f"{mesh.world} ranks ({mesh.backend}); {shard.axis.comm!r}, "
            f"sequence {shard.axis.seq!r}"
        )
        if mesh.backend == "gloo":
            graph = False
            say(
                "# decode: eager (graph=False): gloo runs the collectives "
                "from the host, which a CUDA graph cannot capture"
            )
        # ranks that share a card (gloo) draw their weights in turn, each
        # returning its cached blocks to the card after its turn: a layer is
        # drawn whole before it is cut (a deepseek-v3-671b MoE layer's
        # expert stacks, 22.5 GB in bf16 after 30 GB of f32 draws), and the
        # ranks' draws at once would not fit
        turns = mesh.world if mesh.backend == "gloo" and device.type == "cuda" else 1
        for turn in range(turns):
            if turns == 1 or turn == mesh.rank:
                params = init_sharded_params(cfg, 1, device, shard.param_specs, mesh)
            if turns > 1:
                torch.cuda.empty_cache()
                dist.barrier()
    else:
        params = init_params(cfg, 1, device)

    if args.scheduler == "continuous":
        n_req = args.requests or 2 * args.batch
        rng = np.random.default_rng(0)
        prompts = [
            rng.integers(0, cfg.vocab_size, size=args.prompt_len) for _ in range(n_req)
        ]
        out = run_continuous(
            cfg,
            params,
            prompts,
            gen=args.gen,
            slots=args.batch,
            qcfg=qcfg,
            cache_dtype=cache_dtype,
            temperature=args.temperature,
            graph=graph,
            shard=shard,
        )
        dt = out["seconds"]
        total = sum(len(v) for v in out["tokens"].values())
        share = " (this rank's share)" if shard is not None else ""
        say(
            f"continuous: {n_req} requests x {args.gen} tokens through "
            f"{args.batch} slots in {dt:.2f}s ({total / max(dt, 1e-9):.1f} tok/s, "
            f"{out['scheduler'].steps} chunks, capture {out['capture_s']:.3f}s) "
            f"on {device}"
        )
        say(
            f"cache: quantized={tree_is_quantized(out['scheduler'].caches)} "
            f"{out['bytes_per_token']:.1f} bytes/token{share}"
        )
        if shard is not None:
            say(
                f"collectives: {out['collective_s']:.3f}s of {dt:.3f}s on the "
                f"host ({out['collective_s'] / max(dt, 1e-9):.1%})"
            )
        say("sample token ids:", out["tokens"][0][:16])
        out.update(params=params, prompts=prompts, shard=shard)
        return out

    tokens, cond = launch_inputs(cfg, args.batch, args.prompt_len)
    cond = cond.to(device) if cond is not None else None
    full_shape = tuple(tokens.shape)
    if shard is not None:
        tokens = tokens[shard.rows()]
        cond = cond[shard.rows()] if cond is not None else None
    tokens = tokens.to(device)
    out = run_fixed(
        cfg,
        params,
        tokens,
        gen=args.gen,
        qcfg=qcfg,
        cache_dtype=cache_dtype,
        temperature=args.temperature,
        graph=graph,
        cond=cond,
        shard=shard,
    )
    share = " (this rank's share)" if shard is not None else ""
    say(
        f"prefill {full_shape} in {out['prefill_s']:.3f}s (cache quantized="
        f"{tree_is_quantized(out['caches'])}, {out['bytes_per_token']:.1f} "
        f"bytes/token{share}) on {device}"
    )
    dt = out["decode_s"]
    say(
        f"decoded {args.gen} tokens/seq x {args.batch} seqs in {dt:.3f}s "
        f"({args.gen * args.batch / max(dt, 1e-9):.1f} tok/s, capture "
        f"{out['capture_s']:.3f}s)"
    )
    if shard is not None:
        total = out["prefill_s"] + out["decode_s"]
        say(
            f"collectives: {out['collective_s']:.3f}s of {total:.3f}s on the "
            f"host ({out['collective_s'] / max(total, 1e-9):.1%})"
        )
    say("sample token ids:", out["tokens"][0, :16].tolist())
    # for a caller that goes on from this run (a comparison's teacher-forced
    # decode): the weights, this rank's prompt rows and prefix, its shard
    out.update(params=params, prompt=tokens, cond=cond, shard=shard)
    return out


if __name__ == "__main__":
    main()
