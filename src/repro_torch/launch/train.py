"""LM training launcher: the JAX package's ``python -m repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --mesh 4x1 --batch 8 --seq 512 --compressor lq_sgd --rank 1 --bits 8 \\
        --steps 3

trains the LM at full width over the mesh's N data-parallel workers
(``--mesh Nx1``: worker w takes rows w*B/N .. (w+1)*B/N - 1 of each global
batch), with the compressed gradient sync in every step, from a seeded
init and the JAX package's synthetic tokens (``data/synthetic.py:
lm_batch``; codebook grids for musicgen, with the conditioning prefix
drawn in numpy as the JAX launcher draws it, ``cond_batch``). All ten
architectures train; a model with Mamba-2 layers trains through the SSD's
plain version, as the JAX package does. ``--smoke`` takes the reduced
config; ``--device cpu`` runs on the CPU (the tests); by default it runs
on the card, in f32 wherever the config is f32 (TF32 off, as the JAX
package computes).

Run as it is, one process holds all N workers on one device. Under
torchrun the mesh spans the ranks (``launch/mesh.py``), each holding
N / world workers and their rows, and the sync's collectives are
``torch.distributed`` ones (``core/comm.py:DistComm``):

    python -m torch.distributed.run --nproc-per-node 2 \\
        -m repro_torch.launch.train --mesh 4x1 ...

``--dist-backend`` is NCCL on CUDA by default (one rank a card; the step
is one CUDA-graph replay) and gloo on the CPU; ``--dist-backend gloo
--device cuda:0`` puts every rank on one card (eager steps: the launcher
asks for them, ``graph=False``, and prints so). Each rank builds the
global batch and keeps its rows; rank 0 alone prints and writes the
checkpoints, which hold all N workers' rows whatever the world size.
``--deterministic`` turns PyTorch's deterministic algorithms on (warn
only), for runs compared bit for bit.

``--mesh DxM`` with M > 1 trains tensor-parallel over D x M ranks (rank
d * M + m holds coordinate (d, m), one worker a rank):

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.launch.train --arch gemma3-1b --mesh 2x2 ...

Each rank draws the seeded init and keeps its blocks of the training tree
(``train/step.py:train_param_specs``), with its optimizer state and error
feedback; the step's sync runs over its data-axis group and the
forward's collectives over its model-axis group (``train/step.py``).
Checkpoints hold the one-process layout, so a run resumes on any mesh of
the same data axis. All ten architectures and every compressor, codec,
policy, schedule, lazy group and wire train so: each rank's synced block
is the block of what one process computes.

The step runs under the async runtime by default (prefetched batches,
deferred metric reads, background checkpoints: ``train/runtime.py``);
``--runtime sync`` is the reference loop. The JAX launcher's flags carry
over. ``--codec dlog|lrq`` and ``--dp-epsilon`` put the randomized privacy
codecs on the LQ-SGD wire (through the composite compressor); the run's
line then also prints the per-step DP epsilon and its kind. Every
compressor, codec, policy, schedule, lazy group and wire runs over the
ranks as in one process. ``--production-mesh`` trains on the H100
production mesh (``launch/mesh.py:make_production_mesh``: 32 x 8, one
DGX SuperPOD scalable unit of 256 cards; ``--multi-pod`` two units, 64 x
8, 512 cards) under a torchrun of that many ranks across the nodes
(``--nnodes 32 --nproc-per-node 8``); at another world size it raises,
naming the ranks it takes. ``python -m repro_torch.launch.dryrun`` traces
one rank's step of it on no card. ``--dump DIR`` has each rank write
``DIR/rank<r>.pt`` (the history, every gathered wire array, the
fingerprints of the final parameters and of this rank's rows of the
compressor state, its kernel launches, each step's seconds and collective
seconds, its peak device memory; ``--dump-steps`` adds each step's
parameter fingerprints and lazy staleness counters and step 0's synced
gradients, ``--dump-sample`` only a sample of their positions;
``--dump-wire-steps K`` keeps the wire arrays of the first K steps only,
0 none: TopK's is the dense f32 stand-in), which a comparison reads.
``--repeats R`` cuts the scanned layer pattern to R repeats and
``--keep-pattern I,J`` to its positions I, J (``''``: none, the lead
layers alone): depth cuts at full width, for a run that must fit one
card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import os
import statistics
import time
from collections.abc import Iterator
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.io import ModelShards, leaf_fingerprints, peek_step
from repro_torch.checkpoint.io import restore as ckpt_restore
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.comm import ModelAxis, ModelComm
from repro_torch.core.compressors import CompressorConfig, model_split
from repro_torch.core.lazy import STALE_NS
from repro_torch.core.policy import format_plan_report, parse_decay_spec
from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.data.synthetic import LMDataConfig, cond_batch, lm_batch
from repro_torch.kernels import ops
from repro_torch.launch.mesh import (
    DataMesh,
    init_distributed,
    make_comm,
    make_mesh,
    make_model_comm,
    make_production_mesh,
)
from repro_torch.models.model import count_params
from repro_torch.train.data_parallel import _tf32_off
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.runtime import AsyncRunner, RuntimeConfig, run_schedule
from repro_torch.train.step import (
    build_train_step,
    init_train_state,
    make_model_compressor,
    train_param_specs,
    train_state_specs,
)
from repro_torch.train.trainer import WORKER_ROWS, Trainer, is_rank0

__all__ = ["main", "parse_mesh", "launch_mesh"]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true", help="the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--optimizer", default="sgd", choices=("sgd", "adam"))
    ap.add_argument(
        "--compressor",
        default="lq_sgd",
        choices=("none", "topk", "qsgd", "powersgd", "lq_sgd"),
    )
    ap.add_argument(
        "--policy",
        default=None,
        help="per-leaf policy: 'uniform' (default), 'auto' (the cost-model "
        "planner) or a spec 'pattern=method:knob=v,...'; else the config's hint",
    )
    ap.add_argument("--error-budget", type=float, default=0.3)
    ap.add_argument(
        "--warmup", type=int, default=0, help="exact f32 sync for the first W steps"
    )
    ap.add_argument(
        "--decay", default=None, help="rank/bit caps, e.g. '200:rank=1,500:bits=4'"
    )
    ap.add_argument("--lazy-thresh", type=float, default=0.0)
    ap.add_argument("--max-stale", type=int, default=4)
    ap.add_argument("--lazy-adaptive", type=float, default=0.0)
    ap.add_argument("--lazy-mode", default="elide", choices=("elide", "gate"))
    ap.add_argument("--rank", type=int, default=1)
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--alpha", type=float, default=10.0)
    ap.add_argument("--wire", default="symmetric", choices=("symmetric", "server"))
    ap.add_argument("--participation", type=float, default=1.0)
    ap.add_argument(
        "--agg", default="participation", choices=("participation", "sparsity")
    )
    ap.add_argument("--participation-seed", type=int, default=0)
    ap.add_argument(
        "--noniid-alpha",
        type=float,
        default=0.0,
        help="federated non-IID tokens: worker w's rows are client w's (0 = IID)",
    )
    ap.add_argument(
        "--wire-accounting",
        "--wire-mode",
        dest="wire_accounting",
        default="allgather_codes",
        choices=("allgather_codes", "psum_sim"),
    )
    ap.add_argument(
        "--codec",
        default=None,
        help="the lq_sgd leaves' wire codec: 'log' (deterministic), 'dlog' "
        "(dithered, DP), 'lrq' (layered randomized); default by --dp-epsilon",
    )
    ap.add_argument(
        "--dp-epsilon",
        type=float,
        default=0.0,
        help="per-use DP budget of each transmitted tensor; > 0 calibrates "
        "dlog's noise",
    )
    ap.add_argument("--dp-delta", type=float, default=1e-5)
    ap.add_argument(
        "--avg-mode", default="paper", choices=("paper", "dequant_then_mean")
    )
    ap.add_argument("--fuse", action="store_true", help="one collective per phase")
    ap.add_argument("--comp-dtype", default="float32")
    ap.add_argument(
        "--mesh",
        default=None,
        help="'DxM': D data-parallel workers over this process or, under "
        "torchrun, over its ranks; M > 1 splits the model over M ranks of "
        "each data row (D x M ranks under torchrun; default 1x1)",
    )
    ap.add_argument(
        "--dist-backend",
        default=None,
        choices=("nccl", "gloo"),
        help="under torchrun: the process group's backend (default nccl on "
        "CUDA, gloo on the CPU)",
    )
    ap.add_argument(
        "--deterministic",
        action="store_true",
        help="PyTorch's deterministic algorithms (warn only), for bit-for-bit "
        "comparisons",
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
    ap.add_argument("--runtime", default="async", choices=("async", "sync"))
    ap.add_argument(
        "--microbatch",
        type=int,
        default=1,
        help="gradient accumulation: k sequential microbatches, one sync",
    )
    ap.add_argument("--prefetch", type=int, default=2)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-path", default="checkpoints/state.ckpt")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument(
        "--repeats",
        type=int,
        default=None,
        help="cut the scanned layer pattern to R repeats (the depth only; "
        "the widths stay the config's)",
    )
    ap.add_argument(
        "--keep-pattern",
        default=None,
        help="keep only these comma-separated positions of the scanned layer "
        "pattern ('' keeps none: the lead and tail layers alone); a depth cut "
        "like --repeats",
    )
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dump", default=None, help="write DIR/rank<r>.pt")
    ap.add_argument(
        "--dump-steps",
        action="store_true",
        help="with --dump: each step's parameter fingerprints and step 0's "
        "synced gradients (on the host) too",
    )
    ap.add_argument(
        "--dump-sample",
        action="store_true",
        help="with --dump-steps: step 0's synced gradients at every "
        "sample_stride-th position of each leaf's last dim only, the same "
        "positions of a rank's block as of the whole leaf, and each leaf's "
        "(block's) largest absolute value",
    )
    ap.add_argument(
        "--dump-wire-steps",
        type=int,
        default=None,
        help="with --dump: keep the gathered wire arrays of the first K steps "
        "only (default: every step's; 0: none)",
    )
    return ap


def parse_mesh(spec: str | None) -> tuple[int, int]:
    """'4x1' -> (4, 1), a (data, model) mesh; None -> (1, 1), the one card
    on the data axis."""
    if spec is None:
        return (1, 1)
    data, model = (int(x) for x in spec.split("x"))
    return data, model


def launch_mesh(args: argparse.Namespace) -> DataMesh:
    """The launcher's mesh: the production mesh with ``--production-mesh``
    or ``--multi-pod`` (``--mesh``, if given, must name its shape), else
    ``--mesh``'s."""
    if args.production_mesh or args.multi_pod:
        mesh = make_production_mesh(multi_pod=args.multi_pod, device=args.device)
        if args.mesh is not None and parse_mesh(args.mesh) != mesh.shape:
            raise ValueError(
                f"--mesh {args.mesh} with the production mesh "
                f"{mesh.data}x{mesh.model}"
            )
        return mesh
    return make_mesh(parse_mesh(args.mesh), args.device)


@contextlib.contextmanager
def _deterministic(on: bool) -> Iterator[None]:
    """PyTorch's deterministic algorithms (warn only) inside the block when
    ``on``; the setting as it was after."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    if on:
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def main(argv: list[str] | None = None) -> dict[str, Any]:
    args = _parser().parse_args(argv)
    created = init_distributed(args.dist_backend, args.device)
    try:
        if args.dist_backend and not dist.is_initialized():
            raise ValueError(
                "--dist-backend needs a process group: run under torchrun "
                "(python -m torch.distributed.run)"
            )
        if args.dist_backend and dist.get_backend() != args.dist_backend:
            raise ValueError(
                f"--dist-backend {args.dist_backend} in a {dist.get_backend()} "
                "process group"
            )
        with _deterministic(args.deterministic):
            return _train(args)
    finally:
        if created:
            # a captured step holds the NCCL communicators it recorded, whose
            # destruction waits for it: free the graphs (cycles) first
            gc.collect()
            dist.destroy_process_group()


def _train(args: argparse.Namespace) -> dict[str, Any]:
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.repeats is not None:
        cfg = dataclasses.replace(cfg, repeats=args.repeats)
    if args.keep_pattern is not None:
        keep = [int(i) for i in args.keep_pattern.split(",") if i]
        cfg = dataclasses.replace(cfg, pattern=tuple(cfg.pattern[i] for i in keep))
    comp_cfg = CompressorConfig(
        name=args.compressor,
        rank=args.rank,
        bits=args.bits,
        alpha=args.alpha,
        wire_accounting=args.wire_accounting,
        avg_mode=args.avg_mode,
        codec=args.codec,
        dp_epsilon=args.dp_epsilon,
        dp_delta=args.dp_delta,
        fuse_collectives=args.fuse,
        state_dtype=args.comp_dtype,
        policy=args.policy or cfg.compression_policy,
        error_budget=args.error_budget,
        warmup_steps=args.warmup,
        schedule_decay=parse_decay_spec(args.decay) if args.decay else (),
        lazy_thresh=args.lazy_thresh,
        max_stale=args.max_stale,
        lazy_adaptive=args.lazy_adaptive,
        lazy_mode=args.lazy_mode,
        topology=args.wire,
        participation=args.participation,
        agg=args.agg,
        participation_seed=args.participation_seed,
    )
    compressor = make_model_compressor(cfg, comp_cfg)
    mesh = launch_mesh(args)
    n_dp, dev = mesh.data, mesh.device
    keep_wire = args.dump_wire_steps
    comm = make_comm(mesh, record=args.dump is not None and keep_wire != 0)
    say = print if is_rank0(comm) else lambda *a, **k: None
    tp = None
    if mesh.model > 1:
        tp = ModelAxis(
            comm=make_model_comm(mesh),
            seq=ModelComm(),
            specs=train_param_specs(cfg, mesh.model),
        )
    if getattr(compressor, "plan_report", None):
        say(format_plan_report(compressor.plan_report))
    optimizer = make_optimizer(args.optimizer, args.lr)
    data_cfg = LMDataConfig(
        vocab_size=cfg.vocab_size,
        seq_len=args.seq,
        batch=args.batch,
        n_codebooks=cfg.n_codebooks,
        noniid_alpha=args.noniid_alpha,
    )

    def batch_fn(step: int) -> dict[str, np.ndarray]:
        if args.noniid_alpha <= 0:
            b = lm_batch(data_cfg, step)
        else:
            # federated rows: worker c's rows come from client c's skewed prior
            if args.batch % n_dp:
                raise ValueError(
                    f"--noniid-alpha needs --batch divisible by the {n_dp} "
                    f"workers, got {args.batch}"
                )
            per = dataclasses.replace(data_cfg, batch=args.batch // n_dp)
            chunks = [lm_batch(per, step, client=c) for c in range(n_dp)]
            b = {k: np.concatenate([ch[k] for ch in chunks]) for k in chunks[0]}
        if cfg.cond_len:
            b["cond"] = cond_batch(data_cfg, step, cfg.cond_len, cfg.d_model)
        return b

    # for --dump and a model axis's time line: (seconds, data-axis and
    # model-axis collective seconds) at each step's end; for --dump each
    # step's CommRecord numbers, and with
    # --dump-steps each step's parameter fingerprints and step 0's synced
    # gradients on the host
    step_ends, recs, steps_kept, live = [], [], {"prints": []}, {}

    def ends() -> tuple[float, float, float]:
        model_s = tp.comm.host_s if tp is not None else 0.0
        return (time.perf_counter(), getattr(comm, "host_s", 0.0), model_s)

    def mark(grads, synced, comp_state, rec) -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_ends.append(ends())
        recs.append((rec.bits_sent, rec.phys_bits, rec.n_collectives))
        if comm.gathered is not None and keep_wire is not None:
            if len(recs) == keep_wire:  # the steps kept end here
                live["wire"] = len(comm.gathered)
            del comm.gathered[live.get("wire", len(comm.gathered)) :]
        if args.dump_steps:
            steps_kept["prints"].append(leaf_fingerprints(live["params"]))
            if STALE_NS in comp_state:  # 0 where a lazy group fired
                stale = {m: v.tolist() for m, v in comp_state[STALE_NS].items()}
                steps_kept.setdefault("stale", []).append(stale)
            if "synced0" not in steps_kept:
                steps_kept["synced0"] = _host_sample(synced, tp, args.dump_sample)
                if args.dump_sample:  # each leaf's largest value, all of it
                    leaves = tree_leaves(synced)
                    steps_kept["synced0_max"] = [float(t.abs().max()) for t in leaves]

    # gloo runs its collectives from the host: the step cannot be a graph,
    # so the launcher asks for the eager one (and says so)
    graph = False if mesh.backend == "gloo" else None

    def build(comp):
        # the JAX launcher rematerializes at full width (remat_scan)
        return build_train_step(
            cfg,
            mesh.shape,
            comp,
            optimizer,
            accum_steps=args.microbatch,
            remat=not args.smoke,
            comm=comm,
            on_sync=None if args.dump is None and tp is None else mark,
            graph=graph,
            tp=tp,
        )

    def fresh_state(comp):
        return init_train_state(
            cfg, 0, optimizer, comp, mesh.local, dev, tp=tp, mesh=mesh
        )

    with _tf32_off():
        comp0 = compressor
        if args.resume:
            if not os.path.exists(args.ckpt_path):
                raise FileNotFoundError(
                    f"--resume: no checkpoint at {args.ckpt_path!r}; refusing to "
                    "restart from scratch"
                )
            # the saved compressor state is that of the phase of the last
            # step run (step0 - 1); run_schedule adapts it on entering the
            # next phase
            step0 = peek_step(args.ckpt_path)
            if hasattr(compressor, "at_step"):
                comp0 = compressor.at_step(max(step0 - 1, 0))
            like = fresh_state(comp0)
            shards = _shards(tp, like, comp0)
            state = ckpt_restore(
                args.ckpt_path,
                like,
                comm=comm,
                per_worker=WORKER_ROWS,
                shards=shards,
            )
            del like
            say(f"# resumed at step {step0} from {args.ckpt_path}")
        else:
            state = fresh_state(comp0)
            shards = _shards(tp, state, comp0)
        # the whole model's count, whatever this rank holds
        n_params = count_params(state["params"]) if tp is None else _whole_params(cfg)
        lazy_note = ""
        if getattr(comp0, "lazy_groups", None):
            lazy_mb = comp0.expected_wire_bits_per_step() / 8e6
            lazy_note = f" expected(lazy)={lazy_mb:.3f}MB"
        privacy_note = ""
        if args.codec is not None or args.dp_epsilon > 0:
            eps = comp0.privacy_epsilon_per_step(args.dp_delta)
            kinds = "+".join(comp0.privacy_epsilon_kinds()) or "none"
            privacy_note = f" epsilon/step={eps:g} ({kinds})"
        if mesh.distributed:
            say(f"# comm: {comm!r}")
        if tp is not None:
            say(
                f"# mesh: {{'data': {mesh.data}, 'model': {mesh.model}}} over "
                f"{mesh.world} ranks ({mesh.backend}); model axis {tp.comm!r}"
            )
        if graph is False:
            say("# step: eager (graph=False): gloo collectives run from the host")
        say(
            f"arch={cfg.name} params={n_params / 1e6:.1f}M "
            f"mesh={{'data': {mesh.data}, 'model': {mesh.model}}} "
            f"compressor={args.compressor} policy={comp_cfg.policy or 'uniform'} "
            f"runtime={args.runtime} microbatch={args.microbatch} "
            f"wire/step={comp0.wire_bits_per_step() / 8e6:.3f}MB{lazy_note}"
            f"{privacy_note} "
            f"(uncompressed={n_params * 4 / 1e6:.1f}MB) device={dev}",
            flush=True,
        )
        rcfg = RuntimeConfig(
            steps=args.steps,
            log_every=args.log_every,
            ckpt_every=args.ckpt_every,
            ckpt_path=args.ckpt_path,
            microbatch=args.microbatch,
            prefetch=args.prefetch,
        )
        runner_cls = AsyncRunner if args.runtime == "async" else Trainer
        runner = runner_cls(build(comp0), batch_fn, rcfg, comm=comm, shards=shards)

        def rebuild(comp_t, seg_start):
            mb = comp_t.wire_bits_per_step() / 8e6
            say(f"# schedule phase @step {seg_start}: wire/step={mb:.3f}MB")
            return build(comp_t)

        # ONE runner threads through every schedule phase; phases a restored
        # checkpoint has finished are skipped
        live["params"] = state["params"]  # updated in place by every step
        step_ends.append(ends())
        state = run_schedule(
            runner,
            compressor,
            state,
            total_steps=args.steps,
            rebuild=rebuild,
            initial=comp0,
        )
    if tp is not None and len(step_ends) > 1:
        say(_tp_step_line(step_ends))
    if args.dump is not None:
        extra = dict(recs=recs, **steps_kept)
        if tp is not None:
            split = model_split(tp.comm, tp.specs)
            extra.update(
                dims=split.dims,
                replicated_bits=comp0.model_replicated_bits(split),
                model_comm=tp.comm.stats(),
            )
        _dump(args.dump, mesh, comm, runner.history, state, step_ends, extra)
    if hasattr(runner.step_fn, "release"):
        runner.step_fn.release()  # the graph, before the process group goes
    return {
        "history": runner.history,
        "state": state,
        "n_params": n_params,
        "comm": comm,
        "tp": tp,
        "mesh": mesh,
    }


def _shards(tp: Any, state: dict[str, Any], comp: Any) -> ModelShards | None:
    """The checkpoints' model shards of ``state`` (None without a model
    axis)."""
    if tp is None:
        return None
    return ModelShards.of(tp.comm, train_state_specs(state, tp.specs, comp))


def sample_stride(n: int, keep: int = 64) -> int:
    """``--dump-sample``'s stride along a leaf's last dim of ``n`` positions
    (the whole leaf's): the largest power of two that divides ``n / 8``
    and leaves at least ``keep`` positions (1 where ``n`` is not a multiple
    of 16), so it divides the block of any model axis that divides 8 and a
    block's sampled positions are those of the whole leaf."""
    s = 1
    while n % (16 * s) == 0 and n // (2 * s) >= keep:
        s *= 2
    return s


def _host_sample(tree: Any, tp: Any, sample: bool) -> Any:
    """``tree`` (this rank's blocks) on the host, each leaf cut to its
    ``sample_stride`` positions along its last dim where ``sample``."""
    leaves = tree_leaves(tree)
    dims = [None] * len(leaves)
    if tp is not None:
        dims = model_split(tp.comm, tp.specs).dims
    out = []
    for t, dim in zip(leaves, dims, strict=True):
        if sample:
            last = t.dim() - 1
            whole = t.shape[-1] * (tp.comm.size if dim == last else 1)
            t = t[..., :: sample_stride(whole)]
        out.append(t.detach().to("cpu", copy=True))
    return tree_unflatten(tree, out)


def _tp_step_line(step_ends: list[tuple[float, float, float]]) -> str:
    """The tensor-parallel run's line: ms a step (host clock, the device
    synced at each step's end; the median of the steps after the first,
    which builds what the later ones reuse) and the shares of those steps'
    time in model-axis and data-axis collectives."""
    t, c, mc = zip(*step_ends)
    steps, data_s, model_s = ([b - a for a, b in zip(x, x[1:])] for x in (t, c, mc))
    first = 1 if len(steps) > 1 else 0
    total = sum(steps[first:])
    return (
        f"# tp step: {1e3 * statistics.median(steps[first:]):.1f} ms a step "
        f"(steps {first}..{len(steps) - 1}), model-axis collectives "
        f"{sum(model_s[first:]) / total:.1%}, data-axis "
        f"{sum(data_s[first:]) / total:.1%} (host clock)"
    )


def _whole_params(cfg: Any) -> int:
    """The whole model's parameter count (abstract shapes)."""
    from repro_torch.train.step import abstract_grads_of

    return count_params(abstract_grads_of(cfg)[0])


def _dump(out_dir, mesh, comm, history, state, step_ends, extra) -> None:
    """This rank's ``out_dir/rank<r>.pt``: the history, every gathered wire
    array, the leaves' fingerprints (the parameters; the compressor state,
    by worker row where it has them), launches, each step's seconds and
    collective seconds (host clock, the device synced at each step's end;
    the model axis's apart), peak memory, and ``extra`` (each step's
    accounted and physical bits and collectives; over a model axis the
    leaves' split dims, the bits replicated over it and its collectives by
    tag; with ``--dump-steps`` each step's parameter fingerprints and step
    0's synced gradients)."""
    (t, c, mc) = zip(*step_ends)
    dev = mesh.device
    os.makedirs(out_dir, exist_ok=True)
    dump = {
        "rank": mesh.rank,
        "history": history,
        "gathered": [g.cpu() for g in comm.gathered or []],
        "params": leaf_fingerprints(state["params"]),
        "comp": leaf_fingerprints({"comp": state["comp"]}, WORKER_ROWS),
        "launches": ops.launch_counts(),
        "step_s": [b - a for a, b in zip(t, t[1:])],
        "collective_s": [b - a for a, b in zip(c, c[1:])],
        "model_collective_s": [b - a for a, b in zip(mc, mc[1:])],
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
        "comm": repr(comm),
        **extra,
    }
    torch.save(dump, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


if __name__ == "__main__":
    main()
