"""The paper's experiment: ResNet-18 trained data-parallel over N workers
with a compressed gradient sync (the port's counterpart of
``examples/resnet_cifar_compression.py``).

    PYTHONPATH=src python -m repro_torch.launch.train_resnet \\
        --compressor lq_sgd --rank 1 --bits 8 --steps 20

The defaults are the paper's layout: 5 workers x 128 images, CIFAR-10
shape (32x32x3, 10 classes), synthetic class-template images from a seed.
Each step prints the loss (mean over workers), the step time split into
gradients, sync and update, and the sync's wire accounting (effective bits
sent per worker and collectives: static plus what lazy groups' gates let
through); the run ends with the paper's MB/epoch (50,000 training images
per epoch, at the static figure of a round where every group fires) and
the accuracy on a fresh batch. Runs on the card unless ``--device cpu`` is
given.

The JAX launcher's compressor flags carry over: per-leaf policies
(``--policy auto|SPEC``, ``--error-budget``), schedules (``--warmup``,
``--decay``), lazy aggregation (``--lazy-thresh``, ``--max-stale``,
``--lazy-adaptive``, ``--lazy-mode``), and the server wire (``--wire
server``, ``--participation``, ``--agg``, ``--participation-seed``), with
federated label skew (``--noniid-alpha``). The planner's report is printed
when ``--policy auto`` ran it.

Under torchrun the ``--workers`` spread over the ranks (``launch/mesh.py``),
each computing its workers' gradients on their shards, with the sync's
collectives across the ranks (``core/comm.py:DistComm``; NCCL on CUDA by
default, gloo on the CPU; ``--dist-backend gloo --device cuda:0`` shares
one card, stepping eagerly):

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.launch.train_resnet --workers 4 --steps 2

Every compressor, policy, schedule, lazy group and wire runs over the
ranks as in one process. Rank 0 prints. ``--deterministic`` selects
cuDNN's deterministic algorithms, for runs compared bit for bit; ``--dump
DIR`` has each rank write ``DIR/rank<r>.pt`` (its gathered wire arrays,
every step's synced gradients, bits, effective bits and collectives,
lazy counters and times, the final parameters, the fingerprints of its
final compressor state by worker row, its kernel launch counts and its comm's collective
seconds at each step's end), which a comparison reads.
"""

from __future__ import annotations

import argparse
import math
import os

import torch
import torch.distributed as dist

from repro_torch.checkpoint.io import leaf_fingerprints
from repro_torch.core.compressors import CompressorConfig, make_compressor
from repro_torch.core.policy import format_plan_report, parse_decay_spec
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import ops
from repro_torch.launch.mesh import init_distributed, make_comm, make_mesh
from repro_torch.models.resnet import init_resnet18
from repro_torch.train.data_parallel import StepResult, mb_per_epoch, train_one
from repro_torch.train.trainer import WORKER_ROWS

__all__ = ["main"]

CIFAR_TRAIN_IMAGES = 50_000


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--compressor",
        default="lq_sgd",
        choices=("none", "powersgd", "topk", "qsgd", "lq_sgd"),
    )
    ap.add_argument("--rank", type=int, default=1)
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument(
        "--avg-mode", default="paper", choices=("paper", "dequant_then_mean")
    )
    ap.add_argument(
        "--wire-accounting",
        default="allgather_codes",
        choices=("allgather_codes", "psum_sim"),
    )
    ap.add_argument("--fuse", action="store_true", help="one collective per phase")
    ap.add_argument(
        "--policy",
        default=None,
        help="per-leaf policy: 'uniform' (default), 'auto' (the cost-model "
        "planner) or a spec 'pattern=method:knob=v,...'",
    )
    ap.add_argument(
        "--error-budget", type=float, default=0.3, help="planner: max error proxy"
    )
    ap.add_argument(
        "--warmup", type=int, default=0, help="exact f32 sync for the first W steps"
    )
    ap.add_argument(
        "--decay", default=None, help="rank/bit caps, e.g. '200:rank=1,500:bits=4'"
    )
    ap.add_argument(
        "--lazy-thresh",
        type=float,
        default=0.0,
        help="lazy aggregation: relative innovation threshold (0 = eager)",
    )
    ap.add_argument(
        "--max-stale", type=int, default=4, help="max skipped rounds in a row"
    )
    ap.add_argument(
        "--lazy-adaptive",
        type=float,
        default=0.0,
        help="adaptive LAQ: cap on the threshold scaling (0 = fixed)",
    )
    ap.add_argument(
        "--lazy-mode",
        default="elide",
        choices=("elide", "gate"),
        help="elide: a skipped round issues no kernel or gather; gate: the "
        "group runs every round and is selected on the device",
    )
    ap.add_argument("--wire", default="symmetric", choices=("symmetric", "server"))
    ap.add_argument(
        "--participation",
        type=float,
        default=1.0,
        help="server wire: each worker's per-round upload probability",
    )
    ap.add_argument(
        "--agg", default="participation", choices=("participation", "sparsity")
    )
    ap.add_argument("--participation-seed", type=int, default=0)
    ap.add_argument(
        "--noniid-alpha",
        type=float,
        default=0.0,
        help="Dirichlet label skew across workers (0 = IID)",
    )
    ap.add_argument("--workers", type=int, default=5)
    ap.add_argument("--batch", type=int, default=128, help="images per worker")
    ap.add_argument("--hw", type=int, default=32)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
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
        help="cuDNN's deterministic algorithms, for bit-for-bit comparisons",
    )
    ap.add_argument("--dump", default=None, help="write DIR/rank<r>.pt")
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = _parser().parse_args(argv)
    created = init_distributed(args.dist_backend, args.device)
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = was or args.deterministic
    try:
        return _train(args)
    finally:
        torch.backends.cudnn.deterministic = was
        if created:
            dist.destroy_process_group()


def _train(args: argparse.Namespace) -> dict:
    mesh = make_mesh((args.workers, 1), args.device)
    comm = make_comm(mesh, record=args.dump is not None)
    say = print if mesh.rank == 0 else lambda *a, **k: None
    if mesh.distributed:
        say(f"# comm: {comm!r}", flush=True)
    cfg = CompressorConfig(
        name=args.compressor,
        rank=args.rank,
        bits=args.bits,
        avg_mode=args.avg_mode,
        wire_accounting=args.wire_accounting,
        fuse_collectives=args.fuse,
        policy=args.policy,
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
    if args.policy == "auto":
        # the planner reads shapes only: plan on a meta copy of the params
        params = init_resnet18(args.classes, device="cpu")
        abstract = tree_map(lambda t: torch.empty(t.shape, device="meta"), params)
        say(format_plan_report(make_compressor(cfg, abstract).plan_report))

    synced = []  # every step's synced gradients, on the host, for --dump
    stale = []  # every step's lazy counters, on the host, for --dump

    def keep_synced(step: int, grads, state) -> None:
        synced.append([g.cpu() for g in tree_leaves(grads)])
        stale.append({m: c.cpu() for m, c in state.get("lazy_stale", {}).items()})

    collective_s = []  # the comm's collective seconds at each step's end

    def show(step: int, res: StepResult) -> None:
        collective_s.append(getattr(comm, "host_s", 0.0))
        split = (
            ""  # a graph replay has no phase boundaries to clock
            if math.isnan(res.grad_ms)
            else f" (grad {res.grad_ms:.1f} sync {res.sync_ms:.1f} update "
            f"{res.update_ms:.1f})"
        )
        say(
            f"step {step:4d}  loss {res.loss:.4f}  ms {res.step_ms:.1f}{split}  "
            f"wire {res.wire_bits:g} bits, {res.collectives:g} collectives",
            flush=True,
        )

    out = train_one(
        cfg,
        n_workers=args.workers,
        batch=args.batch,
        hw=args.hw,
        n_classes=args.classes,
        steps=args.steps,
        lr=args.lr,
        seed=args.seed,
        device=mesh.device,
        noniid_alpha=args.noniid_alpha,
        comm=comm,
        on_step=show,
        on_sync=None if args.dump is None else keep_synced,
    )
    mb = mb_per_epoch(out.comp, CIFAR_TRAIN_IMAGES, args.workers * args.batch)
    if args.dump is not None:
        os.makedirs(args.dump, exist_ok=True)
        dump = {
            "gathered": [g.cpu() for g in comm.gathered],
            "synced": synced,
            "params": [p.detach().cpu() for p in tree_leaves(out.params)],
            "losses": out.losses,
            "bits": [st.rec.bits_sent for st in out.steps],
            "collectives": [st.rec.n_collectives for st in out.steps],
            "effective": [(st.wire_bits, st.collectives) for st in out.steps],
            "stale": stale,
            "comp": leaf_fingerprints({"comp": out.comp_state}, WORKER_ROWS),
            "wire_bits_per_step": out.comp.wire_bits_per_step(),
            "step_ms": [st.step_ms for st in out.steps],
            "sync_ms": [st.sync_ms for st in out.steps],
            "collective_s": collective_s,
            "launches": ops.launch_counts(),
            "comm": repr(comm),
        }
        torch.save(dump, os.path.join(args.dump, f"rank{mesh.rank}.pt"))
    say(
        f"{args.compressor}: {out.comp.wire_bits_per_step()} wire bits/step, "
        f"{mb:.6f} MB/epoch, accuracy {out.acc:.4f}, "
        f"{out.secs_per_step * 1e3:.1f} ms/step"
    )
    return {"losses": out.losses, "mb_per_epoch": mb, "acc": out.acc}


if __name__ == "__main__":
    main()
