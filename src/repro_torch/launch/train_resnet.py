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
"""

from __future__ import annotations

import argparse
import math

import torch

from repro_torch.core.compressors import CompressorConfig, make_compressor
from repro_torch.core.policy import format_plan_report, parse_decay_spec
from repro_torch.core.tree import tree_map
from repro_torch.models.resnet import init_resnet18
from repro_torch.train.data_parallel import StepResult, mb_per_epoch, train_one

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
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = _parser().parse_args(argv)
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
        print(format_plan_report(make_compressor(cfg, abstract).plan_report))

    def show(step: int, res: StepResult) -> None:
        split = (
            ""  # a graph replay has no phase boundaries to clock
            if math.isnan(res.grad_ms)
            else f" (grad {res.grad_ms:.1f} sync {res.sync_ms:.1f} update "
            f"{res.update_ms:.1f})"
        )
        print(
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
        device=args.device,
        noniid_alpha=args.noniid_alpha,
        on_step=show,
    )
    mb = mb_per_epoch(out.comp, CIFAR_TRAIN_IMAGES, args.workers * args.batch)
    print(
        f"{args.compressor}: {out.comp.wire_bits_per_step()} wire bits/step, "
        f"{mb:.6f} MB/epoch, accuracy {out.acc:.4f}, "
        f"{out.secs_per_step * 1e3:.1f} ms/step"
    )
    return {"losses": out.losses, "mb_per_epoch": mb, "acc": out.acc}


if __name__ == "__main__":
    main()
