"""The paper's experiment: ResNet-18 trained data-parallel over N workers
with a compressed gradient sync (the port's counterpart of
``examples/resnet_cifar_compression.py``).

    PYTHONPATH=src python -m repro_torch.launch.train_resnet \\
        --compressor lq_sgd --rank 1 --bits 8 --steps 20

The defaults are the paper's layout: 5 workers x 128 images, CIFAR-10
shape (32x32x3, 10 classes), synthetic class-template images from a seed.
Each step prints the loss (mean over workers), the step time split into
gradients, sync and update, and the sync's wire accounting (bits sent per
worker, collectives); the run ends with the paper's MB/epoch (50,000
training images per epoch) and the accuracy on a fresh batch. Runs on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

from repro_torch.core.compressors import CompressorConfig
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
    )

    def show(step: int, res: StepResult) -> None:
        print(
            f"step {step:4d}  loss {res.loss:.4f}  ms grad {res.grad_ms:.1f} "
            f"sync {res.sync_ms:.1f} update {res.update_ms:.1f}  "
            f"wire {res.rec.bits_sent} bits, {res.rec.n_collectives} collectives",
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
