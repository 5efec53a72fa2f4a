"""Paper Fig. 5 + the steady-state extension, on the port: SSIM/PSNR of
gradient-inversion reconstructions against compression, at both attack
points.

    python -m repro_torch.bench.gia_ssim [--quick] [--model cnn|resnet18]
        [--device cpu] [--json PATH]

SGD (uncompressed) should leak the most (the highest SSIM); the compressed
methods less. The trajectory harness (:mod:`repro_torch.core.privacy.harness`)
threads the real compressor state through the victim's training, so each
method is attacked at the cold start (step 0: zero error feedback, random
warm Q) and at the steady state (after warm-up, the quantity the paper's
claim is about). ``--model cnn`` is the JAX benchmark's setup: its 2-conv
victim net at 16x16x3, a smooth sin·cos target, label 3, all 8 methods.
``--model resnet18`` runs the same harness on ResNet-18 at full width
(11,173,962 parameters, seeded init) with one 32x32x3 target, for
``sgd``, ``lq_sgd_r1`` and ``lq_sgd_r1_b4``. Every victim step and attack
runs in f32 with TF32 off, with cuDNN deterministic. It runs on the card
unless ``--device cpu`` is given; where there is no CUDA it raises.

Each result row has the fields of ``BENCH_privacy.json``'s ``results``
rows; ``--json PATH`` writes them. The JAX benchmark's privacy Pareto
sweep (``dlog`` / ``lrq`` against post-hoc noise) is not ported: it needs
the randomized codecs.
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.privacy import GIAConfig, HarnessConfig, sweep_methods
from repro_torch.models.common import resolve_device
from repro_torch.models.resnet import conv_same, init_resnet18, resnet18_forward

__all__ = [
    "METHODS",
    "RESNET_METHODS",
    "harness_config",
    "setup",
    "bench",
    "main",
]

# methods x {rank, bits, topk_ratio}; None = uncompressed SGD
METHODS: dict[str, CompressorConfig | None] = {
    "sgd": None,
    "powersgd_r4": CompressorConfig(name="powersgd", rank=4),
    "powersgd_r1": CompressorConfig(name="powersgd", rank=1),
    "topk": CompressorConfig(name="topk", topk_ratio=0.01),
    "qsgd_b8": CompressorConfig(name="qsgd", bits=8),
    "lq_sgd_r4": CompressorConfig(name="lq_sgd", rank=4, bits=8),
    "lq_sgd_r1": CompressorConfig(name="lq_sgd", rank=1, bits=8),
    "lq_sgd_r1_b4": CompressorConfig(name="lq_sgd", rank=1, bits=4),
}
RESNET_METHODS = ("sgd", "lq_sgd_r1", "lq_sgd_r1_b4")
LABEL = 3


def _init_net(seed: int = 0, device="cuda") -> dict[str, torch.Tensor]:
    """The victim net's params, N(0, 0.1²) from a seeded generator (the
    JAX benchmark's distribution; its own draw carries over through
    ``weights.resnet_params_from_jax``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev) * 0.1

    return {
        "c1": r(3, 3, 3, 8),
        "c2": r(3, 3, 8, 16),
        "w": r(16, 10),
        "b": torch.zeros(10, device=dev),
    }


def _net(p, x):
    """Two stride-2 3x3 SAME convs with ReLU, a spatial mean, a linear head."""
    h = F.relu(conv_same(x.permute(0, 3, 1, 2), p["c1"], 2))
    h = F.relu(conv_same(h, p["c2"], 2))
    return h.mean(dim=(2, 3)) @ p["w"] + p["b"]


def _nll(logits, y):
    return torch.mean(-F.log_softmax(logits, dim=-1).gather(1, y[:, None]))


def _loss_fn(p, x, y):
    return _nll(_net(p, x), y)


def _resnet_loss_fn(p, x, y):
    return _nll(resnet18_forward(p, x), y)


# module-level, so one function serves every (method, step) cell
_grad_fn = torch.func.grad(_loss_fn)
_resnet_grad_fn = torch.func.grad(_resnet_loss_fn)


def _target_image(hw: int = 16, device="cuda") -> torch.Tensor:
    """A smooth (1, hw, hw, 3) image: sin(u) cos(v) over [0, 3π]²."""
    xs = torch.linspace(0, 3 * math.pi, hw, device=resolve_device(device))
    img = torch.sin(xs)[None, :, None, None] * torch.cos(xs)[None, None, :, None]
    return img * torch.ones((1, hw, hw, 3), device=xs.device)


def harness_config(quick: bool = False) -> HarnessConfig:
    # best-of-8 restarts: single-restart inversion is bimodal in its init
    # (contrast-inverted basins score negative SSIM), and the max over a
    # small N is a noisy order statistic that can swamp the method effect
    return HarnessConfig(
        train_steps=6 if quick else 10,
        attack_steps=(0, 5) if quick else (0, 9),
        n_attack_seeds=8,
        victim_lr=0.02,
        gia=GIAConfig(steps=240 if quick else 300, lr=0.05, tv_coef=5e-3),
    )


def setup(model: str = "cnn", device="cuda") -> dict[str, Any]:
    """The victim of ``model``: its params, grad and loss functions, target
    image, label and the methods it is attacked under."""
    dev = resolve_device(device)
    y = torch.tensor([LABEL], device=dev)
    if model == "cnn":
        return dict(
            params=_init_net(0, dev),
            grad_fn=_grad_fn,
            loss_fn=_loss_fn,
            x=_target_image(16, dev),
            y=y,
            methods=dict(METHODS),
        )
    if model == "resnet18":
        return dict(
            params=init_resnet18(10, seed=0, device=dev),
            grad_fn=_resnet_grad_fn,
            loss_fn=_resnet_loss_fn,
            x=_target_image(32, dev),
            y=y,
            methods={name: METHODS[name] for name in RESNET_METHODS},
        )
    raise ValueError(f"unknown model {model!r}; options: 'cnn', 'resnet18'")


def bench(
    quick: bool = False,
    model: str = "cnn",
    device="cuda",
    *,
    cfg: HarnessConfig | None = None,
    victim: dict[str, Any] | None = None,
) -> tuple[list[dict[str, Any]], dict[str, Any]]:
    """Sweep ``model``'s methods under ``cfg`` (by default
    :func:`harness_config`). ``victim`` (by default ``setup(model,
    device)``) may be a :func:`setup` dict with its entries changed, e.g.
    methods wrapped as :func:`~repro_torch.core.privacy.harness.sweep_methods`
    takes them. Returns the result rows and the JSON payload."""
    cfg = cfg if cfg is not None else harness_config(quick)
    victim = victim if victim is not None else setup(model, device)
    points = sweep_methods(
        victim["methods"],
        victim["grad_fn"],
        victim["params"],
        victim["x"],
        victim["y"],
        cfg,
    )
    rows = [
        {
            "method": p.method,
            "step": p.step,
            "phase": p.phase,
            "ssim": p.ssim,
            "psnr": p.psnr,
            "attack_loss": p.attack_loss,
            "attack_seconds": p.attack_seconds,
            "state_threaded": p.state_threaded,
            "seed_ssims": list(p.seed_ssims),
        }
        for p in points
    ]
    payload = {
        "bench": "privacy",
        "schema": 2,
        "quick": quick,
        "model": model,
        "attack_steps": {
            "cold_start": 0,
            "steady_state": max(cfg.attack_steps, default=0),
        },
        "train_steps": cfg.train_steps,
        "n_attack_seeds": cfg.n_attack_seeds,
        "gia_steps": cfg.gia.steps,
        "victim_lr": cfg.victim_lr,
        "results": rows,
    }
    return rows, payload


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="6 victim steps, 240 attack")
    ap.add_argument("--model", default="cnn", choices=("cnn", "resnet18"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None, metavar="PATH", help="write the rows")
    return ap


def main(argv: list[str] | None = None) -> list[dict[str, Any]]:
    args = _parser().parse_args(argv)
    # the same answer on every run: cuDNN picks deterministic algorithms
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    rows, payload = bench(args.quick, args.model, args.device)
    for r in rows:
        print(
            f"gia_ssim/{r['method']}/{r['phase']},{r['attack_seconds'] * 1e6:.0f},"
            f"ssim={r['ssim']:.4f} psnr={r['psnr']:.2f} step={r['step']} "
            f"threaded={r['state_threaded']}"
        )
    if args.json:
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
