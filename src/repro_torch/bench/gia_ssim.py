"""Paper Fig. 5 + the steady-state extension, on the port: SSIM/PSNR of
gradient-inversion reconstructions against compression, at both attack
points.

    python -m repro_torch.bench.gia_ssim [--quick] [--model cnn|resnet18]
        [--pareto] [--device cpu] [--json PATH]

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
rows; ``--json PATH`` writes them.

``--pareto`` (on the 2-conv victim) adds the JAX benchmark's privacy Pareto
sweep: the randomized codecs in the wire (``dlog`` at two per-use budgets,
``lrq``) against the strawman of the deterministic wire plus post-hoc
Gaussian noise at the same per-step epsilon. The strawman's payload (codes
plus continuous noise) does not fit the b-bit codebook, so its honest wire
is f32. :func:`_pareto_gate` passes when each dlog row ships fewer bits
than its post-hoc row, leaks no more (mean attack SSIM over restarts,
within ``DOMINANCE_SSIM_TOL``) and trains no worse (final loss, within
``DOMINANCE_LOSS_TOL``); every row but the deterministic one carries its
epsilon. ``--json`` then writes a ``pareto`` section with
``BENCH_privacy.json``'s fields.
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.compressors import CompressorConfig, make_compressor
from repro_torch.core.privacy import (
    GIAConfig,
    HarnessConfig,
    PostHocNoiseCompressor,
    gaussian_sigma,
    sweep_methods,
)
from repro_torch.models.common import resolve_device
from repro_torch.models.resnet import conv_same, init_resnet18, resnet18_forward

__all__ = [
    "METHODS",
    "RESNET_METHODS",
    "PARETO_DELTA",
    "PARETO_EPS",
    "DOMINANCE_SSIM_TOL",
    "DOMINANCE_LOSS_TOL",
    "harness_config",
    "pareto_harness_config",
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


# ---- privacy Pareto: randomized codecs against post-hoc noise ------------
# Leakage compares the MEAN attack SSIM over restarts: the best-of-N order
# statistic is too noisy to difference two methods. The mean is bimodal too
# (contrast-inverted basins score negative SSIM), so its tolerance is a
# backstop against catastrophic leakage; wire bits and epsilons are exact.
PARETO_DELTA = 1e-5
PARETO_EPS = (16.0, 48.0)  # per-use dlog budgets (strong / mild noise)
DOMINANCE_SSIM_TOL = 0.12  # randomized may not leak more than posthoc + tol
DOMINANCE_LOSS_TOL = 0.10  # ... nor train >10% worse (relative, + 0.02 abs)


def _pareto_base() -> CompressorConfig:
    return CompressorConfig(name="lq_sgd", rank=1, bits=4)


def pareto_harness_config(quick: bool = False) -> HarnessConfig:
    # the steady state only: the claim is about training-time traffic
    last = 5 if quick else 9
    return HarnessConfig(
        train_steps=6 if quick else 10,
        attack_steps=(last,),
        n_attack_seeds=8,
        victim_lr=0.02,
        gia=GIAConfig(steps=240 if quick else 300, lr=0.05, tv_coef=5e-3),
    )


def _pareto_methods(abstract) -> tuple[dict[str, Any], dict[str, dict]]:
    """(sweep entries, per-method metadata). Each post-hoc row matches a dlog
    row's PER-STEP epsilon: its Gaussian noise on the same deterministic
    reconstruction is calibrated so both spend the same budget."""
    base = _pareto_base()
    n_leaves = len(make_compressor(base, abstract).plans)
    methods: dict[str, Any] = {"lq_det": base}
    meta: dict[str, dict] = {
        "lq_det": {
            "codec": "log",
            "epsilon": None,
            "epsilon_kind": None,
            "matched_to": None,
        }
    }
    for eps in PARETO_EPS:
        name = f"lq_dlog_eps{eps:g}"
        cc = CompressorConfig(
            name="lq_sgd", rank=1, bits=4, dp_epsilon=eps, dp_delta=PARETO_DELTA
        )
        eps_step = make_compressor(cc, abstract).privacy_epsilon_per_step(
            PARETO_DELTA
        )
        methods[name] = cc
        meta[name] = {
            "codec": "dlog",
            "epsilon": eps_step,
            "epsilon_kind": "calibrated",
            "matched_to": None,
        }
        # the matched strawman: the same wire, the same per-step epsilon
        sigma = gaussian_sigma(eps_step / n_leaves, PARETO_DELTA)
        pname = f"posthoc_eps{eps:g}"
        methods[pname] = lambda a, s=sigma: PostHocNoiseCompressor(
            make_compressor(base, a), s
        )
        meta[pname] = {
            "codec": "log+posthoc",
            "epsilon": eps_step,
            "epsilon_kind": "calibrated",
            "matched_to": name,
            "sigma_norm": sigma,
        }
    lrq = CompressorConfig(name="lq_sgd", rank=1, bits=4, codec="lrq", lrq_layers=2)
    methods["lq_lrq"] = lrq
    meta["lq_lrq"] = {
        "codec": "lrq",
        "epsilon": make_compressor(lrq, abstract).privacy_epsilon_per_step(
            PARETO_DELTA
        ),
        "epsilon_kind": "gaussian_equiv",
        "matched_to": None,
    }
    return methods, meta


def _pareto_gate(rows: list[dict[str, Any]]) -> dict[str, Any]:
    """Each dlog row must dominate its matched post-hoc row: strictly fewer
    wire bits at the same per-step epsilon, a mean attack SSIM no higher
    and a final loss no worse, within the tolerances. Every row but the
    deterministic one must carry its epsilon."""
    by_m = {r["method"]: r for r in rows}
    checks, passed = [], True
    missing_eps = [
        r["method"] for r in rows if r["codec"] != "log" and r.get("epsilon") is None
    ]
    if missing_eps:
        passed = False
    for r in rows:
        m = r.get("matched_to")
        if not m:
            continue
        d = by_m[m]  # the randomized row this post-hoc row is matched to
        wire_ok = d["wire_bits"] < r["wire_bits"]
        ssim_ok = d["ssim_mean"] <= r["ssim_mean"] + DOMINANCE_SSIM_TOL
        loss_ok = d["final_loss"] <= r["final_loss"] * (1 + DOMINANCE_LOSS_TOL) + 0.02
        checks.append(
            {
                "randomized": m,
                "posthoc": r["method"],
                "epsilon": r["epsilon"],
                "wire_randomized": d["wire_bits"],
                "wire_posthoc": r["wire_bits"],
                "ssim_randomized": d["ssim_mean"],
                "ssim_posthoc": r["ssim_mean"],
                "loss_randomized": d["final_loss"],
                "loss_posthoc": r["final_loss"],
                "wire_ok": wire_ok,
                "ssim_ok": ssim_ok,
                "loss_ok": loss_ok,
            }
        )
        passed = passed and wire_ok and ssim_ok and loss_ok
    return {
        "passed": passed,
        "ssim_tol": DOMINANCE_SSIM_TOL,
        "loss_tol": DOMINANCE_LOSS_TOL,
        "missing_epsilon": missing_eps,
        "checks": checks,
    }


def _pareto_bench(
    quick: bool = False,
    device="cuda",
    *,
    cfg: HarnessConfig | None = None,
) -> dict[str, Any]:
    """The Pareto sweep on the 2-conv victim under ``cfg`` (by default
    :func:`pareto_harness_config`): ``BENCH_privacy.json``'s ``pareto``
    section, its rows, wire bits and gate."""
    cfg = cfg if cfg is not None else pareto_harness_config(quick)
    victim = setup("cnn", device)
    params = victim["params"]
    abstract = {k: torch.empty(p.shape, device="meta") for k, p in params.items()}
    methods, meta = _pareto_methods(abstract)
    wire_bits = make_compressor(_pareto_base(), abstract).wire_bits_per_step()
    # the post-hoc payload is not in the codebook: its honest wire is f32
    raw_bits = sum(p.numel() for p in params.values()) * 32
    points = sweep_methods(
        methods,
        victim["grad_fn"],
        params,
        victim["x"],
        victim["y"],
        cfg,
        loss_fn=victim["loss_fn"],
    )
    rows = []
    for p in points:
        md = meta[p.method]
        eps = md["epsilon"]
        rows.append(
            {
                "method": p.method,
                "codec": md["codec"],
                "epsilon": None if eps is None or math.isinf(eps) else eps,
                "epsilon_kind": md["epsilon_kind"],
                "matched_to": md["matched_to"],
                "wire_bits": int(raw_bits if md["matched_to"] else wire_bits),
                "ssim": p.ssim,
                "psnr": p.psnr,
                "ssim_mean": sum(p.seed_ssims) / len(p.seed_ssims),
                "final_loss": p.final_loss,
                "attack_seconds": p.attack_seconds,
            }
        )
    return {
        "delta": PARETO_DELTA,
        "wire_bits": wire_bits,
        "rows": rows,
        "gate": _pareto_gate(rows),
    }


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="6 victim steps, 240 attack")
    ap.add_argument("--model", default="cnn", choices=("cnn", "resnet18"))
    ap.add_argument(
        "--pareto", action="store_true", help="the dlog / lrq Pareto sweep too (cnn)"
    )
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None, metavar="PATH", help="write the rows")
    return ap


def main(argv: list[str] | None = None) -> list[dict[str, Any]]:
    args = _parser().parse_args(argv)
    # the same answer on every run: cuDNN picks deterministic algorithms
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    if args.pareto and args.model != "cnn":
        raise ValueError("--pareto runs on the JAX benchmark's victim: --model cnn")
    rows, payload = bench(args.quick, args.model, args.device)
    for r in rows:
        print(
            f"gia_ssim/{r['method']}/{r['phase']},{r['attack_seconds'] * 1e6:.0f},"
            f"ssim={r['ssim']:.4f} psnr={r['psnr']:.2f} step={r['step']} "
            f"threaded={r['state_threaded']}"
        )
    if args.pareto:
        payload["pareto"] = pareto = _pareto_bench(args.quick, args.device)
        for r in pareto["rows"]:
            eps = "inf" if r["epsilon"] is None else f"{r['epsilon']:.1f}"
            print(
                f"gia_ssim/pareto/{r['method']},{r['attack_seconds'] * 1e6:.0f},"
                f"ssim={r['ssim']:.4f} loss={r['final_loss']:.4f} eps={eps} "
                f"wire_bits={r['wire_bits']}"
            )
        gate = pareto["gate"]
        n_pairs = len(gate["checks"])
        print(f"gia_ssim/pareto/gate,0,passed={gate['passed']} pairs={n_pairs}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
