"""The auto-planner's plans under the H100's cost constants and the TPU's.

    PYTHONPATH=src python tools/plan_h100_vs_tpu.py [--budgets 0.25 0.075]

The port's ``CostModel`` defaults to one H100 SXM
(``repro_torch/roofline/hw.py``); the JAX package's to a TPU v5e
(``repro/roofline/hw.py``). For the mini-CNN of the JAX package's
``policy_sweep`` and for ResNet-18 (10 classes), this prints each plan's
per-method counts and wire bits a step under both, the leaves whose policy
differs, and the JAX package's own plan beside the port's with the TPU
constants injected (they must agree). Runs on the CPU: the planner reads
shapes only.
"""

import argparse
import collections

import jax
import jax.numpy as jnp
import torch

from repro.core import CompressorConfig as JaxConfig
from repro.core.policy import plan_auto as jax_plan_auto
from repro.models.resnet import init_resnet18 as jax_init_resnet18
from repro.roofline import hw as tpu_hw
from repro_torch.core.composite import CompositeCompressor
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.policy import CostModel, plan_auto
from repro_torch.core.tree import flatten_with_paths, tree_map
from repro_torch.models.resnet import init_resnet18
from repro_torch.roofline import hw as h100_hw

CNN_SHAPES = {
    "c1": (3, 3, 3, 16),
    "c2": (3, 3, 16, 32),
    "c3": (3, 3, 32, 64),
    "w": (64, 10),
    "b": (10,),
}


def _models():
    resnet = init_resnet18(10, device="cpu")
    yield (
        "mini-CNN",
        {k: torch.empty(s, device="meta") for k, s in CNN_SHAPES.items()},
        {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in CNN_SHAPES.items()},
    )
    yield (
        "ResNet-18",
        tree_map(lambda t: torch.empty(t.shape, device="meta"), resnet),
        jax.eval_shape(lambda: jax_init_resnet18(jax.random.PRNGKey(0), 10)),
    )


def _knobs(p):
    if p.method == "lq_sgd":
        return f"lq_sgd r{p.rank} b{p.bits}"
    if p.method == "topk":
        return f"topk {p.topk_ratio}"
    if p.method == "qsgd":
        return f"qsgd b{p.bits}"
    return p.method if p.method == "raw" else f"{p.method} r{p.rank}"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--budgets", type=float, nargs="+", default=[0.25, 0.075])
    args = ap.parse_args()
    costs = {
        "H100": CostModel(),
        "TPU v5e": CostModel(
            link_bw=tpu_hw.ICI_LINK_BW, peak_flops=tpu_hw.PEAK_FLOPS_BF16
        ),
    }
    print(
        f"H100: {h100_hw.NVLINK_LINK_BW:.3g} B/s a link, "
        f"{h100_hw.PEAK_FLOPS_BF16:.3g} FLOP/s; TPU v5e: "
        f"{tpu_hw.ICI_LINK_BW:.3g} B/s a link, {tpu_hw.PEAK_FLOPS_BF16:.3g} FLOP/s"
    )
    for (name, abstract, jax_abstract), budget in (
        (m, b) for m in _models() for b in args.budgets
    ):
        cfg = CompressorConfig(name="lq_sgd", policy="auto", error_budget=budget)
        plans = {}
        for hw_name, cm in costs.items():
            pols, _ = plan_auto(abstract, cfg=cfg, cost_model=cm)
            comp = CompositeCompressor(cfg, abstract, policies=pols)
            plans[hw_name] = pols
            kinds = collections.Counter(_knobs(p) for p in pols)
            print(
                f"{name}, budget {budget}, {hw_name}: "
                f"{comp.wire_bits_per_step()} wire bits/step, "
                f"by method {comp.wire_bits_by_method()}, leaves {dict(kinds)}"
            )
        jpols, _ = jax_plan_auto(
            jax_abstract, cfg=JaxConfig(name="lq_sgd", error_budget=budget)
        )
        same = [_knobs(p) for p in jpols] == [_knobs(p) for p in plans["TPU v5e"]]
        print(f"  the JAX package's plan = the port's with TPU constants: {same}")
        paths = [path for path, _ in flatten_with_paths(abstract)]
        for path, a, b in zip(paths, plans["H100"], plans["TPU v5e"]):
            if a != b:
                print(f"  {path}: H100 {_knobs(a)}, TPU v5e {_knobs(b)}")

if __name__ == "__main__":
    main()
