"""How often SGD leaks at least as much as LQ-SGD r1 at the GIA sweep's
steady state, over the harness's seeds, on one device.

    python tools/gia_ordering.py [--device cuda] [--seeds 16] [--model cnn]

For each harness seed s in 0..seeds-1 (``HarnessConfig.seed``: the attack
restarts' generators and the compressor's initial state; the victim's init
and target are the benchmark's), runs ``bench/gia_ssim.py``'s harness at
its full schedule with the attack at the steady-state step only, for
``sgd`` and ``lq_sgd_r1``, and prints per seed each method's best-of-N
SSIM and its mean over the N restarts. The last line is one JSON object
with every seed's numbers and the share of seeds where SGD's SSIM is at
least LQ-SGD r1's, by the best of N (the benchmark's statistic) and by
the mean.
"""

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.bench import gia_ssim  # noqa: E402

METHODS = ("sgd", "lq_sgd_r1")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--model", default="cnn", choices=("cnn", "resnet18"))
    args = ap.parse_args(argv)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    base = gia_ssim.harness_config(quick=False)
    steady = max(base.attack_steps)
    per_seed = []
    t0 = time.perf_counter()
    for seed in range(args.seeds):
        cfg = dataclasses.replace(base, seed=seed, attack_steps=(steady,))
        victim = gia_ssim.setup(args.model, args.device)
        victim["methods"] = {m: victim["methods"][m] for m in METHODS}
        rows, _ = gia_ssim.bench(model=args.model, cfg=cfg, victim=victim)
        by = {r["method"]: r for r in rows}
        entry = {"seed": seed}
        for m in METHODS:
            entry[m] = {
                "best": by[m]["ssim"],
                "mean": statistics.fmean(by[m]["seed_ssims"]),
            }
        per_seed.append(entry)
        print(
            f"seed {seed}: best sgd {entry['sgd']['best']:.4f} lq_sgd_r1 "
            f"{entry['lq_sgd_r1']['best']:.4f}; mean sgd {entry['sgd']['mean']:.4f} "
            f"lq_sgd_r1 {entry['lq_sgd_r1']['mean']:.4f}",
            flush=True,
        )

    def share(stat):
        wins = [e["sgd"][stat] >= e["lq_sgd_r1"][stat] for e in per_seed]
        return sum(wins) / len(wins)

    card = torch.cuda.get_device_name(0) if args.device == "cuda" else args.device
    print(
        json.dumps(
            {
                "device": card,
                "model": args.model,
                "seconds": time.perf_counter() - t0,
                "share_sgd_ge_lq_best": share("best"),
                "share_sgd_ge_lq_mean": share("mean"),
                "seeds": per_seed,
            }
        )
    )


if __name__ == "__main__":
    main()
