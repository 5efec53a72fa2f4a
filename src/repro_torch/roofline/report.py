"""The dry-run and roofline tables from the JSON records of
``repro_torch.launch.dryrun``: the port's counterpart of the JAX package's
``roofline/report.py``, with the H100 cluster's headings.

    PYTHONPATH=src python -m repro_torch.roofline.report DIR > tables.md

Every figure in the tables is a bound from data-sheet constants (NVIDIA
H100 SXM5 80GB at its 700 W limit, ``roofline/hw.py``) applied to counts
traced over fake tensors, not a measured time.
"""

from __future__ import annotations

import glob
import json
import os
import sys

from repro_torch.roofline import hw

__all__ = ["load", "dedupe", "dryrun_table", "roofline_table", "main"]

ARCH_ORDER = [
    "mamba2-370m",
    "gemma3-1b",
    "musicgen-medium",
    "mistral-nemo-12b",
    "granite-20b",
    "chameleon-34b",
    "mixtral-8x7b",
    "jamba-v0.1-52b",
    "qwen2-72b",
    "deepseek-v3-671b",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(dirpath: str) -> list[dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        try:
            with open(p) as f:
                data = json.load(f)
        except (OSError, ValueError):
            continue
        recs.extend(data if isinstance(data, list) else [data])
    return recs


def _key(r):
    return (r["arch"], r["shape"], bool(r.get("multi_pod")))


def dedupe(recs: list[dict]) -> dict:
    out = {}
    for r in recs:
        if r.get("perf_tag"):  # variants are kept apart
            continue
        out[_key(r)] = r
    return out


def fmt_bytes(n) -> str:
    if n is None:
        return "-"
    if n >= 1e12:
        return f"{n / 1e12:.2f}TB"
    if n >= 1e9:
        return f"{n / 1e9:.2f}GB"
    return f"{n / 1e6:.1f}MB"


def dryrun_table(recs: dict, multi_pod: bool) -> str:
    cap = f"{hw.HBM_BYTES / 1e9:.0f}GB"
    lines = [
        "| arch | shape | status | trace (host) | args/card | temp/card "
        f"| peak fits {cap}? | collectives (count) | wire/card NVLink + IB |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    skipped = []
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            r = recs.get((a, s, multi_pod))
            if r is None:
                lines.append(f"| {a} | {s} | MISSING | | | | | | |")
                continue
            if r["status"] == "skipped":
                skipped.append(f"{a} {s}")
                continue
            if r["status"] != "ok":
                lines.append(f"| {a} | {s} | {r['status']} | | | | | | |")
                continue
            mem = r["memory"]
            peak = mem["peak_est_bytes"]
            fits = "yes" if peak <= hw.HBM_BYTES else f"NO ({peak / 1e9:.0f}GB)"
            colls = ", ".join(
                f"{k}:{v}" for k, v in sorted(r["collective_counts"].items())
            )
            lines.append(
                f"| {a} | {s} | ok | {r['trace_s']}s "
                f"| {fmt_bytes(mem['argument_bytes'])} "
                f"| {fmt_bytes(mem['temp_bytes'])} | {fits} "
                f"| {colls or 'none'} "
                f"| {fmt_bytes(r['model_axis_wire_bytes'])} + "
                f"{fmt_bytes(r['data_axis_wire_bytes'])} |"
            )
    if skipped:
        lines.append(f"\nSkipped (full attention): {', '.join(skipped)}.")
    return "\n".join(lines)


def roofline_table(recs: dict) -> str:
    lines = [
        "| arch | shape | compute (ms) | memory (ms) | collective (ms) NVLink "
        "+ IB | dominant | MODEL_FLOPS | useful ratio | counted / analytic |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            r = recs.get((a, s, False))
            if r is None or r["status"] != "ok":
                continue
            mf = r["model_flops"]
            ratio = mf / (r["flops_per_device"] * r["chips"])
            vs = r["flops_per_device"] / r["analytic_flops_per_device"]
            lines.append(
                f"| {a} | {s} | {r['compute_s'] * 1e3:.2f} "
                f"| {r['memory_s'] * 1e3:.2f} "
                f"| {r['model_collective_s'] * 1e3:.2f} + "
                f"{r['data_collective_s'] * 1e3:.2f} "
                f"| **{r['dominant']}** | {mf:.2e} | {ratio:.2f} | {vs:.2f} |"
            )
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    d = argv[0] if argv else "experiments/dryrun"
    recs = dedupe(load(d))
    n_ok = sum(1 for r in recs.values() if r["status"] == "ok")
    n_skip = sum(1 for r in recs.values() if r["status"] == "skipped")
    print(
        f"<!-- generated by repro_torch.roofline.report: {n_ok} ok, "
        f"{n_skip} skipped -->\n"
    )
    print(
        f"### Dry run: one scalable unit (32 x 8 = {hw.GPUS_PER_SU} H100s)\n\n"
        + dryrun_table(recs, False)
    )
    print(
        f"\n### Dry run: two units (64 x 8 = {2 * hw.GPUS_PER_SU} H100s)\n\n"
        + dryrun_table(recs, True)
    )
    print(
        "\n### Roofline (one unit; H100 SXM5 data sheet at 700 W: "
        f"{hw.PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s bf16, "
        f"{hw.HBM_BW / 1e12:.2f} TB/s HBM, NVLink {hw.NVLINK_BW / 1e9:.0f} GB/s "
        f"and InfiniBand {hw.IB_BW / 1e9:.0f} GB/s a card one way; bounds, not "
        "measured times)\n\n" + roofline_table(recs)
    )


if __name__ == "__main__":
    main()
