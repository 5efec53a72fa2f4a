"""Device time of gemma3-1b's serving steps on one GPU, for one source tree.

    python tools/gemma_step_times.py <tree root> <label>

Loads ``repro_torch`` from ``<tree root>/src`` (this checkout's root, or a
``git archive`` of another commit unpacked under ``build/``), builds
gemma3-1b at full width and depth with seeded random weights and, for a q8
and a q4 cache, times the prefill of 4 x 1024 tokens and one decode step at
position 1024: five CUDA-graph replays of each (``chip_smoke.cuda_ms``) and
torch.profiler's device time by kernel group (``chip_smoke.kernel_groups``:
flash attention, the row dequant, cuBLAS matmuls, other). Prints one JSON
line. To compare two trees, run it in one call on one card, in turns:
parent, change, change, parent.
"""

import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the timing helpers of this checkout)

REPLAYS = 5


def main(root, label):
    root = Path(root).resolve()
    sys.path.insert(0, str(root / "src"))
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import (
        build_decode_step,
        build_prefill_step,
        greedy_sample,
    )
    from repro_torch.serving.kv_cache import CacheQuantConfig

    if not Path(repro_torch.__file__).is_relative_to(root):
        raise SystemExit(f"repro_torch came from {repro_torch.__file__}, not {root}")
    if not torch.cuda.is_available():
        raise SystemExit("gemma_step_times: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("gemma3-1b")
    params = init_params(cfg, 1, "cuda")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 1024))).cuda()
    result = {"tree": label, "card": torch.cuda.get_device_name(0)}
    for bits in (8, 4):
        prefill = build_prefill_step(cfg, 1056, qcfg=CacheQuantConfig(bits=bits))
        decode = build_decode_step(cfg)
        logits, caches = prefill(params, tokens)
        last = greedy_sample(logits)
        steps = {
            "prefill": lambda: prefill(params, tokens),
            "decode_step": lambda: decode(params, caches, last, 1024),
        }
        for step, fn in steps.items():
            replays = [chip_smoke.cuda_ms(fn, 1) for _ in range(REPLAYS)]
            by_name = chip_smoke.device_ms_by_kernel(fn)
            groups = chip_smoke.kernel_groups(by_name, chip_smoke.GEMMA_KERNELS)
            result[f"{step}_q{bits}"] = {
                "graph_ms": replays,
                "median_ms": statistics.median(replays),
                "device_ms": sum(groups.values()),
                "groups_ms": groups,
                "kernels": sum(c for _, c in by_name.values()),
            }
        del logits, caches
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:3])
