"""Does (k2)'s unbiasedness check depend on how its 64 encodes are seeded?

    python tools/codec_seed_probe.py [--device cpu|cuda] [--n N]

``chip_smoke.py``'s (k2) holds the mean of 64 encodes of one x against x:
the elements sorted by x into 16 bins, each bin's summed deviation over its
standard error from the draws' own variance (``_codec_statistics``). This
probe computes that statistic, unchanged, for the three randomized specs of
(k2) under three ways of drawing the 64 encodes:

* ``seeds``: one generator per encode, seeded 0, 1, ..., 63;
* ``leaf``: one generator per encode, the sync's own
  ``leaf_generator(11, step, 0, stream=PHASE_STREAMS["p"])`` for steps
  0 .. 63, as ``chip_smoke.py`` draws them;
* ``one``: one generator seeded 7 draws a (64, n) tensor, as the CPU test
  ``tests/test_torch_privacy_codecs.py:_mean_expand`` does.

It prints one line per (condition, spec) with the largest bin |z|, and one
JSON line of them all. (k2)'s bound is 5.0. n defaults to 262,144, the
largest LQ-SGD r1 factor of gemma3-1b, one of (k2)'s two sizes.
"""

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

DRAWS, BINS = 64, 16
SPECS = ("dlog:bits=8", "dlog:bits=4", "lrq:bits=4,n_layers=2")


def _expands(codec, x, how):
    """The (DRAWS, n) expands of ``DRAWS`` encodes of ``x``, seeded ``how``."""
    from repro_torch.core.compressors import PHASE_STREAMS, leaf_generator

    dev = x.device
    if how == "one":
        gen = torch.Generator(device=dev).manual_seed(7)
        return codec.expand(codec.codes(x.expand(DRAWS, -1), key=gen).float())
    rows = []
    for d in range(DRAWS):
        if how == "seeds":
            gen = torch.Generator(device=dev).manual_seed(d)
        else:
            gen = leaf_generator(11, d, 0, dev, stream=PHASE_STREAMS["p"])
        rows.append(codec.expand(codec.codes(x, key=gen).float()))
    return torch.stack(rows)


def max_bin_z(v, x):
    """(k2)'s statistic: the largest |z| of the bins' summed deviations."""
    v = v.double()
    mean = v.mean(0)
    var = v.var(0)  # each element's draws, over DRAWS - 1
    order = torch.argsort(x)
    dev, se2 = (mean - x.double())[order], (var / DRAWS)[order]
    z = [
        float(d.sum() / max(float(e.sum()), 1e-300) ** 0.5)
        for d, e in zip(dev.chunk(BINS), se2.chunk(BINS))
    ]
    return max(abs(t) for t in z)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--n", type=int, default=262_144)
    args = ap.parse_args()
    from repro_torch.core.codec import make_codec

    gen = torch.Generator(device=args.device).manual_seed(2)
    x = torch.randn(args.n, generator=gen, device=args.device)
    x = x / x.abs().max()
    out = {}
    for how in ("seeds", "leaf", "one"):
        for spec in SPECS:
            z = max_bin_z(_expands(make_codec(spec), x, how), x)
            out[f"{how}/{spec}"] = z
            print(f"{how:6s} {spec:24s} max bin |z| {z:.3f}", flush=True)
    print(json.dumps({"device": args.device, "n": args.n, "max_bin_z": out}))


if __name__ == "__main__":
    main()
