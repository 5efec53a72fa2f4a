"""Write a copy of ``chip_smoke.py`` that runs some of its tensor-parallel
phases alone: the device and build phases, then ``phase_tp`` with the shared
torchruns cut to the runs of the phases named (their kernels' checks
first, as in the whole script).

    python tools/chip_smoke_alone.py s      # writes build/chip_smoke_s.py
    python build/chip_smoke_s.py            # on a machine with the cards

The copy lies under ``build/`` (ignored by git), its ranks run the copy
itself, and it ends by printing the launches and seconds of ``phase_tp``.
Phases: ``o``, ``n`` (n2, n3), ``p``, ``q``, ``r``, ``s``, ``t`` (no
kernel checks of its own: its factors are (q1)'s).
"""

import argparse
import ast
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# phase_tp's loop over the phases' kernel checks, and each one's seed
KERNELS = (
    '("p", _p_kernels, 15), ("q", _q_kernels, 16),\n'
    '                                 ("r", _r_kernels, 17), ("s", _s_kernels, 18)'
)
SEEDS = {"p": 15, "q": 16, "r": 17, "s": 18}
MAIN = """    else:
        t0 = time.perf_counter()
        card = phase_device()
        phase_build()
        print(phase_tp(card))
        print(f"alone: {time.perf_counter() - t0:.1f} s")"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phases", help="letters of the phases to keep: 's', 'qs', ...")
    phases = ap.parse_args().phases
    src = (ROOT / "chip_smoke.py").read_text()
    spawns = re.search(r"TP_SPAWNS = (\{.*?\n\})", src, flags=re.S)
    runs = ast.literal_eval(spawns.group(1))
    kept = {m: tuple(r for r in rs if r[0] in phases) for m, rs in runs.items()}
    kept = {m: rs for m, rs in kept.items() if rs}
    kernels = "".join(
        f'("{p}", _{p}_kernels, {seed}), ' for p, seed in SEEDS.items() if p in phases
    )
    here = 'str(Path(__file__).resolve()), "--tp-spawn-rank"'
    for old, new in (
        ("ROOT = Path(__file__).resolve().parent", "ROOT = Path.cwd()"),
        ('str(ROOT / "chip_smoke.py"), "--tp-spawn-rank"', here),
        (spawns.group(0), f"TP_SPAWNS = {kept!r}"),
        (KERNELS, kernels.rstrip(" ")),
        ("    else:\n        main()", MAIN),
    ):
        if old not in src:
            raise SystemExit(f"chip_smoke.py no longer holds {old[:60]!r}")
        src = src.replace(old, new)
    out = ROOT / "build" / f"chip_smoke_{phases}.py"
    out.parent.mkdir(exist_ok=True)
    out.write_text(src)
    print(f"{out.relative_to(ROOT)}: TP_SPAWNS {kept}; run it from the repo's root")


if __name__ == "__main__":
    main()
