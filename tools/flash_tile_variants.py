"""Time tile-size variants of the bf16 flash-attention kernel against each
other on one GPU, at gemma3-1b's prefill shapes.

    python tools/flash_tile_variants.py

Each variant is ``src/repro_torch/csrc/flash_attention.cu`` with its tile
constants replaced (query rows a block, key rows a tile, threads a block),
compiled by nvcc with the port's flags into ``build/variants/`` (all at
once), checked against the f32 plain version (atol 2e-2) and timed from
CUDA-graph replays in turns (each variant, then all again in reverse). Prints
the ptxas report of each variant and one JSON line per shape.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (puts src/ on the path; the timing helpers)
from repro_torch.kernels import build, ref  # noqa: E402

BUILD = ROOT / "build" / "variants"
BASE = {"kBlockM": 64, "kBlockN": 64, "kThreads": 128}
VARIANTS = {
    "m64_n64": {},
    "m64_n32": {"kBlockN": 32},
    "m128_n64": {"kBlockM": 128, "kThreads": 256},
    "m128_n32": {"kBlockM": 128, "kBlockN": 32, "kThreads": 256},
}
# (S, window): gemma3-1b's global and local layers, a ragged S, a short one
SHAPES = ((1024, None), (1024, 512), (1000, None), (65, 48))


def _build():
    src = (build.CSRC_DIR / "flash_attention.cu").read_text()
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for const, value in subs.items():
            line = f"constexpr int {const} = {BASE[const]};"
            if line not in text:
                raise SystemExit(f"{line!r} not in the source")
            text = text.replace(line, f"constexpr int {const} = {value};")
        cu = BUILD / f"flash_{name}.cu"
        cu.write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(BUILD / f"{name}.so")]
        procs[name] = subprocess.Popen(
            [*cmd, str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
        report = [ln.strip() for ln in out.splitlines() if "registers" in ln]
        print(f"{name}: {report}", flush=True)


def _kernel(name):
    fn = ctypes.CDLL(str(BUILD / f"{name}.so")).flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
    fn.argtypes += [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(q, k, v, window):
        out = torch.empty_like(q)
        b, hq, s, d = q.shape
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        err = fn(*ptrs, b, hq, k.shape[1], s, d, window or 0, d**-0.5, 1, stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return out

    return call


def main():
    card = chip_smoke.phase_device()
    _build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = {name: _kernel(name) for name in VARIANTS}
    for s, window in SHAPES:
        q, k, v = (
            torch.randn((4, h, s, 256), generator=gen, device="cuda").bfloat16()
            for h in (4, 1, 1)
        )
        want = ref.attention_ref(q.float(), k.float(), v.float(), window=window)
        row = {"card": card, "s": s, "window": window}
        for name in [*VARIANTS, *reversed(VARIANTS)]:
            f = kernels[name]
            err = float((f(q, k, v, window).float() - want).abs().max())
            if err > 2e-2:
                raise SystemExit(f"{name} S={s} window={window}: max err {err}")
            ms = chip_smoke.cuda_ms(lambda: f(q, k, v, window), 20)
            row.setdefault(name, {"max_abs_err": err, "ms": []})["ms"].append(ms)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
