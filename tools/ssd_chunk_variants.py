"""Time versions of the ssd_chunk CUDA kernel against each other on one GPU,
at mamba2-370m's prefill layers (g1) 4 x 1024 and (g3) 1 x 8192 tokens.

    python tools/ssd_chunk_variants.py [source.cu ...] [--fast-exp] [--one-tf32]

Each source (default: ``src/repro_torch/csrc/ssd_chunk.cu`` and
``tools/ssd_chunk_3xtf32.cu``, the tensor-core version) must export
``ssd_chunk_fwd`` with the C interface of that file. Each is compiled by
nvcc with the port's flags into ``build/variants/`` (all at once). Two
diagnostic copies of each may be added: ``--fast-exp``, whose decay takes
``__expf`` for ``expf`` (what the accurate exponential costs), and
``--one-tf32``, which keeps only the hi * hi product of a 3xTF32 source
(what the split costs). Every version is checked against the plain version
(max abs error <= 1e-4 of max |Y|, and two launches bit-equal; a version
that fails is reported as such, as a diagnostic copy is meant to), then
all are timed from CUDA-graph replays at the slab ``head_slab`` picks and
at 4, 8 and 16 heads, in turns (every version and slab, then all again in
reverse). The inputs are (g1) and (g3) as ``chip_smoke.py`` draws them, and
(g1) again with B and C rounded to bf16. Prints the ptxas report of each
and one JSON line.
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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels.ssd_chunk import head_slab  # noqa: E402

BUILD = ROOT / "build" / "variants"
SLABS = (4, 8, 16)  # head slabs timed beside head_slab's pick
THREE_PRODUCTS = """  mma_tf32(d, alo, bhi[0], bhi[1]);
  mma_tf32(d, ahi, blo[0], blo[1]);
"""


def _sources(sources, fast_exp, one_tf32):
    """{name: CUDA text}: each source, and its diagnostic copies."""
    texts = {}
    for src in sources:
        text = src.read_text()
        texts[src.stem] = text
        if fast_exp:
            texts[f"{src.stem}_fast_exp"] = text.replace("expf(", "__expf(")
        if one_tf32 and THREE_PRODUCTS in text:
            texts[f"{src.stem}_one_tf32"] = text.replace(THREE_PRODUCTS, "")
    return texts


def build_sources(texts):
    """{name: CUDA text} -> {name: its ``ssd_chunk_fwd``}, compiled by nvcc
    with the port's flags into ``build/variants/``, all at once."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu = BUILD / f"ssd_{name}.cu"
        cu.write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(BUILD / f"{name}.so")]
        procs[name] = subprocess.Popen(
            [*cmd, str(cu)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
        report = [
            ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln
        ]
        print(f"{name}: {' | '.join(report)}", flush=True)
        fn = ctypes.CDLL(str(BUILD / f"{name}.so")).ssd_chunk_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
        fn.argtypes += [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def run(fn, x, a_cum, bm, cm, slab, out=None):
    """One launch of a built ``ssd_chunk_fwd`` into ``out`` (or a new
    tensor) on the current stream."""
    b, h, nc, q, p = x.shape
    g, n = bm.shape[1], bm.shape[-1]
    if out is None:
        out = torch.empty((b, h, nc, q, p), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 19)(
        *x.stride(), *a_cum.stride(), *bm.stride(), *cm.stride()
    )
    ptrs = [t.data_ptr() for t in (x, a_cum, bm, cm, out)]
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*ptrs, b, h, g, nc, q, p, n, slab, strides, stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return out


def _launcher(fn, x, a_cum, bm, cm, slab):
    out = torch.empty(x.shape, dtype=torch.float32, device="cuda")
    return lambda: run(fn, x, a_cum, bm, cm, slab, out)


def main(argv):
    sources = [Path(a).resolve() for a in argv if not a.startswith("--")]
    default = [build.CSRC_DIR / "ssd_chunk.cu", ROOT / "tools" / "ssd_chunk_3xtf32.cu"]
    sources = sources or default
    libs = build_sources(_sources(sources, "--fast-exp" in argv, "--one-tf32" in argv))
    cfg = get_config("mamba2-370m")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": torch.cuda.get_device_name(0)}
    for run in ("g1", "g3", "g1_bf16_bc"):
        batch, prompt = chip_smoke.SSM_RUNS[run[:2]]
        x, a_cum, bm, cm = chip_smoke._ssd_inputs(gen, cfg, batch, prompt // 256)
        if run.endswith("bf16_bc"):
            bm, cm = (t.bfloat16().float() for t in (bm, cm))
        h, g = x.shape[1], bm.shape[1]
        slab = head_slab(batch, h, g, x.shape[2], x.shape[3], sms)
        slabs = sorted({slab, *SLABS} & set(range(1, h // g + 1)))
        bh, ch = (t.expand(-1, h, -1, -1, -1) for t in (bm, cm))
        want = ref.ssd_chunk_ref(x, a_cum, bh, ch)
        top = float(want.abs().max())
        launchers = {}
        for name, fn in libs.items():
            for s in slabs:
                launch = _launcher(fn, x, a_cum, bm, cm, s)
                got = launch().clone()
                err = float((got - want).abs().max())
                same = torch.equal(got, launch())
                result[f"{name}_{run}_slab{s}_rel_err"] = err / top
                result[f"{name}_{run}_slab{s}_ok"] = err <= 1e-4 * top and same
                launchers[f"{name}_{run}_slab{s}"] = launch
        times = {key: [] for key in launchers}
        for order in (list(launchers), list(reversed(launchers))):
            for key in order:
                times[key].append(chip_smoke.cuda_ms(launchers[key], 10))
        for key, ms in times.items():
            result[f"{key}_ms"] = ms
        result[f"head_slab_{run}"] = slab
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
