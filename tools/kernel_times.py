"""Device times of the encode kernels and ``ssd_chunk`` on one GPU, for one tree.

    python tools/kernel_times.py <tree root> <label> [--variants]

Loads ``repro_torch`` from ``<tree root>/src`` (this checkout's root, or a
``git archive`` of another commit unpacked under ``build/``) and times, as
``chip_smoke.py`` does (``chip_smoke.cuda_ms``: CUDA-graph replays), on the
inputs it draws: ``ssd_chunk`` at mamba2-370m's (g1) and (g3) prefill
layers; ``log_quantize`` b=8 and ``log_quantize_pack`` b=4 at the decode
append, prefill layer and scan leaf of gemma3-1b; ``log_dequantize`` at the
training path's two shapes (the f32 mean code of (4608, 1), the raw codes
of (5, 512)) and ``pack_nibbles`` at (f)'s QSGD leaf (5, 3, 3, 512, 512)
and at an odd n one code short of it (the tail path); and mamba2-370m's
(g1) prefill (4 x 1024 tokens, seeded weights), three replays and
torch.profiler's device time by kernel group. Prints one JSON line. To
compare two trees, run it in one call on one card, in turns: parent,
change, change, parent.

``--variants`` (this tree only) also times ``ssd_chunk`` at every head slab
and the kernels of ``log_quantize``, ``log_quantize_pack``,
``log_dequantize`` and ``pack_nibbles`` at other launch shapes (BLOCK x
warps) than their tables pick, on the same inputs, with the global and
shared memory instructions of each compiled variant's PTX (whether the
loads are vector loads, and whether a layout change went through shared
memory). For ``pack_nibbles`` it also times the other design of its
read, :func:`pair_pack_kernel` (the codes read as int16 pairs), beside
the shipped one (int8 codes, 2 x BLOCK in one contiguous run, split into
pairs in registers).
"""

import collections
import json
import re
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the timing helpers of this checkout)

ENCODE_SHAPES = {
    "decode_append": (4, 1, 1, 256),
    "prefill_layer": (4, 1, 1056, 256),
    "scan_leaf": (4, 4, 1, 1056, 256),
}
QUANTIZE_VARIANTS = ((128, 1), (128, 4), (256, 2), (512, 4), (1024, 4), (1024, 8))
QUANTIZE_VARIANTS += ((2048, 4), (2048, 8), (4096, 8))
# log_quantize_pack's BLOCK counts packed bytes (two values each)
PACK_VARIANTS = ((32, 1), (64, 1), (64, 2), (128, 4), (256, 2), (256, 4))
PACK_VARIANTS += ((256, 8), (512, 4), (512, 8), (1024, 4), (1024, 8), (2048, 4))
DEQUANT_VARIANTS = ((32, 1), (64, 2), (128, 4), (256, 4), (256, 8), (512, 4))
DEQUANT_VARIANTS += ((1024, 4), (2048, 4))
# pack_nibbles's BLOCK counts packed bytes: 1 to 32 a thread for either
# design of the read
NIBBLE_VARIANTS = ((128, 4), (256, 4), (512, 4), (1024, 4), (2048, 4))
NIBBLE_VARIANTS += ((4096, 4), (512, 8), (1024, 8), (2048, 8), (4096, 8))


def pair_pack_kernel():
    """The nibble pack's other read: the int8 codes as int16 pairs through
    an int16 view, one pair a byte, little-endian (low byte code 2i), so the
    byte is ``(v & 0xF) | ((v >> 4) & 0xF0)``. Even n only."""
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def pack_pairs(p_ptr, o_ptr, n_pairs, BLOCK: tl.constexpr):
        pid = tl.program_id(0).to(tl.int64)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        v = tl.load(p_ptr + offs, mask=offs < n_pairs, other=0).to(tl.int32)
        byte = ((v & 0xF) | ((v >> 4) & 0xF0)).to(tl.int8)
        tl.store(o_ptr + offs, byte, mask=offs < n_pairs)

    return pack_pairs


def ptx_memory_ops(compiled):
    """Counts of the global and shared loads and stores in a compiled
    Triton kernel's PTX, by instruction (``ld.global.v4.b32`` and the
    like)."""
    ops = re.findall(r"\b(?:ld|st)\.(?:global|shared)[\w.]*", compiled.asm["ptx"])
    return dict(collections.Counter(ops))


def time_variants(launch, variants):
    """{"BLOCKxwarps": ms} of ``launch(block, warps)`` over ``variants``, and
    the PTX memory instructions of each variant's compiled kernel."""
    times, ptx = {}, {}
    for block, warps in variants:
        key = f"{block}x{warps}"
        ptx[key] = ptx_memory_ops(launch(block, warps))
        times[key] = chip_smoke.cuda_ms(lambda: launch(block, warps), 50)
    return times, ptx


def main(root, label, variants=False):
    root = Path(root).resolve()
    sys.path.insert(0, str(root / "src"))
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import log_quant
    from repro_torch.kernels import ref as log_quant_ref
    from repro_torch.kernels.ssd_chunk import ssd_chunk_cuda
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import build_prefill_step

    if not Path(repro_torch.__file__).is_relative_to(root):
        raise SystemExit(f"repro_torch came from {repro_torch.__file__}, not {root}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"tree": label, "card": torch.cuda.get_device_name(0)}

    cfg = get_config("mamba2-370m")
    for run in ("g1", "g3"):
        batch, prompt = chip_smoke.SSM_RUNS[run]
        ins = chip_smoke._ssd_inputs(gen, cfg, batch, prompt // cfg.ssm_chunk)
        fn = lambda: ssd_chunk_cuda(*ins)
        result[f"ssd_chunk_{run}"] = chip_smoke.cuda_ms(fn, 10)
        if variants:
            rep = cfg.ssm_heads // cfg.ssm_groups
            result[f"ssd_chunk_{run}_by_slab"] = {
                slab: chip_smoke.cuda_ms(lambda: ssd_chunk_cuda(*ins, slab=slab), 10)
                for slab in (1, 2, 4, 8, 16, rep)
            }

    encoders = (
        ("log_quantize", 8, log_quant.log_quantize_triton),
        ("log_quantize_pack", 4, log_quant.log_quantize_pack_triton),
    )
    for where, shape in ENCODE_SHAPES.items():
        xn, _ = chip_smoke._rows(gen, shape)
        for name, bits, kernel in encoders:
            ms = chip_smoke.cuda_ms(lambda: kernel(xn, 1.0, bits=bits), 50)
            result[f"{name}_{where}"] = ms
        if variants:
            kernels, n = log_quant._kernels(), xn.numel()
            codes8 = torch.empty(shape, dtype=torch.int8, device="cuda")
            packed = torch.empty(((n + 1) // 2,), dtype=torch.int8, device="cuda")
            consts8, consts4 = log_quant._consts(8, 10.0), log_quant._consts(4, 10.0)

            def quantize(block, warps):
                return kernels.quantize[(-(-n // block),)](
                    xn,
                    codes8,
                    n,
                    1.0,
                    *consts8,
                    BLOCK=block,
                    UNIT=True,
                    num_warps=warps,
                )

            def quantize_pack(block, warps):
                nb = packed.numel()
                return kernels.quantize_pack[(-(-nb // block),)](
                    xn,
                    packed,
                    n,
                    nb,
                    1.0,
                    *consts4,
                    BLOCK=block,
                    UNIT=True,
                    num_warps=warps,
                )

            timed = (
                ("log_quantize", quantize, QUANTIZE_VARIANTS),
                ("log_quantize_pack", quantize_pack, PACK_VARIANTS),
            )
            for name, launch, shapes in timed:
                times, ptx = time_variants(launch, shapes)
                result[f"{name}_{where}_by_launch"] = times
                result[f"{name}_{where}_ptx"] = ptx

    means = torch.randint(-127, 128, (5, 4608, 1), generator=gen, device="cuda")
    raw = torch.randint(-127, 128, (5, 512), generator=gen, device="cuda").float()
    dequant_inputs = {"mean": means.float().mean(0), "raw": raw}
    for where, c in dequant_inputs.items():
        result[f"log_dequantize_{where}"] = chip_smoke.cuda_ms(
            lambda: log_quant.log_dequantize_triton(c, 1.0, bits=8), 50
        )
        if variants:
            out = torch.empty(c.shape, dtype=torch.float32, device="cuda")
            consts = log_quant._consts(8, 10.0)

            def dequant(block, warps):
                return log_quant._kernels().dequant[(-(-c.numel() // block),)](
                    c,
                    out,
                    c.numel(),
                    1.0,
                    *consts,
                    BLOCK=block,
                    UNIT=True,
                    num_warps=warps,
                )

            times, ptx = time_variants(dequant, DEQUANT_VARIANTS)
            result[f"log_dequantize_{where}_by_launch"] = times
            result[f"log_dequantize_{where}_ptx"] = ptx
    codes = torch.randint(-7, 8, (5, 3, 3, 512, 512), generator=gen, device="cuda")
    codes = codes.to(torch.int8)
    odd = codes.reshape(-1)[:-1]
    for where, c in (("", codes), ("_odd", odd)):
        got, want = log_quant.pack_nibbles_triton(c), log_quant_ref.pack_nibbles_ref(c)
        if not torch.equal(got, want):
            raise SystemExit(f"pack_nibbles{where}: bytes differ from the plain one")
        result[f"pack_nibbles{where}"] = chip_smoke.cuda_ms(
            lambda: log_quant.pack_nibbles_triton(c), 50
        )
    if variants:
        n = codes.numel()
        pairs = codes.reshape(-1).view(torch.int16)
        packed = torch.empty((n // 2,), dtype=torch.int8, device="cuda")
        want = log_quant_ref.pack_nibbles_ref(codes)
        pair_pack = pair_pack_kernel()

        def int8_split(block, warps):
            grid = (-(-packed.numel() // block),)
            return log_quant._kernels().pack[grid](
                codes,
                packed,
                n,
                packed.numel(),
                BLOCK=block,
                EXACT=True,
                num_warps=warps,
            )

        def int16_pairs(block, warps):
            grid = (-(-packed.numel() // block),)
            return pair_pack[grid](
                pairs, packed, packed.numel(), BLOCK=block, num_warps=warps
            )

        timed = (
            ("int8_split", int8_split, NIBBLE_VARIANTS),
            ("int16_pairs", int16_pairs, NIBBLE_VARIANTS),
        )
        for design, launch, shapes in timed:
            for block, warps in shapes:
                packed.zero_()
                launch(block, warps)
                if not torch.equal(packed, want):
                    raise SystemExit(f"pack_nibbles {design} {block}x{warps}: bytes")
            times, ptx = time_variants(launch, shapes)
            result[f"pack_nibbles_{design}_by_launch"] = times
            result[f"pack_nibbles_{design}_ptx"] = ptx

    params = init_params(cfg, 1, "cuda")
    batch, prompt = chip_smoke.SSM_RUNS["g1"]
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, prompt))).cuda()
    prefill = build_prefill_step(cfg, prompt + chip_smoke.SSM_GEN)
    fn = lambda: prefill(params, tokens)
    replays = [chip_smoke.cuda_ms(fn, 1) for _ in range(3)]
    by_name = chip_smoke.device_ms_by_kernel(fn)
    groups = chip_smoke.kernel_groups(by_name, {"ssd_chunk": "ssd_chunk"})
    result["mamba_prefill_g1"] = {
        "graph_ms": replays,
        "median_ms": statistics.median(replays),
        "device_ms": sum(groups.values()),
        "groups_ms": groups,
        "kernels": sum(c for _, c in by_name.values()),
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], "--variants" in sys.argv[3:])
