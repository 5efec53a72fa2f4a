"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: require CUDA, print the card's name and power limit;
2. build: compile every CUDA source of ``src/repro_torch/csrc`` with nvcc
   (in parallel) and warm up the Triton kernels;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes the serving path gives it, with its time, its
   plain version's time, a library call's time where one exists, and its
   bound (the least time the card could take for the same work);
4. serve gemma3-1b at full width and depth (26 layers, bf16, seeded random
   weights): (a) fixed batch 4, prompt 1024, 32 new tokens, q8 cache;
   (b) the same with a q4 cache; (c) the continuous scheduler, 8 requests
   of 200-1000 prompt tokens and 32 new tokens each through 4 slots, q8.
   Each run starts with the launch counts at 0 and must launch every
   kernel of its path; bytes/token must equal the wire accounting; logits
   must be finite; prefill logits must match the same forward in reference
   mode, and decode from the same caches in reference mode must give every
   request the same tokens and leave the same caches.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Nothing of JAX is imported.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its bytes over the memory rate and its operations
# over the peak rate for their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}
# f32 operations per value of the log-quant maps (abs, scale, log1p/expm1,
# divide, sign, level multiply, round, clip), counted from the formula
QUANT_OPS, DEQUANT_OPS = 10, 7

ARCH = "gemma3-1b"
BATCH, PROMPT, GEN = 4, 1024, 32
REPEATS = 4  # gemma3-1b's scan leaves stack 4 repeats of LLLLLG
N_REQUESTS, SLOTS = 8, 4
# Prefill last-position logits, kernel path vs the same forward in reference
# mode, both bf16 through 26 layers: the flash kernel and the plain
# attention round to bf16 at different points, and the difference is carried
# through every later layer. Bound: max |diff| <= 5% of max |logit|; and in
# every row whose reference top-2 margin exceeds twice the row's max |diff|,
# the same argmax.
LOGITS_REL_TOL = 5e-2
# Decode, kernel path vs reference mode from the same caches: the encode and
# dequant kernels match their plain versions bit for bit off bin edges and
# decode attention is plain torch in both, so greedy tokens must be equal.
# Caches after decode: codes equal but for one-step bin-edge flips; scales
# within 1% of the largest (a flip moves what later layers see).
CACHE_SCALE_REL_TOL = 1e-2


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters):
    """Mean device time of ``fn`` in ms: ``iters`` calls captured into one
    CUDA graph (after a warm-up call on a side stream) and replayed between
    CUDA events, so the host's launch overhead between calls is not timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, repeats=3):
    """Median host time of ``fn`` in ms, each call ending in a device sync:
    what a caller waits for, launch overhead included."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def bound_ms(n_bytes, n_ops, kind):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[kind]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# --------------------------------------------------------------------- phases
def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; it needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    v = sys.version.split()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {v}")
    return card


def phase_build():
    from repro_torch.kernels import build, log_quant

    t0 = time.perf_counter()
    names = sorted(p.stem for p in build.CSRC_DIR.glob("*.cu"))
    libs = build.build_all(names)
    t_nvcc = time.perf_counter() - t0
    for name, so in libs.items():
        report = so.with_suffix(".log")
        for line in report.read_text().splitlines() if report.exists() else []:
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    x = torch.randn(4096, device="cuda")
    codes = log_quant.log_quantize_triton(x, 1.0, bits=8)
    log_quant.log_quantize_pack_triton(x, 1.0, bits=4)
    scales = torch.ones(16, 1, device="cuda")
    log_quant.log_dequantize_rows_triton(codes.view(16, 256), scales, bits=8)
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    print(
        f"build: {len(names)} CUDA source(s) by nvcc in {t_nvcc:.1f} s, "
        f"Triton warm-up done at {t_all:.1f} s"
    )


def _near_half(x, bits):
    """Where the exact pre-rounding value q*L of normalized ``x`` lies within
    1e-4 of a half-integer: there the device's log1p may round either way."""
    levels = (1 << (bits - 1)) - 1
    u = torch.log1p(10.0 * x.double().abs()) / math.log1p(10.0) * levels
    return ((u - u.floor()) - 0.5).abs() < 1e-4


def _code_flips(got, want, near, label):
    """Codes must be equal, except by one step where ``near`` holds."""
    diff = (got.int() - want.int()).abs()
    bad = (diff > 1) | ((diff == 1) & ~near)
    check(not bool(bad.any()), f"{label}: {int(bad.sum())} codes differ off a bin edge")
    flips = int((diff > 0).sum())
    print(f"  {label}: codes equal but {flips} one-step flip(s) at bin edges")
    return int(diff.max())


def _rows(gen, shape):
    """Normalized rows as the encode gets them: ``shape`` f32, each last-dim
    row divided by its max |x|; on a max_seq axis the rows past the prompt
    are zero, as in prefill's padded cache."""
    x = torch.randn(shape, generator=gen, device="cuda")
    if shape[-2] == PROMPT + GEN:
        x[..., PROMPT:, :] = 0
    scale = x.abs().amax(-1, keepdim=True)
    return x / torch.where(scale > 0, scale, torch.ones_like(scale)), scale


def phase_kernels(gen):
    from repro_torch.core.codec import unpack_nibbles
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.log_quant import (
        log_dequantize_rows_triton,
        log_quantize_pack_triton,
        log_quantize_triton,
    )

    results = {}
    layer = (BATCH, 1, PROMPT + GEN, 256)
    # the encodes' shapes on the serving path: prefill quantizes a tail
    # layer's K or V, and a scan leaf's K or V stacked over its repeats, in
    # one launch each; every decode step quantizes one token per layer (a
    # size below one program's block, so its tail is masked)
    encode_shapes = {
        "prefill layer": layer,
        "prefill scan leaf": (REPEATS,) + layer,
        "decode append": (BATCH, 1, 1, 256),
    }
    encoders = (
        ("log_quantize", 8, log_quantize_triton, ref.log_quantize_ref),
        ("log_quantize_pack", 4, log_quantize_pack_triton, ref.log_quantize_pack_ref),
    )
    print("kernels at the serving path's shapes")

    # ---- #1 log_quantize b = 8 and #3 log_quantize_pack b = 4; the prefill
    # layer's codes and scales feed #4 below
    layer_codes = {}
    for where, shape in encode_shapes.items():
        xn, scale = _rows(gen, shape)
        n = xn.numel()
        main = where == "prefill layer"
        if main:
            layer_scale = scale
        for name, bits, kernel, plain in encoders:
            got, want = kernel(xn, 1.0, bits=bits), plain(xn, 1.0, bits, 10.0)
            if main:
                layer_codes[bits] = want
            if bits <= 4:
                got, want = unpack_nibbles(got, n), unpack_nibbles(want, n)
            err = _code_flips(
                got.reshape(-1),
                want.reshape(-1),
                _near_half(xn, bits).reshape(-1),
                f"{name} b={bits} {where} {shape}",
            )
            out_bytes = n * bits // 8
            b_ms, b_by = bound_ms(n * 4 + out_bytes, n * QUANT_OPS, "f32")
            res = dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: kernel(xn, 1.0, bits=bits), 50),
                plain_ms=cuda_ms(lambda: plain(xn, 1.0, bits, 10.0), 20),
                bound_ms=b_ms,
                bound_by=b_by,
                library_ms=None,
            )
            emit({"kernel": name, "shape": list(shape), **res})
            if main:
                results[name] = res

    # ---- #4 log_dequantize_rows, q8 and q4: relative error <= 1e-6
    r, d = layer_scale.numel(), 256
    codes8, packed4 = layer_codes[8], layer_codes[4]
    s2 = layer_scale.reshape(r, 1).contiguous()
    errs = {}
    for bits, c in ((8, codes8.reshape(r, d)), (4, packed4.reshape(r, d // 2))):
        got = log_dequantize_rows_triton(c, s2, bits=bits)
        want = ref.log_dequantize_rows_ref(c, s2, bits, 10.0)
        rel = (got - want).abs() / want.abs().clamp_min(1e-30)
        rel = rel.masked_fill(want == 0, 0)
        check(bool(((got == 0) == (want == 0)).all()), f"dequant q{bits}: zeros moved")
        check(float(rel.max()) <= 1e-6, f"dequant q{bits}: rel err {float(rel.max())}")
        errs[bits] = float((got - want).abs().max())
        nb = c.shape[1]
        b_ms, b_by = bound_ms(r * nb + r * 4 + r * d * 4, r * d * DEQUANT_OPS, "f32")
        res = dict(
            max_abs_err=errs[bits],
            ms=cuda_ms(lambda: log_dequantize_rows_triton(c, s2, bits=bits), 50),
            plain_ms=cuda_ms(
                lambda: ref.log_dequantize_rows_ref(c, s2, bits, 10.0), 20
            ),
            bound_ms=b_ms,
            bound_by=b_by,
            library_ms=None,
        )
        print(f"  log_dequantize_rows q{bits}: max rel err {float(rel.max()):.2e}")
        emit({"kernel": f"log_dequantize_rows_q{bits}", **res})
        if bits == 8:
            results["log_dequantize_rows"] = res

    # ---- #6 flash attention, bf16, atol 2e-2 against the f32 plain version
    def qkv(s):
        q = torch.randn((BATCH, 4, s, 256), generator=gen, device="cuda")
        k = torch.randn((BATCH, 1, s, 256), generator=gen, device="cuda")
        v = torch.randn((BATCH, 1, s, 256), generator=gen, device="cuda")
        return [t.to(torch.bfloat16) for t in (q, k, v)]

    worst = 0.0
    for s, window in ((PROMPT, None), (PROMPT, 512), (1000, None)):
        q, k, v = qkv(s)
        got = flash_attention_cuda(q, k, v, window=window)
        want = ref.attention_ref(q.float(), k.float(), v.float(), window=window)
        e = float((got.float() - want).abs().max())
        check(e <= 2e-2, f"flash_attention S={s} window={window}: max err {e}")
        worst = max(worst, e)
        if s != PROMPT:
            print(f"  flash_attention ragged S={s}: max abs err {e:.2e}")
            continue
        kr, vr = (t.repeat_interleave(4, dim=1) for t in (k, v))
        i = torch.arange(s, device="cuda")
        mask = i[None, :] <= i[:, None]
        if window is not None:
            mask &= i[None, :] > i[:, None] - window
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if window is None:
            lib = lambda: sdpa(q, kr, vr, is_causal=True)
        else:
            lib = lambda: sdpa(q, kr, vr, attn_mask=mask)
        pairs = int(mask.sum()) * BATCH * 4
        n_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        b_ms, b_by = bound_ms(n_bytes, 4 * 256 * pairs, "bf16")
        res = dict(
            max_abs_err=e,
            ms=cuda_ms(lambda: flash_attention_cuda(q, k, v, window=window), 10),
            plain_ms=cuda_ms(lambda: ref.attention_ref(q, k, v, window=window), 5),
            bound_ms=b_ms,
            bound_by=b_by,
            library_ms=cuda_ms(lib, 10),
        )
        print(f"  flash_attention S={s} window={window}: max abs err {e:.2e}")
        emit({"kernel": f"flash_attention_window_{window}", **res})
        if window is None:
            results["flash_attention"] = res
    results["flash_attention"]["max_abs_err"] = worst
    return results


def _logits_close(got, want, label):
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{label}: non-finite logits")
    diff = (g - w).abs()
    rel = float(diff.max()) / float(w.abs().max())
    check(rel <= LOGITS_REL_TOL, f"{label}: logits vs reference mode rel {rel:.3e}")
    top2 = w.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * diff.amax(-1)
    agree = g.argmax(-1) == w.argmax(-1)
    check(bool((agree | ~decided).all()), f"{label}: argmax differs past its margin")
    print(
        f"  {label}: prefill logits vs reference mode rel {rel:.3e}, argmax equal "
        f"in {int(agree.sum())} of {agree.numel()} rows ({int(decided.sum())} "
        "decided by margin)"
    )


def _caches_match(got, want, label):
    """Two cache trees, leaf by leaf, by the rule of CACHE_SCALE_REL_TOL."""
    from repro_torch.core.codec import unpack_nibbles
    from repro_torch.serving.kv_cache import QuantKV, tree_leaves

    flips = 0
    for (path, g), (_, w) in zip(tree_leaves(got), tree_leaves(want), strict=True):
        if isinstance(g, QuantKV):
            gc, wc = g.codes, w.codes
            if g.bits <= 4:
                n = 2 * gc.shape[-1]
                gc, wc = unpack_nibbles(gc, n), unpack_nibbles(wc, n)
            diff = (gc.int() - wc.int()).abs()
            check(int(diff.max()) <= 1, f"{label}: cache codes at {path} differ")
            flips += int((diff > 0).sum())
            g, w = g.scale, w.scale
        g, w = g.float(), w.float()
        rel = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        check(rel <= CACHE_SCALE_REL_TOL, f"{label}: cache at {path}: rel {rel:.3e}")
    return flips


def phase_serve(card, gen):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import count_params, init_params
    from repro_torch.serving.engine import (
        build_decode_step,
        build_generate_fn,
        build_prefill_step,
        greedy_sample,
    )
    from repro_torch.serving.kv_cache import CacheQuantConfig
    from repro_torch.serving.scheduler import ContinuousScheduler, Request

    need = {
        "a": ("log_quantize", "log_dequantize_rows", "flash_attention"),
        "b": ("log_quantize_pack", "log_dequantize_rows", "flash_attention"),
        "c": ("log_quantize", "log_dequantize_rows", "flash_attention"),
    }
    expect_bpt = {8: 13520.0, 4: 6864.0}
    total = {name: 0 for name in ops.KERNELS}

    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, 1, "cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    print(
        f"serve {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"{count_params(params)} params in {cfg.dtype}, init {t_init:.1f} s"
    )
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, PROMPT))).cuda()

    for variant, bits in (("a", 8), ("b", 4)):
        qcfg = CacheQuantConfig(bits=bits)
        prefill = build_prefill_step(cfg, PROMPT + GEN, qcfg=qcfg)
        with ops.reference_mode():
            ref_logits, _ = prefill(params, tokens)
        ops.reset_launch_counts()
        out = serve.run_fixed(cfg, params, tokens, gen=GEN, qcfg=qcfg)
        counts = ops.launch_counts()
        label = f"({variant}) fixed batch {BATCH} x prompt {PROMPT} + {GEN}, q{bits}"
        print(f"{label}: launches {counts}")
        for name in need[variant]:
            check(counts[name] > 0, f"{label}: kernel {name} never launched")
        for name, c in counts.items():
            total[name] += c
        _logits_close(out["logits"], ref_logits, label)
        toks = out["tokens"]
        check(tuple(toks.shape) == (BATCH, GEN), f"{label}: tokens {tuple(toks.shape)}")
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), f"{label}: bad ids")
        # decode vs reference mode from the same caches: the kernel path's
        # prefill again (deterministic, so the main run's caches), then every
        # decode step in reference mode must pick the main run's tokens and
        # leave the main run's caches
        logits, caches = prefill(params, tokens)
        check(torch.equal(greedy_sample(logits), toks[:, :1]), f"{label}: first token")
        with ops.reference_mode():
            caches, _, _, sampled = build_generate_fn(cfg)(
                params, caches, toks[:, :1], PROMPT, None, GEN - 1
            )
        same = sampled == toks[:, 1:]
        check(
            bool(same.all()),
            f"{label}: {int((~same).sum())} of {same.numel()} decode tokens "
            "differ from reference mode",
        )
        flips = _caches_match(out["caches"], caches, label)
        print(
            f"  {label}: {same.numel()} decode tokens equal to reference mode, "
            f"caches equal but {flips} one-step code flip(s)"
        )
        bpt, acc = out["bytes_per_token"], out["bytes_per_token_accounted"]
        check(bpt == acc == expect_bpt[bits], f"{label}: bytes/token {bpt} vs {acc}")
        # where the time goes: each step eager (host clock, launch overhead
        # included) against the same step replayed from a CUDA graph (device
        # time only); one more decode step at the last cache position
        caches, last = out["caches"], out["tokens"][:, -1:].contiguous()
        decode = build_decode_step(cfg)
        steps = {
            "prefill": lambda: prefill(params, tokens),
            "decode_step": lambda: decode(params, caches, last, PROMPT + GEN - 1),
        }
        for step, fn in steps.items():
            emit(
                {
                    "split": f"{step}_q{bits}",
                    "card": card,
                    "host_ms": host_ms(fn),
                    "graph_ms": cuda_ms(fn, 1),
                }
            )
        emit(
            {
                "serve": f"fixed_q{bits}",
                "card": card,
                "prefill_ms": out["prefill_s"] * 1e3,
                "decode_tokens_per_s": BATCH * (GEN - 1) / out["decode_s"],
                "bytes_per_token": bpt,
                "bytes_per_token_accounted": acc,
            }
        )

    prompts = [
        rng.integers(0, cfg.vocab_size, size=int(n))
        for n in rng.integers(200, 1001, size=N_REQUESTS)
    ]
    ops.reset_launch_counts()
    out = serve.run_continuous(
        cfg, params, prompts, gen=GEN, slots=SLOTS, qcfg=CacheQuantConfig(bits=8)
    )
    counts = ops.launch_counts()
    label = f"(c) continuous {N_REQUESTS} requests through {SLOTS} slots, q8"
    print(f"{label}: prompt lengths {[len(p) for p in prompts]}, launches {counts}")
    for name in need["c"]:
        check(counts[name] > 0, f"{label}: kernel {name} never launched")
    for name, c in counts.items():
        total[name] += c
    done = out["tokens"]
    check(sorted(done) == list(range(N_REQUESTS)), f"{label}: requests {sorted(done)}")
    for uid, toks in done.items():
        check(len(toks) == GEN, f"{label}: request {uid} has {len(toks)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in toks), f"{label}: bad ids")
    # the same requests again with every decode chunk in reference mode; the
    # admission prefills stay on the kernels, so each chunk starts from the
    # main run's caches, and every request must get the main run's tokens
    sched = out["scheduler"]
    ref_sched = ContinuousScheduler(
        cfg,
        params,
        slots=SLOTS,
        max_seq=sched.max_seq,
        qcfg=CacheQuantConfig(bits=8),
        device="cuda",
    )
    kernel_generate = ref_sched._generate

    def plain_generate(*args):
        with ops.reference_mode():
            return kernel_generate(*args)

    ref_sched._generate = plain_generate
    want = ref_sched.run(
        [Request(uid=i, prompt=p, max_new=GEN) for i, p in enumerate(prompts)]
    )
    for uid, toks in done.items():
        n_diff = sum(a != b for a, b in zip(toks, want[uid], strict=True))
        check(n_diff == 0, f"{label}: request {uid}: {n_diff} tokens differ")
    flips = _caches_match(sched.caches, ref_sched.caches, label)
    print(
        f"  {label}: every request's tokens equal to reference-mode decode, "
        f"caches equal but {flips} one-step code flip(s)"
    )
    # the slot grid's caches as the run left them: one more decode step at
    # each slot's next position must give finite logits
    logits, _ = build_decode_step(cfg)(
        params,
        sched.caches,
        torch.as_tensor(sched.cur[:, None], device="cuda"),
        torch.as_tensor(sched.lengths, device="cuda"),
    )
    check(bool(torch.isfinite(logits).all()), f"{label}: non-finite logits")
    bpt, acc = out["bytes_per_token"], out["bytes_per_token_accounted"]
    check(bpt == acc == expect_bpt[8], f"{label}: bytes/token {bpt} vs {acc}")
    emit(
        {
            "serve": "continuous_q8",
            "card": card,
            "seconds": out["seconds"],
            "tokens_per_s": N_REQUESTS * GEN / out["seconds"],
            "decode_chunks": out["scheduler"].steps,
            "bytes_per_token": bpt,
            "bytes_per_token_accounted": acc,
        }
    )
    return total


KERNEL_INFO = {
    "log_quantize": (
        "triton",
        "src/repro_torch/kernels/log_quant.py",
        "src/repro/kernels/log_quant.py:63",
    ),
    "log_quantize_pack": (
        "triton",
        "src/repro_torch/kernels/log_quant.py",
        "src/repro/kernels/log_quant.py:153",
    ),
    "log_dequantize_rows": (
        "triton",
        "src/repro_torch/kernels/log_quant.py",
        "src/repro/kernels/log_quant.py:215",
    ),
    "flash_attention": (
        "cuda",
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:75",
    ),
}


def main():
    card = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    measured = phase_kernels(gen)
    launches = phase_serve(card, gen)
    kernels = []
    for name, (route, source, replaces) in KERNEL_INFO.items():
        entry = {
            "name": name,
            "route": route,
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            **measured[name],
        }
        emit({"kernel": name, "card": card, "kernel_ms": entry["ms"], **entry})
        kernels.append(entry)
    emit({"kernels": kernels})
    emit(
        {
            "ok": True,
            "device": {
                "platform": "gpu",
                "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count(),
            },
        }
    )


if __name__ == "__main__":
    main()
