"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: require CUDA, print the card's name and power limit;
2. build: compile every CUDA source of ``src/repro_torch/csrc`` with nvcc
   (in parallel) and warm up the Triton kernels;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes the serving and training paths give it, with its
   time, its plain version's time, a library call's time where one exists,
   and its bound (the least time the card could take for the same work);
4. serve gemma3-1b at full width and depth (26 layers, bf16, seeded random
   weights): (a) fixed batch 4, prompt 1024, 32 new tokens, q8 cache;
   (b) the same with a q4 cache; (c) the continuous scheduler, 8 requests
   of 200-1000 prompt tokens and 32 new tokens each through 4 slots, q8.
   Each run starts with the launch counts at 0 and must launch every
   kernel of its path; bytes/token must equal the wire accounting; logits
   must be finite; prefill logits must match the same forward in reference
   mode, and decode from the same caches in reference mode must give every
   request the same tokens and leave the same caches; torch.profiler splits
   the device time of (a)'s prefill and (b)'s decode step by kernel;
5. train ResNet-18 at full width, the paper's layout (5 workers x 128
   images, 32x32x3, 10 classes, seeded init, f32: the phase turns both
   TF32 flags on, PyTorch's cuDNN default, and every step must find them
   off, as the training entry point sets them, and both back on after
   it), a few steps each of (d) LQ-SGD rank 1, b = 8, (e) LQ-SGD rank 1,
   b = 4 and (f) QSGD b = 4. Each run starts with the launch counts at 0 and must
   launch every kernel of its path; every step's wire bits must equal the
   static accounting (370136 bits for (d), 3.655093 MB/epoch) and its
   collectives the count from the plans; losses must be finite; and the
   same run in reference mode, from the same init and batches, must ship
   the same codes (but for one-step bin-edge flips; QSGD's bytes exactly,
   from the same generator seeds) and end with the same synced gradients
   and parameters, within the tolerance of :func:`train_tol`;
6. serve mamba2-370m at full width and depth (48 Mamba-2 layers, bf16,
   seeded random weights; f32 matmuls with TF32 off, as phase 1 sets),
   fixed scheduler: (g1) batch 4, prompt 1024 (4 chunks), 32 new tokens,
   raw and with ``--cache-bits 8`` (which leaves the SSM cache raw);
   (g2) batch 4, prompt 1000 (a ragged last chunk); (g3) batch 1, prompt
   8192 (32 chunks). Each prefill launches ``ssd_chunk`` once per layer and
   each decode step none; prefill logits and caches must match the same
   prefill in reference mode; greedy tokens are compared with a
   reference-mode run; bytes/token must equal the accounting (48290.909
   for (g1), the JAX package's figure);
7. the gradient-inversion trust claim (paper §V-C), through
   ``python -m repro_torch.bench.gia_ssim``'s ``bench``: (h1) the JAX
   benchmark's sweep as it stands (its 2-conv victim net, a 16x16x3 target,
   all 8 methods, 10 victim steps, attacks at steps 0 and 9, best of 8
   restarts, 300 sign-Adam steps) and (h2) the same harness on ResNet-18 at
   full width (one 32x32x3 target; sgd, lq_sgd_r1, lq_sgd_r1_b4), in f32:
   the phase turns both TF32 flags on and every victim sync and gradient
   must find them off. Each run starts with the launch counts at 0 and
   must launch the LQ-SGD kernels; every victim step's observed gradient
   must equal the same run's in reference mode (codes but for one-step
   bin-edge flips, synced gradients within :func:`train_tol`) and its bits
   the accounting; at (h1)'s cold start SGD must leak more than 0.15 SSIM,
   and at its steady state at least as much as LQ-SGD r1 by the mean best
   SSIM of 8 restarts over 32 groups (the JAX package's own claims). It
   prints the SSIM table, the ms of one batched attack step, its idle
   share and a torch.profiler split of (h2)'s.

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
# integer operations per code of the nibble pack (mask, shift, or), counted
# at the f32 rate: the table of peaks has no int32 ALU rate, and the pack's
# bound is its bytes by a factor of ~30 at either rate
PACK_OPS = 2

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

TRAIN_WORKERS, TRAIN_BATCH, TRAIN_HW, TRAIN_CLASSES = 5, 128, 32, 10
TRAIN_STEPS, TRAIN_LR = 3, 0.05
CIFAR_TRAIN_IMAGES = 50_000
# Training, kernel path vs reference mode from the same init and batches:
# the encodes match their plain versions but for one-step flips at bin
# edges and the dequant within 2 ulp, so synced gradients and parameters
# agree to f32 noise (1e-5 of a leaf's largest value over 3 steps) unless a
# code flipped. A one-step flip of one worker's code moves the mean code by
# 1/N level, which scales that value by at most (1 + alpha)^(1/(N L)); the
# bound then is twice that change. QSGD's path differs only in the exact
# pack, so its bytes, gradients and parameters must be equal.
ALPHA = 10.0

# the hand-written kernels of a gemma3-1b step, by a substring of the kernel
# name the profiler reports, for the step's device time by kernel
GEMMA_KERNELS = {"flash_attention": "flash_fwd", "dequant": "dequant_rows"}
MATMUL_KERNELS = ("gemm", "gemv", "cutlass", "xmma", "nvjet")  # cuBLAS

SSM_ARCH = "mamba2-370m"
# (g1) batch 4, prompt 1024 (4 chunks of 256); (g2) prompt 1000, a ragged
# last chunk; (g3) one prompt of 8192 (32 chunks), the long-prompt case
SSM_RUNS = {"g1": (4, 1024), "g2": (4, 1000), "g3": (1, 8192)}
SSM_GEN = 32
# (g1)'s cache: conv (48, 4, 3, 2304) bf16 + ssm (48, 4, 32, 64, 128) f32 =
# 203,980,800 bytes over 4 x 1056 positions, the JAX package's
# cache_bytes_per_token for this shape
SSM_G1_BYTES_PER_TOKEN = 203_980_800 / (4 * 1056)
# ssd_chunk vs its plain version, f32: max abs error <= 1e-4 of max |Y|.
# Both sum up to N + Q = 384 f32 products an entry, in other orders (K eps
# = 2.3e-5 for K = 384).
SSD_REL_TOL = 1e-4
# Prefill, kernel path vs reference mode: the intra-chunk term may differ
# from the plain version's in the last f32 bits (another summation order),
# every layer casts its output to bf16, where such a difference now and
# then flips a rounding (2^-8 relative), and 48 layers carry the flips on.
# Logits: LOGITS_REL_TOL and the argmax rule, as for gemma3-1b; caches
# (conv window, SSM state): within 5% of each leaf's largest value.
SSM_CACHE_REL_TOL = 5e-2


# Phase 7, the GIA runs: (h1) the JAX benchmark's victim net, (h2) ResNet-18
GIA_RUNS = {"h1": "cnn", "h2": "resnet18"}
# the JAX package's claims (tests/test_privacy.py): at the cold start the
# attack recovers structure from the raw gradient (SSIM above 0.15); at the
# steady state SGD leaks at least as much as LQ-SGD r1
GIA_COLD_SSIM_MIN = 0.15
# The steady-state claim is about the benchmark's statistic, the best SSIM of
# 8 restarts, whose spread between draws is larger than the effect: over 16
# harness seeds SGD's best of 8 minus LQ-SGD r1's was 0.139 +- 0.186 (sd) on
# the CPU and 0.068 +- 0.235 on the H100, below 0 in 4 and 5 of them
# (tools/gia_ordering.py). One draw does not decide it, so the check takes
# the mean best of 8 over 32 groups of 8 restarts (256 restarts in one
# batched attack a method, the same starting images for both methods).
GIA_ORDER_RESTARTS, GIA_ORDER_GROUP = 256, 8
# the device-time split of an attack step: cuDNN's convolutions by kernel name
CONV_KERNELS = ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd")


def train_tol(bits, flips, workers=TRAIN_WORKERS):
    if flips == 0:
        return 1e-5
    levels = (1 << (bits - 1)) - 1
    return 2 * ((1 + ALPHA) ** (1 / (workers * levels)) - 1)


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


def device_ms_by_kernel(fn):
    """Device time of one warm call of ``fn`` by kernel name, from
    torch.profiler: {name: [ms, launches]}; empty where the profiler saw no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            ms_n = by_name.setdefault(evt.name, [0.0, 0])
            ms_n[0] += evt.time_range.elapsed_us() / 1e3
            ms_n[1] += 1
    return by_name


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
    # every launch shape of the encode, the fused encode + pack (its table
    # counts packed bytes) and the wire dequant, at the unit scale their
    # callers pass; then every launch shape of the bare pack
    warm_ups = (
        (log_quant.QUANTIZE_LAUNCH, 1, log_quant.log_quantize_triton, 8),
        (log_quant.PACK_LAUNCH, 2, log_quant.log_quantize_pack_triton, 4),
        (log_quant.DEQUANT_LAUNCH, 1, log_quant.log_dequantize_triton, 8),
    )
    for table, per_row, kernel, bits in warm_ups:
        for top, _, _ in table:
            n = per_row * top if top else 1 << 20
            kernel(torch.randn(n, device="cuda"), 1.0, bits=bits)
    codes = log_quant.log_quantize_triton(x, 1.0, bits=8).clamp(-8, 7)
    for top, _, _ in log_quant.NIBBLE_LAUNCH:  # in packed bytes, two codes each
        n = 2 * top if top else 1 << 20
        log_quant.pack_nibbles_triton(codes.repeat(n // codes.numel()))
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
    from repro_torch.configs import get_config
    from repro_torch.core.codec import unpack_nibbles
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.log_dequant_rows import log_dequantize_rows_cuda
    from repro_torch.kernels.log_quant import (
        log_dequantize_triton,
        log_quantize_pack_triton,
        log_quantize_triton,
        pack_nibbles_triton,
    )
    from repro_torch.kernels.ssd_chunk import ssd_chunk_cuda

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
        got = log_dequantize_rows_cuda(c, s2, bits=bits)
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
            ms=cuda_ms(lambda: log_dequantize_rows_cuda(c, s2, bits=bits), 50),
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

    print("kernels at the training path's shapes")
    # ---- #5 log_dequantize, within 2 ulp of the plain version: the
    # paper-mode mean of 5 workers' b=8 codes at the largest factor of
    # ResNet-18 (P of a 3x3x512 conv, 4608 x rank 1), and the decoded codes
    # of 5 workers for the largest raw leaf (512) under dequant_then_mean
    def codes(shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda").float()

    inputs = {
        "paper-mode mean": codes((TRAIN_WORKERS, 4608, 1)).mean(0),
        "raw codes": codes((TRAIN_WORKERS, 512)),
    }
    for where, c in inputs.items():
        shape = tuple(c.shape)
        got = log_dequantize_triton(c, 1.0, bits=8)
        want = ref.log_dequantize_ref(c, 1.0, 8, ALPHA)
        ulp = torch.nextafter(want.abs(), torch.full_like(want, math.inf)) - want.abs()
        check(bool(((got - want).abs() <= 2 * ulp).all()), f"dequant {where}: > 2 ulp")
        n = c.numel()
        b_ms, b_by = bound_ms(n * 4 + n * 4, n * DEQUANT_OPS, "f32")
        res = dict(
            max_abs_err=float((got - want).abs().max()),
            ms=cuda_ms(lambda: log_dequantize_triton(c, 1.0, bits=8), 50),
            plain_ms=cuda_ms(lambda: ref.log_dequantize_ref(c, 1.0, 8, ALPHA), 20),
            bound_ms=b_ms,
            bound_by=b_by,
            library_ms=None,
        )
        print(f"  log_dequantize {where} {shape}: max abs err {res['max_abs_err']:.2e}")
        emit({"kernel": "log_dequantize", "input": where, "shape": list(shape), **res})
        if where == "paper-mode mean":
            results["log_dequantize"] = res

    # ---- #2 pack_nibbles, exact: QSGD b=4 codes of ResNet-18's largest leaf
    # (3x3x512x512) over the 5 workers, packed in one launch
    shape = (TRAIN_WORKERS, 3, 3, 512, 512)
    c = torch.randint(-7, 8, shape, generator=gen, device="cuda").to(torch.int8)
    got, want = pack_nibbles_triton(c), ref.pack_nibbles_ref(c)
    check(torch.equal(got, want), "pack_nibbles: bytes differ from the plain version")
    n = c.numel()
    b_ms, b_by = bound_ms(n + (n + 1) // 2, n * PACK_OPS, "f32")
    res = dict(
        max_abs_err=0,
        ms=cuda_ms(lambda: pack_nibbles_triton(c), 50),
        plain_ms=cuda_ms(lambda: ref.pack_nibbles_ref(c), 20),
        bound_ms=b_ms,
        bound_by=b_by,
        library_ms=None,
    )
    print(f"  pack_nibbles {shape}: bytes equal to the plain version")
    emit({"kernel": "pack_nibbles", "shape": list(shape), **res})
    results["pack_nibbles"] = res

    print("kernels at the SSM serving path's shapes")
    # ---- #7 ssd_chunk, f32, max abs error <= SSD_REL_TOL of max |Y|: one
    # prefill layer of mamba2-370m at (g1) 4 x 1024 and (g3) 1 x 8192 tokens
    cfg = get_config(SSM_ARCH)
    h, q = cfg.ssm_heads, cfg.ssm_chunk
    for run in ("g1", "g3"):
        batch, prompt = SSM_RUNS[run]
        x, a_cum, bm, cm = _ssd_inputs(gen, cfg, batch, prompt // q)
        got = ssd_chunk_cuda(x, a_cum, bm, cm)
        bh, ch = (t.expand(-1, h, -1, -1, -1) for t in (bm, cm))
        want = ref.ssd_chunk_ref(x, a_cum, bh, ch)
        err, top = float((got - want).abs().max()), float(want.abs().max())
        check(err <= SSD_REL_TOL * top, f"ssd_chunk ({run}): max err {err} of {top}")
        # the work the function needs over the causal pairs: S = C B^T once
        # per (batch, group, chunk), M X per (batch, head, chunk), in f32
        pairs = q * (q + 1) // 2
        groups = x.shape[0] * bm.shape[1] * x.shape[2]
        cells = x.shape[0] * h * x.shape[2]
        n_ops = pairs * (groups * 2 * cfg.ssm_state + cells * 2 * cfg.ssm_head_dim)
        n_bytes = 4 * (2 * x.numel() + bm.numel() + cm.numel() + a_cum.numel())
        b_ms, b_by = bound_ms(n_bytes, n_ops, "f32")
        per_head = cells * pairs * 2 * (cfg.ssm_state + cfg.ssm_head_dim)
        print(
            f"  ssd_chunk ({run}) work: {n_ops / 1e9:.3f} GFLOP with S once per "
            f"group ({per_head / 1e9:.3f} GFLOP if every head formed its own "
            f"S), {n_bytes / 1e6:.1f} MB"
        )
        res = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: ssd_chunk_cuda(x, a_cum, bm, cm), 10),
            plain_ms=cuda_ms(lambda: ref.ssd_chunk_ref(x, a_cum, bh, ch), 3),
            bound_ms=b_ms,
            bound_by=b_by,
            library_ms=None,
        )
        shape = list(x.shape)
        print(
            f"  ssd_chunk ({run}) x {shape}: max abs err {err:.2e}, "
            f"{err / top:.2e} of max |Y|; {res['ms']:.4f} ms, bound {b_ms:.4f} ms"
        )
        emit({"kernel": "ssd_chunk", "run": run, "shape": shape, **res})
        if run == "g1":
            results["ssd_chunk"] = res
    return results


def _ssd_inputs(gen, cfg, batch, nc):
    """One layer's ssd_chunk inputs at ``cfg``'s widths as the model hands
    them over: permuted views of x (B, NC, Q, H, P), a_cum and B/C per group
    (B, NC, Q, G, N). The per-step log-decay dt * A is drawn from [-1.6, 0],
    so a_cum falls to about -200 within a chunk of 256, as in the model."""
    q, h, g = cfg.ssm_chunk, cfg.ssm_heads, cfg.ssm_groups
    x = torch.randn((batch, nc, q, h, cfg.ssm_head_dim), generator=gen, device="cuda")
    a = -torch.rand((batch, nc, q, h), generator=gen, device="cuda") * 1.6
    bc = torch.randn((2, batch, nc, q, g, cfg.ssm_state), generator=gen, device="cuda")
    heads_first = (0, 3, 1, 2, 4)
    a_cum = torch.cumsum(a.permute(0, 3, 1, 2), dim=-1)
    bm, cm = (t.permute(heads_first) for t in bc)
    return x.permute(heads_first), a_cum, bm, cm


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
            if (variant, step) in (("a", "prefill"), ("b", "decode_step")):
                _kernel_split(
                    f"{step}_q{bits}", card, device_ms_by_kernel(fn), GEMMA_KERNELS
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


def _wire_codes(g, bits):
    """A gathered wire array as integer codes (b <= 4 unpacked)."""
    from repro_torch.core.codec import unpack_nibbles

    return unpack_nibbles(g, 2 * g.shape[-1]) if bits <= 4 else g.int()


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def resnet18_train_flops(hw, n_classes, images):
    """FLOPs of forward + backward of ResNet-18 over ``images`` images at
    hw x hw: the forward counted from the conv and head shapes (2 kh kw cin
    cout per output pixel), the backward as twice the forward."""
    size, cin = hw, 64
    fwd = 2 * 9 * 3 * 64 * size * size  # stem
    for cout, blocks, stride in ((64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)):
        for bi in range(blocks):
            s = stride if bi == 0 else 1
            size = -(-size // s)
            fwd += 2 * 9 * (cin + cout) * cout * size * size  # conv1, conv2
            if s != 1 or cin != cout:
                fwd += 2 * cin * cout * size * size  # 1x1 projection
            cin = cout
    fwd += 2 * 512 * n_classes
    return 3 * fwd * images


def phase_train(card):
    # the same init and batches give the same gradients in both modes
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    # TF32 on, as PyTorch leaves cuDNN's convolutions: the runs below must
    # hold the training entry point's own f32 setting, not phase_device's
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    was = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    try:
        return _train_runs(card)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = was


def _train_runs(card):
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.models.resnet import init_resnet18
    from repro_torch.train.data_parallel import mb_per_epoch, train_one

    runs = {
        "d": (
            CompressorConfig(name="lq_sgd", rank=1, bits=8),
            ("log_quantize", "log_dequantize"),
        ),
        "e": (
            CompressorConfig(name="lq_sgd", rank=1, bits=4),
            ("log_quantize_pack", "log_dequantize"),
        ),
        "f": (CompressorConfig(name="qsgd", bits=4), ("pack_nibbles",)),
    }
    total = {name: 0 for name in ops.KERNELS}
    init = tree_leaves(init_resnet18(TRAIN_CLASSES, seed=0, device="cuda"))

    flags = torch.backends.cudnn, torch.backends.cuda.matmul
    tf32_in_steps = []

    def run(cfg):
        return train_one(
            cfg,
            n_workers=TRAIN_WORKERS,
            batch=TRAIN_BATCH,
            hw=TRAIN_HW,
            n_classes=TRAIN_CLASSES,
            steps=TRAIN_STEPS,
            lr=TRAIN_LR,
            seed=0,
            device="cuda",
            record_wire=True,
            on_step=lambda step, res: tf32_in_steps.extend(
                f.allow_tf32 for f in flags
            ),
        )

    for variant, (cfg, need) in runs.items():
        tag = f"{cfg.name}_b{cfg.bits}" + ("_r1" if cfg.name == "lq_sgd" else "")
        label = f"({variant}) ResNet-18 {tag}, {TRAIN_WORKERS} workers x {TRAIN_BATCH}"
        with ops.reference_mode():
            want = run(cfg)
        ops.reset_launch_counts()
        out = run(cfg)
        counts = ops.launch_counts()
        print(f"{label}: launches {counts}")
        for name in need:
            check(counts[name] > 0, f"{label}: kernel {name} never launched")
        for name, c in counts.items():
            total[name] += c
        check(
            tf32_in_steps and not any(tf32_in_steps),
            f"{label}: a step ran with TF32 on",
        )
        check(all(f.allow_tf32 for f in flags), f"{label}: TF32 flags not restored")
        tf32_in_steps.clear()

        comp = out.comp
        n_raw = sum(pl.route != "lowrank" for pl in comp.plans)
        n_comp = len(comp.plans) - n_raw
        if cfg.name == "lq_sgd":  # a scale pmax + a gather per tensor per phase
            colls = 2 * 2 * n_comp + 2 * n_raw
        else:  # raw pmeans + a scale pmax and a gather per quantized tensor
            colls = n_raw + 2 * n_comp
        bits = comp.wire_bits_per_step()
        if variant == "d":
            check(bits == 370136, f"{label}: {bits} wire bits/step, not 370136")
        for st in out.steps + want.steps:
            check(st.rec.bits_sent == bits, f"{label}: sent {st.rec.bits_sent} bits")
            check(st.rec.n_collectives == colls, f"{label}: {st.rec.n_collectives}")
        losses = out.losses + want.losses
        check(all(math.isfinite(v) for v in losses), f"{label}: losses {losses}")

        with torch.no_grad():
            got_w, want_w = out.comm.gathered, want.comm.gathered
            check(len(got_w) == len(want_w), f"{label}: gathers differ in number")
            flips = n_codes = 0
            for g, w in zip(got_w, want_w):
                if cfg.name == "qsgd":
                    check(torch.equal(g, w), f"{label}: wire bytes differ")
                    continue
                d = (_wire_codes(g, cfg.bits) - _wire_codes(w, cfg.bits)).abs()
                check(int(d.max()) <= 1, f"{label}: a code moved more than one step")
                flips += int((d > 0).sum())
                n_codes += d.numel()
            check(flips <= 1e-3 * max(n_codes, 1), f"{label}: {flips} code flips")
            tol = 0.0 if cfg.name == "qsgd" else train_tol(cfg.bits, flips)
            grad_rel = param_rel = 0.0
            pairs = zip(tree_leaves(out.last_grads), tree_leaves(want.last_grads))
            for g, w in pairs:
                err, top = float((g - w).abs().max()), float(w.abs().max())
                check(err <= tol * top, f"{label}: synced grads differ by {err:.3e}")
                grad_rel = max(grad_rel, err / max(top, 1e-30))
            trios = zip(tree_leaves(out.params), tree_leaves(want.params), init)
            for p, w, p0 in trios:
                err, moved = float((p - w).abs().max()), float((w - p0).abs().max())
                check(err <= tol * moved, f"{label}: params differ by {err:.3e}")
                param_rel = max(param_rel, err / max(moved, 1e-30))

        steady = out.steps[1:]
        split = {
            "grad": _median([st.grad_ms for st in steady]),
            "sync": _median([st.sync_ms for st in steady]),
            "update": _median([st.update_ms for st in steady]),
        }
        mb = mb_per_epoch(comp, CIFAR_TRAIN_IMAGES, TRAIN_WORKERS * TRAIN_BATCH)
        flops = resnet18_train_flops(
            TRAIN_HW, TRAIN_CLASSES, TRAIN_WORKERS * TRAIN_BATCH
        )
        grad_tflops = flops / (split["grad"] * 1e-3) / 1e12
        print(
            f"  {label}: {bits} wire bits/step = {mb:.6f} MB/epoch, {colls} "
            f"collectives/step, step ms grad {split['grad']:.1f} "
            f"({flops / 1e12:.3f} TFLOP, {grad_tflops:.1f} TFLOP/s) sync "
            f"{split['sync']:.1f} update {split['update']:.1f}, losses "
            f"{[round(v, 4) for v in out.losses]}; vs reference mode: {flips} of "
            f"{n_codes} codes flipped, synced grads rel {grad_rel:.2e}, params rel "
            f"{param_rel:.2e}; {card}"
        )
        emit(
            {
                "train": f"{variant}_{tag}",
                "card": card,
                "mb_per_epoch": mb,
                "wire_bits_per_step": bits,
                "collectives_per_step": colls,
                "step_ms": split,
                "grad_tflop": flops / 1e12,
                "grad_tflop_per_s": grad_tflops,
                "losses": out.losses,
                "reference_losses": want.losses,
                "launches": counts,
                "code_flips": flips,
                "synced_grad_rel_err": grad_rel,
                "param_rel_err": param_rel,
            }
        )
    return total


def _greedy(cfg, params, logits, caches, prompt, n):
    """``n`` greedy tokens from a prefill's last-position logits and caches
    (decoded from them in place), and the top-2 logit gap of each step."""
    from repro_torch.serving.engine import build_decode_step, greedy_sample

    decode = build_decode_step(cfg)
    toks, gaps = [], []
    for i in range(n):
        if i:
            logits, caches = decode(params, caches, toks[-1], prompt + i - 1)
        top2 = logits[:, -1].float().topk(2, dim=-1).values
        gaps.append(top2[:, 0] - top2[:, 1])
        toks.append(greedy_sample(logits))
    return torch.cat(toks, dim=1), torch.stack(gaps, dim=1)


def kernel_groups(by_name, kernels):
    """Device ms of :func:`device_ms_by_kernel`'s kernels by group: each of
    ``kernels`` (group name -> a substring of its kernel's name, or a tuple
    of them), the matmuls (cuBLAS) and everything else."""
    groups = dict.fromkeys([*kernels, "matmul", "other"], 0.0)
    keys = {g: (k,) if isinstance(k, str) else k for g, k in kernels.items()}
    for name, (ms, _) in by_name.items():
        low = name.lower()
        mine = [group for group, ks in keys.items() if any(k in low for k in ks)]
        if mine:
            groups[mine[0]] += ms
        elif any(k in low for k in MATMUL_KERNELS):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    return groups


def _kernel_split(label, card, by_name, kernels):
    """Print and emit one step's device time by :func:`kernel_groups` and
    its eight longest kernels."""
    total = sum(ms for ms, _ in by_name.values())
    if not total:
        print(f"  {label}: device time by kernel not measured (no device events)")
        return
    groups = kernel_groups(by_name, kernels)
    n = sum(c for _, c in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    print(
        f"  {label}: {n} kernels, {total:.2f} ms of device time: "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in groups.items())
    )
    emit(
        {
            "profile": label,
            "card": card,
            "kernels": n,
            "device_ms": total,
            "groups_ms": groups,
            "top": [[name[:80], ms, c] for name, (ms, c) in top],
        }
    )


def phase_ssm(card):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import count_params, init_params
    from repro_torch.serving.engine import build_decode_step, build_prefill_step
    from repro_torch.serving.kv_cache import (
        CacheQuantConfig,
        tree_is_quantized,
        tree_leaves,
    )

    cfg = get_config(SSM_ARCH)
    total = {name: 0 for name in ops.KERNELS}
    # one prefill: ssd_chunk once per layer, no other kernel (no attention,
    # no KV leaf to quantize); a decode step launches none
    per_prefill = {**total, "ssd_chunk": cfg.n_layers}
    t0 = time.perf_counter()
    params = init_params(cfg, 1, "cuda")
    torch.cuda.synchronize()
    n_params = count_params(params)
    print(
        f"serve {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, d_inner "
        f"{cfg.d_inner}, {cfg.ssm_heads} heads of {cfg.ssm_head_dim}, state "
        f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}, {n_params} params in "
        f"{cfg.dtype}, init {time.perf_counter() - t0:.1f} s"
    )
    check(n_params == 368_338_432, f"{cfg.name}: {n_params} params")
    rng = np.random.default_rng(1)
    decode = build_decode_step(cfg)

    def main_run(tokens, qcfg, label):
        ops.reset_launch_counts()
        out = serve.run_fixed(cfg, params, tokens, gen=SSM_GEN, qcfg=qcfg)
        counts = ops.launch_counts()
        check(counts == per_prefill, f"{label}: launches {counts}")
        for name, c in counts.items():
            total[name] += c
        return out

    for run, (batch, prompt) in SSM_RUNS.items():
        label = f"({run}) {cfg.name} batch {batch} x prompt {prompt} + {SSM_GEN}"
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, prompt)))
        tokens = tokens.cuda()
        max_seq = prompt + SSM_GEN
        prefill = build_prefill_step(cfg, max_seq)

        # prefill, kernel path vs reference mode: logits and caches
        logits, caches = prefill(params, tokens)
        with ops.reference_mode():
            ref_logits, ref_caches = prefill(params, tokens)
        _logits_close(logits, ref_logits, label)
        worst = {}
        pairs = zip(tree_leaves(caches), tree_leaves(ref_caches), strict=True)
        for (path, g), (_, w) in pairs:
            g, w = g.float(), w.float()
            check(bool(torch.isfinite(g).all()), f"{label}: non-finite {path}")
            rel = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            check(rel <= SSM_CACHE_REL_TOL, f"{label}: cache {path} rel {rel:.3e}")
            worst[path[-1]] = max(worst.get(path[-1], 0.0), rel)
        print(f"  {label}: prefill caches vs reference mode, max rel {worst}")
        with ops.reference_mode():
            ref_toks, ref_gaps = _greedy(
                cfg, params, ref_logits, ref_caches, prompt, SSM_GEN
            )
        del caches, ref_caches

        # the main path: prefill + decode through the launcher's run_fixed
        out = main_run(tokens, None, label)
        toks = out["tokens"]
        check(tuple(toks.shape) == (batch, SSM_GEN), f"{label}: tokens {toks.shape}")
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), f"{label}: ids")
        check(bool(torch.isfinite(out["logits"]).all()), f"{label}: logits")
        same = toks == ref_toks
        note = ""
        if not bool(same.all()):
            row, step = (int(v) for v in (~same).nonzero()[0])
            gap = float(ref_gaps[row, step])
            note = (
                f"; first divergence at row {row} step {step}, where the "
                f"reference's top-2 logit gap is {gap:.4g}"
            )
        print(
            f"  {label}: greedy tokens equal to the reference-mode run in "
            f"{int(same.sum())} of {same.numel()}{note}"
        )
        leaves = list(tree_leaves(out["caches"]))
        n_bytes = sum(t.numel() * t.element_size() for _, t in leaves)
        bpt, acc = out["bytes_per_token"], out["bytes_per_token_accounted"]
        check(bpt == acc == n_bytes / (batch * max_seq), f"{label}: {bpt} vs {acc}")
        if run == "g1":
            check(bpt == SSM_G1_BYTES_PER_TOKEN, f"{label}: bytes/token {bpt}")
            q8 = main_run(tokens, CacheQuantConfig(bits=8), label + ", q8")
            check(not tree_is_quantized(q8["caches"]), f"{label}: q8 quantized")
            check(q8["bytes_per_token"] == bpt, f"{label}: q8 bytes/token")
            check(torch.equal(q8["tokens"], toks), f"{label}: q8 changed tokens")
            print(f"  {label}: --cache-bits 8 leaves the cache raw, tokens equal")
        print(
            f"  {label}: {bpt:.3f} bytes/token measured = accounted; prefill "
            f"{out['prefill_s'] * 1e3:.1f} ms, decode "
            f"{batch * (SSM_GEN - 1) / out['decode_s']:.1f} tokens/s; {card}"
        )

        # where the time goes: each step eager against a CUDA-graph replay
        caches, last = out["caches"], toks[:, -1:].contiguous()
        steps = {
            "prefill": lambda: prefill(params, tokens),
            "decode_step": lambda: decode(params, caches, last, max_seq - 1),
        }
        for step, fn in steps.items():
            h_ms, g_ms = host_ms(fn), cuda_ms(fn, 1)
            emit(
                {
                    "split": f"mamba_{step}_{run}",
                    "card": card,
                    "host_ms": h_ms,
                    "graph_ms": g_ms,
                    "idle_share": 1 - g_ms / h_ms,
                }
            )
            if run == "g1":
                _kernel_split(
                    f"mamba_{step}_{run}",
                    card,
                    device_ms_by_kernel(fn),
                    {"ssd_chunk": "ssd_chunk"},
                )
        emit(
            {
                "serve": f"mamba_{run}",
                "card": card,
                "prefill_ms": out["prefill_s"] * 1e3,
                "decode_tokens_per_s": batch * (SSM_GEN - 1) / out["decode_s"],
                "bytes_per_token": bpt,
                "bytes_per_token_accounted": acc,
                "tokens_equal_reference": int(same.sum()),
                "tokens": same.numel(),
            }
        )
        del out, caches
    return total


def _tf32_flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


class _SyncRecorder:
    """A compressor whose one-worker syncs are kept in ``log``: each call's
    synced gradient, ``CommRecord``, gathered wire and TF32 flags."""

    def __init__(self, inner, log):
        self.inner, self.log = inner, log

    def init_state(self, seed, n_workers, device):
        return self.inner.init_state(seed, n_workers, device)

    def sync_once(self, grads, state, *, comm=None):
        from repro_torch.core.comm import SimComm

        comm = SimComm(1, record=True)
        out, new_state, rec = self.inner.sync_once(grads, state, comm=comm)
        bits = self.inner.wire_bits_per_step()
        self.log.append(
            dict(out=out, rec=rec, bits=bits, wire=comm.gathered, tf32=_tf32_flags())
        )
        return out, new_state, rec


def _recorded_victim(model, logs, flags):
    """``gia_ssim.setup(model)`` with every compressed method's syncs kept in
    ``logs[method]`` and the TF32 flags of every gradient call in ``flags``."""
    from repro_torch.bench import gia_ssim
    from repro_torch.core.compressors import make_compressor

    victim = gia_ssim.setup(model, "cuda")
    inner_grad = victim["grad_fn"]

    def grad_fn(p, x, y):
        flags.append(_tf32_flags())
        return inner_grad(p, x, y)

    def recorded(cfg, log):
        return lambda abstract: _SyncRecorder(make_compressor(cfg, abstract), log)

    methods = {}
    for name, cfg in victim["methods"].items():
        if cfg is not None:
            logs[name] = []
            cfg = recorded(cfg, logs[name])
        methods[name] = cfg
    return {**victim, "grad_fn": grad_fn, "methods": methods}


def phase_gia(card):
    # the same init, generators and cuDNN algorithms give the same attack
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    # TF32 on, as PyTorch leaves cuDNN's convolutions: the harness must hold
    # its own f32 setting
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    was = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    try:
        return _gia_runs(card)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = was


def _check_victim_steps(label, comp_cfgs, logs, ref_logs):
    """Every compressed method's victim syncs against reference mode's."""
    from repro_torch.core.tree import tree_leaves

    for name, log in logs.items():
        want_log, cfg = ref_logs[name], comp_cfgs[name]
        check(len(log) == len(want_log) > 0, f"{label} {name}: {len(log)} syncs")
        bits = log[0]["bits"]
        flips = n_codes = 0
        grad_rel = 0.0
        for step, (got, want) in enumerate(zip(log, want_log)):
            at = f"{label} {name} step {step}"
            for rec in (got["rec"], want["rec"]):
                check(rec.bits_sent == bits, f"{at}: sent {rec.bits_sent} of {bits}")
            check(not any(got["tf32"]), f"{at}: a sync ran with TF32 on")
            check(len(got["wire"]) == len(want["wire"]), f"{at}: gathers differ")
            step_flips = 0
            for g, w in zip(got["wire"], want["wire"]):
                if g.dtype == torch.float32 or cfg.name != "lq_sgd":
                    check(torch.equal(g, w), f"{at}: wire differs")
                    continue
                d = (_wire_codes(g, cfg.bits) - _wire_codes(w, cfg.bits)).abs()
                check(int(d.max()) <= 1, f"{at}: a code moved more than one step")
                step_flips += int((d > 0).sum())
                n_codes += d.numel()
            flips += step_flips
            tol = train_tol(cfg.bits, step_flips, workers=1)
            pairs = zip(tree_leaves(got["out"]), tree_leaves(want["out"]), strict=True)
            for g, w in pairs:
                err, top = float((g - w).abs().max()), float(w.abs().max())
                check(err <= tol * top, f"{at}: synced grads differ by {err:.3e}")
                grad_rel = max(grad_rel, err / max(top, 1e-30))
        check(flips <= 1e-3 * max(n_codes, 1), f"{label} {name}: {flips} code flips")
        print(
            f"  {label} {name}: {len(log)} victim steps equal to reference mode: "
            f"{bits} wire bits each, {flips} of {n_codes} codes flipped, synced "
            f"grads rel {grad_rel:.2e}"
        )


def _attack_step_split(label, card, victim, cfg, model):
    """One batched attack step (every restart) of ``victim``: its host time,
    a CUDA-graph replay's time, and (ResNet-18) torch.profiler's split of
    its device time."""
    from repro_torch.core.privacy.gia import make_attack_step
    from repro_torch.train.data_parallel import _tf32_off

    params, x, y = victim["params"], victim["x"], victim["y"]
    g_obs = victim["grad_fn"](params, x, y)
    step = make_attack_step(victim["grad_fn"], params, g_obs, y, cfg.gia)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (cfg.n_attack_seeds,) + tuple(x.shape)
    xs = torch.randn(shape, generator=gen, device="cuda")
    m, v = torch.zeros_like(xs), torch.zeros_like(xs)
    with _tf32_off():
        h_ms = host_ms(lambda: step(xs, m, v, 0), repeats=5)
        g_ms = cuda_ms(lambda: step(xs, m, v, 0), 1)
        by_name = device_ms_by_kernel(lambda: step(xs, m, v, 0))
    n_kernels = sum(c for _, c in by_name.values())
    print(
        f"  ({label}) {model} attack step, {cfg.n_attack_seeds} restarts batched: "
        f"{h_ms:.3f} ms on the host clock, graph replay {g_ms:.3f} ms, idle "
        f"{1 - g_ms / h_ms:.1%}, {n_kernels} kernels; {card}"
    )
    emit(
        {
            "split": f"gia_attack_step_{label}",
            "card": card,
            "host_ms": h_ms,
            "graph_ms": g_ms,
            "idle_share": 1 - g_ms / h_ms,
        }
    )
    if model == "resnet18":
        _kernel_split(f"gia_attack_step_{label}", card, by_name, {"conv": CONV_KERNELS})


def _gia_ordering(label, card, cfg):
    """(h1)'s steady-state claim, SGD leaks at least as much as LQ-SGD r1,
    on the mean best of ``GIA_ORDER_GROUP`` restarts over
    ``GIA_ORDER_RESTARTS`` restarts."""
    import dataclasses
    import statistics

    from repro_torch.bench import gia_ssim

    victim = gia_ssim.setup("cnn", "cuda")
    methods = ("sgd", "lq_sgd_r1")
    victim["methods"] = {m: victim["methods"][m] for m in methods}
    steady = max(cfg.attack_steps)
    many = dataclasses.replace(
        cfg, attack_steps=(steady,), n_attack_seeds=GIA_ORDER_RESTARTS
    )
    t0 = time.perf_counter()
    rows, _ = gia_ssim.bench(model="cnn", cfg=many, victim=victim)
    k = GIA_ORDER_GROUP
    best = {}
    for r in rows:
        s = r["seed_ssims"]
        best[r["method"]] = [max(s[i : i + k]) for i in range(0, len(s), k)]
    mean = {m: statistics.fmean(best[m]) for m in methods}
    diffs = [a - b for a, b in zip(best["sgd"], best["lq_sgd_r1"], strict=True)]
    se = statistics.stdev(diffs) / math.sqrt(len(diffs))
    wins = sum(d >= 0 for d in diffs)
    print(
        f"  {label}: steady state over {len(diffs)} groups of {k} restarts: mean "
        f"best-of-{k} ssim sgd {mean['sgd']:.4f}, lq_sgd_r1 {mean['lq_sgd_r1']:.4f} "
        f"(difference {statistics.fmean(diffs):.4f} +- {se:.4f} s.e.; sgd >= "
        f"lq_sgd_r1 in {wins} of {len(diffs)} groups), {time.perf_counter() - t0:.1f} "
        f"s; {card}"
    )
    check(mean["sgd"] >= mean["lq_sgd_r1"], f"{label}: LQ-SGD leaks more than SGD")
    emit(
        {
            "gia_ordering": "h1",
            "card": card,
            "restarts": GIA_ORDER_RESTARTS,
            "group": k,
            "mean_best": mean,
            "difference_se": se,
            "groups_sgd_ge_lq": wins,
        }
    )


def _gia_runs(card):
    import dataclasses

    from repro_torch.bench import gia_ssim
    from repro_torch.kernels import ops

    need = {
        "lq_sgd_r4": ("log_quantize", "log_dequantize"),
        "lq_sgd_r1": ("log_quantize", "log_dequantize"),
        "lq_sgd_r1_b4": ("log_quantize_pack", "log_dequantize"),
    }
    total = {name: 0 for name in ops.KERNELS}
    cfg = gia_ssim.harness_config(quick=False)
    for run, model in GIA_RUNS.items():
        t0 = time.perf_counter()
        label = f"({run}) GIA {model}"
        comp_cfgs = gia_ssim.setup(model, "cuda")["methods"]
        # the victim's trajectory in reference mode, no attack
        ref_logs, ref_flags = {}, []
        victim = _recorded_victim(model, ref_logs, ref_flags)
        with ops.reference_mode():
            gia_ssim.bench(
                model=model,
                device="cuda",
                cfg=dataclasses.replace(cfg, attack_steps=()),
                victim=victim,
            )
        # the main path: the sweep as the entry point runs it
        logs, flags = {}, []
        victim = _recorded_victim(model, logs, flags)
        ops.reset_launch_counts()
        rows, _ = gia_ssim.bench(model=model, device="cuda", victim=victim)
        counts = ops.launch_counts()
        seconds = time.perf_counter() - t0
        print(f"{label}: {len(victim['methods'])} methods, launches {counts}")
        for name in {k for m in victim["methods"] for k in need.get(m, ())}:
            check(counts[name] > 0, f"{label}: kernel {name} never launched")
        for name, c in counts.items():
            total[name] += c
        check(flags and not any(any(f) for f in flags), f"{label}: TF32 was on")
        check(all(_tf32_flags()), f"{label}: TF32 flags not restored")
        _check_victim_steps(label, comp_cfgs, logs, ref_logs)

        by = {(r["method"], r["phase"]): r for r in rows}
        for r in rows:
            finite = math.isfinite(r["ssim"]) and math.isfinite(r["psnr"])
            check(finite, f"{label}: {r['method']} {r['phase']}: not finite")
            print(
                f"  {label} {r['method']:>13} {r['phase']:>12}: ssim {r['ssim']:.4f} "
                f"psnr {r['psnr']:.2f} attack {r['attack_seconds']:.2f} s"
            )
        steady, cold = by[("sgd", "steady_state")], by[("sgd", "cold_start")]
        lq = by[("lq_sgd_r1", "steady_state")]
        order = ">=" if steady["ssim"] >= lq["ssim"] else "<"
        print(
            f"  {label}: steady state ssim sgd {steady['ssim']:.4f}, lq_sgd_r1 "
            f"{lq['ssim']:.4f} (SGD {order} LQ-SGD r1); cold start sgd "
            f"{cold['ssim']:.4f}; phase {seconds:.1f} s; {card}"
        )
        if run == "h1":
            check(cold["ssim"] > GIA_COLD_SSIM_MIN, f"{label}: cold-start SGD ssim")
            _gia_ordering(label, card, cfg)
        table = [{k: v for k, v in r.items() if k != "seed_ssims"} for r in rows]
        emit(
            {
                "gia": run,
                "model": model,
                "card": card,
                "seconds": seconds,
                "rows": table,
            }
        )
        _attack_step_split(run, card, gia_ssim.setup(model, "cuda"), cfg, model)
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
        "cuda",
        "src/repro_torch/csrc/log_dequant_rows.cu",
        "src/repro/kernels/log_quant.py:215",
    ),
    "flash_attention": (
        "cuda",
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:75",
    ),
    "pack_nibbles": (
        "triton",
        "src/repro_torch/kernels/log_quant.py",
        "src/repro/kernels/log_quant.py:99",
    ),
    "log_dequantize": (
        "triton",
        "src/repro_torch/kernels/log_quant.py",
        "src/repro/kernels/log_quant.py:258",
    ),
    "ssd_chunk": (
        "cuda",
        "src/repro_torch/csrc/ssd_chunk.cu",
        "src/repro/kernels/ssd_chunk.py:45",
    ),
}


def main():
    card = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    measured = phase_kernels(gen)
    launches = phase_serve(card, gen)
    for phase in (phase_train, phase_ssm, phase_gia):
        for name, c in phase(card).items():
            launches[name] += c
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
