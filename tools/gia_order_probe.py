"""Why (h2)'s graphed attack stops equalling the eager one after other work.

    python tools/gia_order_probe.py [--steps 40] [--out chiprun_out/gia_order_probe]

Runs the (sgd, cold start) attack of ``chip_smoke.py``'s (h2) on the
full-width ResNet-18 (``bench/gia_ssim.setup("resnet18")``, 8 restarts),
graphed and with ``graph=False``, in one fresh process per condition:

* ``clean``: nothing before the attack;
* ``dirty``: phase (i)'s kind of work first, two ResNet-18 training steps
  of 5 workers x 128 images at 32x32 with LQ-SGD r1 b8;
* ``dirty_empty``: the same, then ``torch.cuda.empty_cache()``;
* ``big_block``: one 24 GB tensor allocated and freed first, so the caching
  allocator holds one large free block and nothing else has run;
* ``poison``: 24 GB of 1 GB blocks filled with NaN and freed first, so a
  read of memory nothing wrote would show;
* ``smoke_prefix``: ``chip_smoke.py``'s phases in the order in which its
  (h2) check fails (device, build, kernels, serving, training, Mamba-2,
  the composite, then (h1)'s GIA sweep), then the attack as in the
  others, once more after ``torch.cuda.empty_cache()``;
* ``nan_fill``: deterministic algorithms on (warn only), which fill every
  tensor ATen allocates without writing with NaN: an attack that reads
  such memory turns NaN;
* ``smoke_gia``: the prefix of ``smoke_prefix`` and then ``chip_smoke.py``'s
  whole phase (h), (h2) included (its check's failure is printed, not
  raised), then the attack again graphed and eager, with NaN fill, and the
  kernels of the eager step against those of the replayed one;
* ``smoke_gia_steps``: the same prefix and phase (h), then the (h2) attack
  at its full 300 steps, step by step, eager and as replays, each step's
  losses kept: the first step where the two differ;
* ``smoke_h``: the prefix and phase (h) alone (run it with
  ``TORCH_CUDNN_V8_API_DEBUG=1`` to see every cuDNN plan that failed);
* ``stream_sweep``: the prefix and phase (h), then the attack's 40 steps
  graphed with the warm-up step on each of the 32 pool streams in turn,
  each against the eager attack: which streams give another x̂, and
  whether one of them is the graphs' capture stream.

Each condition prints whether its graphed x̂ and losses equal its eager
ones, and the parent prints which conditions equal ``clean``. Each also
records the device kernels of one eager attack step and of one replay of
the captured step (torch.profiler), so a different algorithm shows as a
different kernel list. Needs a CUDA card; cuDNN deterministic, benchmark
off, TF32 off, as ``chip_smoke.py`` runs it.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

CONDITIONS = (
    "clean",
    "dirty",
    "dirty_empty",
    "big_block",
    "poison",
    "smoke_prefix",
    "nan_fill",
    "smoke_gia",
    "smoke_gia_steps",
    "smoke_h",
    "stream_sweep",
)


def _kernels(fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def _dirty():
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.train.data_parallel import train_one

    cfg = CompressorConfig(name="lq_sgd", rank=1, bits=8)
    train_one(cfg, n_workers=5, batch=128, hw=32, steps=2, device="cuda")


def _smoke_prefix(with_h2=False):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    card = cs.phase_device()
    cs.phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cs.phase_kernels(gen)
    cs.phase_serve(card, gen)
    for phase in (cs.phase_train, cs.phase_ssm, cs.phase_composite):
        phase(card)
    if not with_h2:
        cs.GIA_RUNS = {"h1": "cnn"}
    try:
        cs.phase_gia(card)
    except cs.SmokeFailure as e:
        print(f"phase (h) failed: {e}", flush=True)


def _steps_diverge():
    """The (h2) (sgd, cold start) attack, 300 steps eager and 300 replays,
    every step's losses kept: where they first differ, twice over."""
    from repro_torch import graphs
    from repro_torch.bench import gia_ssim
    from repro_torch.core.privacy.gia import make_attack_step
    from repro_torch.core.privacy.harness import _restart_keys
    from repro_torch.train.data_parallel import _tf32_off

    cfg = gia_ssim.harness_config(quick=False)
    victim = gia_ssim.setup("resnet18", "cuda")
    params, x, y, grad_fn = (victim[k] for k in ("params", "x", "y", "grad_fn"))
    with _tf32_off():
        g_obs = grad_fn(params, x, y)
        step = make_attack_step(grad_fn, params, g_obs, y, cfg.gia)

        def start():
            keys = _restart_keys(cfg.seed, 0, cfg.n_attack_seeds, "cuda")
            scale = cfg.gia.init_scale
            xs = torch.stack(
                [scale * torch.randn(x.shape, generator=k, device="cuda") for k in keys]
            )
            t = torch.zeros((), device="cuda")
            return xs, torch.zeros_like(xs), torch.zeros_like(xs), t

        for trial in range(2):
            xs, m, v, t = start()
            eager = [step(xs, m, v, t).clone() for _ in range(cfg.gia.steps)]
            ex = xs.clone()
            xs, m, v, t = start()
            losses = torch.zeros(cfg.n_attack_seeds, device="cuda")

            def one():
                losses.copy_(step(xs, m, v, t))

            sg = graphs.StepGraph(one, "cuda")
            graphed = []
            for _ in range(cfg.gia.steps):
                sg.run(1)
                graphed.append(losses.clone())
            pairs = enumerate(zip(eager, graphed))
            first = next((i for i, (a, b) in pairs if not torch.equal(a, b)), None)
            print(
                f"smoke_gia_steps trial {trial}: x-hat equal {torch.equal(xs, ex)}; "
                f"first step whose losses differ: {first}",
                flush=True,
            )


def _stream_sweep(steps):
    import dataclasses

    from repro_torch import graphs
    from repro_torch.bench import gia_ssim
    from repro_torch.core.privacy import invert_gradients_batched
    from repro_torch.core.privacy.harness import _restart_keys
    from repro_torch.train.data_parallel import _tf32_off

    cfg = gia_ssim.harness_config(quick=False)
    gia = dataclasses.replace(cfg.gia, steps=steps)
    victim = gia_ssim.setup("resnet18", "cuda")
    params, x, y, grad_fn = (victim[k] for k in ("params", "x", "y", "grad_fn"))
    with _tf32_off():
        g_obs = grad_fn(params, x, y)

    def attack(graph):
        keys = _restart_keys(cfg.seed, 0, cfg.n_attack_seeds, "cuda")
        return invert_gradients_batched(
            grad_fn, params, g_obs, tuple(x.shape), y, keys, gia, graph=graph
        )[0]

    eager = attack(False)
    capture = torch.cuda.graphs.graph.default_capture_stream
    warm_up = graphs.StepGraph._warm_up
    bad = []
    for k in range(32):
        side = torch.cuda.Stream()

        def on_side(self, side=side):
            current = torch.cuda.current_stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                self.step()
            current.wait_stream(side)

        graphs.StepGraph._warm_up = on_side
        try:
            same = torch.equal(attack(None), eager)
        finally:
            graphs.StepGraph._warm_up = warm_up
        is_capture = capture is not None and side.cuda_stream == capture.cuda_stream
        if not same:
            bad.append(k)
        print(
            f"stream_sweep: pool stream {k} (0x{side.cuda_stream:x}"
            f"{', the capture stream' if is_capture else ''}): graph == eager {same}",
            flush=True,
        )
    print(f"stream_sweep: streams whose warm-up gave another x-hat: {bad}", flush=True)


def _fill(n_blocks, value):
    blocks = [torch.full((1 << 28,), value, device="cuda") for _ in range(n_blocks)]
    torch.cuda.synchronize()
    del blocks


def run_condition(name, steps, out):
    import dataclasses

    from repro_torch import graphs
    from repro_torch.bench import gia_ssim
    from repro_torch.core.privacy import invert_gradients_batched
    from repro_torch.core.privacy.gia import make_attack_step
    from repro_torch.core.privacy.harness import _restart_keys
    from repro_torch.train.data_parallel import _tf32_off

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    if name in ("dirty", "dirty_empty"):
        _dirty()
    if name == "dirty_empty":
        torch.cuda.empty_cache()
    if name == "big_block":
        big = torch.empty(6 << 30, dtype=torch.float32, device="cuda")
        del big
    if name == "poison":
        _fill(24, float("nan"))
    smoke = ("smoke_prefix", "smoke_gia", "smoke_gia_steps", "smoke_h", "stream_sweep")
    if name in smoke:
        _smoke_prefix(with_h2=name != "smoke_prefix")
    if name == "smoke_h":
        return
    if name == "stream_sweep":
        _stream_sweep(steps)
        return
    if name == "smoke_gia_steps":
        _steps_diverge()
        return
    if name == "nan_fill":
        torch.use_deterministic_algorithms(True, warn_only=True)
    cfg = gia_ssim.harness_config(quick=False)
    gia = dataclasses.replace(cfg.gia, steps=steps)
    victim = gia_ssim.setup("resnet18", "cuda")
    params, x, y, grad_fn = (victim[k] for k in ("params", "x", "y", "grad_fn"))
    with _tf32_off():
        g_obs = grad_fn(params, x, y)
    res = {}
    for graph in (None, False):
        keys = _restart_keys(cfg.seed, 0, cfg.n_attack_seeds, "cuda")
        res[graph] = invert_gradients_batched(
            grad_fn, params, g_obs, tuple(x.shape), y, keys, gia, graph=graph
        )
    (gx, gl), (ex, el) = res[None], res[False]
    if name == "smoke_gia":
        for label, graph in (("eager again", False), ("graphed again", None)):
            keys = _restart_keys(cfg.seed, 0, cfg.n_attack_seeds, "cuda")
            ax, _ = invert_gradients_batched(
                grad_fn, params, g_obs, tuple(x.shape), y, keys, gia, graph=graph
            )
            print(
                f"{name}: {label}: == first graph {torch.equal(ax, gx)}, == "
                f"first eager {torch.equal(ax, ex)}",
                flush=True,
            )
        torch.use_deterministic_algorithms(True, warn_only=True)
        for label, graph in (("NaN fill eager", False), ("NaN fill graphed", None)):
            keys = _restart_keys(cfg.seed, 0, cfg.n_attack_seeds, "cuda")
            ax, _ = invert_gradients_batched(
                grad_fn, params, g_obs, tuple(x.shape), y, keys, gia, graph=graph
            )
            print(
                f"{name}: {label}: nan {bool(ax.isnan().any())}, == first graph "
                f"{torch.equal(ax, gx)}, == first eager {torch.equal(ax, ex)}",
                flush=True,
            )
        torch.use_deterministic_algorithms(False)
    if name == "smoke_prefix":
        torch.cuda.empty_cache()
        keys = _restart_keys(cfg.seed, 0, cfg.n_attack_seeds, "cuda")
        ax, al = invert_gradients_batched(
            grad_fn, params, g_obs, tuple(x.shape), y, keys, gia, graph=None
        )
        print(
            f"{name}: after empty_cache, graph == first graph x-hat "
            f"{torch.equal(ax, gx)}, == eager {torch.equal(ax, ex)}",
            flush=True,
        )
    # the kernels of one eager step and of one replay of the captured step
    step = make_attack_step(grad_fn, params, g_obs, y, gia)
    xs = torch.randn((cfg.n_attack_seeds,) + tuple(x.shape), device="cuda")
    m, v, t = torch.zeros_like(xs), torch.zeros_like(xs), torch.zeros((), device="cuda")
    with _tf32_off():
        eager_k = _kernels(lambda: step(xs, m, v, t))
        sg = graphs.StepGraph(lambda: step(xs, m, v, t), "cuda")
        sg.run(2)
        graph_k = _kernels(lambda: sg.run(1))
    out.mkdir(parents=True, exist_ok=True)
    torch.save(
        {"gx": gx.cpu(), "gl": gl.cpu(), "ex": ex.cpu(), "el": el.cpu()},
        out / f"{name}.pt",
    )
    print(
        f"{name}: eager step against the replayed one, kernels launched "
        f"another number of times: {_multiset_diff(eager_k, graph_k)}",
        flush=True,
    )
    (out / f"{name}_kernels.json").write_text(
        json.dumps({"eager": eager_k, "graph": graph_k}, indent=0)
    )
    print(
        f"{name}: graph == eager x-hat {torch.equal(gx, ex)}, losses "
        f"{torch.equal(gl, el)}; nan in x-hat {bool(gx.isnan().any())}; "
        f"{len(eager_k)} eager / {len(graph_k)} replayed kernels, the same "
        f"list {eager_k == graph_k}; largest cached free block after: "
        f"{_largest_free() / 2**20:.0f} MiB",
        flush=True,
    )


def _multiset_diff(a, b):
    """Kernel names whose launch counts differ: {name: (count in a, in b)}."""
    from collections import Counter

    ca, cb = Counter(a), Counter(b)
    return {k: (ca[k], cb[k]) for k in sorted(set(ca) | set(cb)) if ca[k] != cb[k]}


def _largest_free():
    segs = torch.cuda.memory_snapshot()
    free = [b["size"] for s in segs for b in s["blocks"] if b["state"] == "inactive"]
    return max(free, default=0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--out", default="chiprun_out/gia_order_probe")
    ap.add_argument("--condition", default=None, choices=CONDITIONS)
    ap.add_argument("--only", nargs="*", default=None, choices=CONDITIONS)
    args = ap.parse_args()
    out = Path(args.out)
    if args.condition:
        run_condition(args.condition, args.steps, out)
        return
    if not torch.cuda.is_available():
        raise SystemExit("gia_order_probe: needs a CUDA card")
    names = args.only or CONDITIONS
    for name in names:
        cmd = [sys.executable, __file__, "--condition", name, "--steps"]
        subprocess.run(cmd + [str(args.steps), "--out", args.out], check=True)
    if not (out / "clean.pt").exists():
        return
    base = torch.load(out / "clean.pt")
    base_k = json.loads((out / "clean_kernels.json").read_text())
    for name in [n for n in names if (out / f"{n}.pt").exists() and n != "clean"]:
        got = torch.load(out / f"{name}.pt")
        same = {k: torch.equal(got[k], base[k]) for k in base}
        kern = json.loads((out / f"{name}_kernels.json").read_text())
        diff = _multiset_diff(kern["eager"], base_k["eager"])
        gdiff = _multiset_diff(kern["graph"], base_k["graph"])
        print(f"{name} vs clean: equal {same}")
        print(f"  eager kernels launched another number of times: {diff}")
        print(f"  replayed kernels launched another number of times: {gdiff}")
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
