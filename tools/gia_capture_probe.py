"""Why (h2)'s first graphed attack after other work differed from the eager one.

    python tools/gia_capture_probe.py [--only NAME ...]

A sequel to ``tools/gia_order_probe.py``. ``repeat`` and ``ops`` each run
in a fresh process: ``chip_smoke.py``'s phases in the order in which its
(h2) check failed (device, build, kernels, serving, training, Mamba-2, the
composite, then phase (h), (h1) and (h2)), with (h2)'s graph = eager pair
(the (sgd, cold start) attack on the full-width ResNet-18, 300 steps of 8
restarts) replaced by an extended one:

* ``repeat``: the pair extended to graphed, eager, eager, graphed: which
  of the four agree;
* ``ops``: graphed, eager, graphed, every op of each graph's warm-up and
  capture logged under a dispatch mode (its tensor operands' sizes, memory
  format, pointer alignment and strides): where the first graph's capture
  met its operands otherwise than the second's. An order that differs
  with the same ops is the autograd engine's (sequence numbers, counted
  per thread);
* ``shift``: ``tests/test_torch_cuda.py``'s card test of the repair (the
  attack with either thread's autograd counter ahead), with the attack's
  backward on the calling thread (``core/privacy/gia.py``) and, as the
  control, on the engine's threads: it must pass, and the control fail.

Needs a CUDA card; cuDNN deterministic, benchmark off, TF32 off, as
``chip_smoke.py`` runs phase (h).
"""

import argparse
import contextlib
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _tensor_key(t):
    """What cuDNN's plan cache keys an operand on (sizes, memory format, the
    pointer's alignment up to 32 bytes) and its strides, which the plan's
    descriptors take but the key does not."""
    try:
        ptr = t.data_ptr()
    except RuntimeError:  # a wrapper tensor: no storage at this level
        return (tuple(t.shape), "wrapper")
    align = 1
    while align < 32 and ptr % (2 * align) == 0:
        align *= 2
    from torch._prims_common import suggest_memory_format

    fmt = str(suggest_memory_format(t)).replace("torch.", "")
    return (tuple(t.shape), fmt, align, tuple(t.stride()))


def _repeat_pair(label, card, model, cfg, row):
    """(h2)'s pair as chip_smoke runs it, then once more in the other
    order: graphed, eager, eager, graphed."""
    from repro_torch.bench import gia_ssim
    from repro_torch.core.privacy import invert_gradients_batched
    from repro_torch.core.privacy.harness import _restart_keys
    from repro_torch.train.data_parallel import _tf32_off

    victim = gia_ssim.setup(model, "cuda")
    params, x, y, grad_fn = (victim[k] for k in ("params", "x", "y", "grad_fn"))
    with _tf32_off():
        g_obs = grad_fn(params, x, y)
    xs = []
    for graph in (None, False, False, None):
        keys = _restart_keys(cfg.seed, 0, cfg.n_attack_seeds, "cuda")
        xs.append(
            invert_gradients_batched(
                grad_fn, params, g_obs, tuple(x.shape), y, keys, cfg.gia, graph=graph
            )[0]
        )
    names = ("graph1", "eager1", "eager2", "graph2")
    same = {
        f"{names[i]}={names[j]}": torch.equal(xs[i], xs[j])
        for i in range(4)
        for j in range(i + 1, 4)
    }
    print(f"repeat ({label}) {model}: {same}; {card}", flush=True)


def _op_log_mode():
    """Every op with its tensor operands' keys, in call order."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpLog(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            operands = list(args) + list((kwargs or {}).values())
            tensors = [a for a in operands if isinstance(a, torch.Tensor)]
            keys = tuple(_tensor_key(a) for a in tensors)
            self.calls.append((str(func), keys))
            return func(*args, **(kwargs or {}))

    return OpLog()


def _ops_pair(label, card, model, cfg, row):
    """Graphed, eager, graphed, the ops of each graph's warm-up and capture
    logged: the positions where the two graphs' logs differ."""
    from repro_torch.bench import gia_ssim
    from repro_torch.core.privacy import invert_gradients_batched
    from repro_torch.core.privacy.harness import _restart_keys
    from repro_torch.train.data_parallel import _tf32_off

    victim = gia_ssim.setup(model, "cuda")
    params, x, y, grad_fn = (victim[k] for k in ("params", "x", "y", "grad_fn"))
    with _tf32_off():
        g_obs = grad_fn(params, x, y)
    xs, logs = [], []
    for graph in (None, False, None):
        keys = _restart_keys(cfg.seed, 0, cfg.n_attack_seeds, "cuda")
        if graph is None:
            with _op_log_mode() as log:
                out = invert_gradients_batched(
                    grad_fn, params, g_obs, tuple(x.shape), y, keys, cfg.gia
                )
            logs.append(log.calls)
        else:
            out = invert_gradients_batched(
                grad_fn, params, g_obs, tuple(x.shape), y, keys, cfg.gia, graph=False
            )
        xs.append(out[0])
    a, b = logs
    diff = [i for i, (p, q) in enumerate(zip(a, b)) if p != q]
    print(
        f"ops ({label}) {model}: graph1 == eager {torch.equal(xs[0], xs[1])}, "
        f"graph2 == eager {torch.equal(xs[2], xs[1])}; {len(a)} / {len(b)} ops "
        f"logged (warm-up and capture); {len(diff)} positions differ; {card}",
        flush=True,
    )
    for i in diff[:40]:
        print(f"  {i} graph1 {a[i]}", flush=True)
        print(f"  {i} graph2 {b[i]}", flush=True)


def _prefix(pair_by=None):
    """chip_smoke's phases up to and with (h), its (h2) pair run by
    ``pair_by`` (chip_smoke's own where None); a failed check is printed."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    if pair_by is not None:
        pair = cs._attack_graph_vs_eager

        def logged(label, card, model, cfg, row):
            if model == "resnet18":
                return pair_by(label, card, model, cfg, row)
            return pair(label, card, model, cfg, row)

        cs._attack_graph_vs_eager = logged
    card = cs.phase_device()
    cs.phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cs.phase_kernels(gen)
    cs.phase_serve(card, gen)
    for phase in (cs.phase_train, cs.phase_ssm, cs.phase_composite, cs.phase_gia):
        try:
            phase(card)
        except cs.SmokeFailure as e:
            print(f"phase {phase.__name__} failed: {e}", flush=True)


def _shift():
    """The card test of the repair, pinned and (the control) unpinned."""
    import pytest

    test = ROOT / "tests" / "test_torch_cuda.py"
    name = "test_graphed_attack_equals_eager_whatever_autograd_ran_before"
    pin = torch.autograd.set_multithreading_enabled
    for pinned in (True, False):
        if not pinned:
            torch.autograd.set_multithreading_enabled = (
                lambda mode: contextlib.nullcontext()
            )
        rc = pytest.main(["-q", "-p", "no:cacheprovider", f"{test}::{name}"])
        torch.autograd.set_multithreading_enabled = pin
        print(f"shift: one-thread backward {pinned}: pytest exit code {rc}", flush=True)


PAIRS = {"repeat": _repeat_pair, "ops": _ops_pair}
CONDITIONS = tuple(PAIRS) + ("shift",)


def run_condition(name):
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    if name == "shift":
        _shift()
        return
    _prefix(PAIRS[name])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--condition", default=None, choices=CONDITIONS)
    ap.add_argument("--only", nargs="*", default=None, choices=CONDITIONS)
    args = ap.parse_args()
    if args.condition:
        run_condition(args.condition)
        return
    if not torch.cuda.is_available():
        raise SystemExit("gia_capture_probe: needs a CUDA card")
    for name in args.only or CONDITIONS:
        cmd = [sys.executable, __file__, "--condition", name]
        subprocess.run(cmd, check=False, cwd=ROOT)
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
