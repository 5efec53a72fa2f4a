"""The port's training runtime, checkpoints and LM launcher, on the CPU.

* The step the runtime drives against the JAX package's own jitted
  ``build_train_step`` with ``accum_steps=2`` (the runtime's
  ``microbatch``), on a (1, 1) CPU mesh;
* ``AsyncRunner`` equals ``Trainer`` bit for bit (parameters, optimizer
  and compressor state, history);
* a background checkpoint restored and continued equals an uninterrupted
  run bit for bit; a write error surfaces on ``drain()``; a prefetch error
  propagates; checkpoints round-trip bf16 leaves and Python numbers;
* ``run_schedule`` resumes mid-decay and from a save on a decay boundary,
  as ``tests/test_runtime.py`` holds the JAX package's;
* ``python -m repro_torch.launch.train --smoke --device cpu`` runs, with
  the randomized codecs too (the deterministic run's wire, the per-step
  epsilon printed), and the flags of parts not ported raise, naming their
  ROADMAP items.

The model is ``_torch_lm.lm_configs``' gemma3-1b at smoke widths, in f32.
"""

import contextlib
import functools
import io
import math
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from _torch_lm import (
    LR,
    assert_leaves_close,
    flip_tol,
    lm_configs,
    lm_tokens,
    to_numpy,
)

from repro.core import CompressorConfig as JaxCompressorConfig
from repro.launch.mesh import make_mesh, use_mesh
from repro.train import optimizer as jax_opt
from repro.train import step as jax_step
from repro_torch.checkpoint.io import (
    AsyncCheckpointer,
    _is_rows,
    leaf_fingerprints,
    peek_step,
    restore,
    save,
)
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.data.synthetic import LMDataConfig, lm_batch
from repro_torch.launch import train as launch_train
from repro_torch.train.optimizer import adam, sgd
from repro_torch.train.runtime import AsyncRunner, RuntimeConfig, run_schedule
from repro_torch.train.step import (
    build_train_step,
    init_train_state,
    make_model_compressor,
)
from repro_torch.train.trainer import WORKER_ROWS, Trainer, TrainerConfig
from repro_torch.weights import train_state_from_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 2
DECAY = ((4, 2, None), (8, 1, None))


def _setup(comp_cfg=None, opt=None, batch=4, seq=16):
    _, cfg = lm_configs()
    comp = make_model_compressor(
        cfg, comp_cfg or CompressorConfig(name="lq_sgd", rank=2)
    )
    data = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=seq, batch=batch)
    return cfg, comp, opt or sgd(LR), (lambda i: lm_batch(data, i))


def _state(cfg, comp, opt):
    return init_train_state(cfg, 0, opt, comp, N, "cpu")


def _assert_bit_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def _quiet(**kw):
    return RuntimeConfig(verbose=False, **kw)


def test_one_step_on_one_worker_matches_the_jitted_jax_step():
    """N = 1, LQ-SGD r1 b8, SGD, ``accum_steps=2``: the JAX package's own
    ``build_train_step`` jitted on a (1, 1) CPU mesh against the port's
    step, each from its own gradients: parameters, error feedback and
    warm-start Q within :func:`_torch_lm.flip_tol` (a wire code may flip at
    a bin edge), loss rtol 1e-5, the wire accounting exactly."""
    jcfg, cfg = lm_configs()
    ccfg = dict(name="lq_sgd", rank=1, bits=8)
    jcomp = jax_step.make_model_compressor(jcfg, JaxCompressorConfig(**ccfg))
    comp = make_model_compressor(cfg, CompressorConfig(**ccfg))
    mesh = make_mesh((1, 1), ("data", "model"))
    tokens = lm_tokens()
    with use_mesh(mesh):
        jfn, _, _ = jax_step.build_train_step(
            jcfg, mesh, jcomp, jax_opt.sgd(LR), accum_steps=2
        )
        jstate = jax_step.init_train_state(
            jcfg, jax.random.PRNGKey(0), jax_opt.sgd(LR), jcomp, 1
        )
        want, wm = jax.jit(jfn)(jstate, {"tokens": jnp.asarray(tokens)})
    state = train_state_from_jax(to_numpy(jstate), "cpu")
    step = build_train_step(cfg, (1, 1), comp, sgd(LR), accum_steps=2)
    got, m = step(state, {"tokens": tokens})
    tol = flip_tol(8, 1)
    for key in ("params", "comp"):
        assert_leaves_close(got[key], to_numpy(want[key]), key, atol_rel=tol)
    assert int(got["step"]) == int(want["step"]) == 1
    assert set(m) == set(wm)
    for k in ("ce", "loss"):
        np.testing.assert_allclose(float(m[k]), float(wm[k]), rtol=1e-5)
    for k in ("wire_mb_per_step", "collectives_per_step", "down_mb_per_step"):
        assert float(m[k]) == float(wm[k]), k


def test_async_runner_equals_trainer_bit_for_bit():
    cfg, comp, opt, bf = _setup(opt=adam(1e-3))
    step = build_train_step(cfg, (N, 1), comp, opt)
    tr = Trainer(step, bf, TrainerConfig(steps=5, log_every=2, verbose=False))
    ar = AsyncRunner(step, bf, _quiet(steps=5, log_every=2, prefetch=2))
    s_sync = tr.run(_state(cfg, comp, opt))
    s_async = ar.run(_state(cfg, comp, opt))
    _assert_bit_equal(s_sync, s_async)
    assert int(s_async["step"]) == 5
    drop = ("wall_s",)
    strip = [{k: v for k, v in h.items() if k not in drop} for h in tr.history]
    assert strip == [{k: v for k, v in h.items() if k not in drop} for h in ar.history]
    assert [h["step"] for h in ar.history] == [0, 2, 4]


def test_microbatch_accumulation_runs_under_the_async_runner():
    """``microbatch`` k = 2: the same sync bits a step as k = 1, and the
    async runner equal to the sync loop with it."""
    cfg, comp, opt, bf = _setup()
    step = build_train_step(cfg, (N, 1), comp, opt, accum_steps=2)
    tr = Trainer(step, bf, TrainerConfig(steps=2, verbose=False))
    ar = AsyncRunner(step, bf, _quiet(steps=2, microbatch=2))
    _assert_bit_equal(tr.run(_state(cfg, comp, opt)), ar.run(_state(cfg, comp, opt)))
    assert ar.history[-1]["wire_mb_per_step"] == np.float32(
        comp.wire_bits_per_step() / 8e6
    )


def test_background_checkpoint_restore_and_continue_equals_one_run(tmp_path):
    """Adam and LQ-SGD: 4 steps at once against 2 steps saved in the
    background, restored into a fresh like-state and run on to 4."""
    cfg, comp, opt, bf = _setup(opt=adam(1e-3))
    step = build_train_step(cfg, (N, 1), comp, opt)
    whole = AsyncRunner(step, bf, _quiet(steps=4)).run(_state(cfg, comp, opt))
    ck = str(tmp_path / "s.ckpt")
    first = AsyncRunner(step, bf, _quiet(steps=2, ckpt_every=5, ckpt_path=ck))
    first.run(_state(cfg, comp, opt))
    assert peek_step(ck) == 2
    like = init_train_state(cfg, 1, opt, comp, N, "cpu")
    restored = restore(ck, like)
    assert int(restored["step"]) == 2
    resumed = AsyncRunner(step, bf, _quiet(steps=4)).run(restored)
    _assert_bit_equal(whole, resumed)


def test_async_checkpoint_write_error_surfaces_on_drain(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    bad = str(blocker / "s.ckpt")
    saver = AsyncCheckpointer(bad)
    try:
        saver.submit({"step": torch.zeros((), dtype=torch.int32)})
        with pytest.raises(RuntimeError, match="async checkpoint write"):
            saver.drain()
    finally:
        saver.close()
    cfg, comp, opt, bf = _setup()
    step = build_train_step(cfg, (N, 1), comp, opt)
    runner = AsyncRunner(step, bf, _quiet(steps=2, ckpt_every=1, ckpt_path=bad))
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        runner.run(_state(cfg, comp, opt))


def test_prefetch_error_propagates():
    cfg, comp, opt, bf = _setup()

    def bad_batch(i):
        if i == 2:
            raise ValueError("corrupt shard")
        return bf(i)

    step = build_train_step(cfg, (N, 1), comp, opt)
    runner = AsyncRunner(step, bad_batch, _quiet(steps=4))
    with pytest.raises(RuntimeError, match="batch prefetch failed") as err:
        runner.run(_state(cfg, comp, opt))
    assert isinstance(err.value.__cause__, ValueError)


def test_checkpoint_round_trips_bf16_leaves_and_python_numbers(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {
        "w": torch.randn((5, 3), generator=g).to(torch.bfloat16),
        "e": [torch.randn(7, generator=g), torch.arange(4, dtype=torch.int32)],
        "step": torch.tensor(9, dtype=torch.int32),
        "count": 3,
    }
    path = str(tmp_path / "t.ckpt")
    assert save(path, tree) == os.path.getsize(path)
    assert not os.path.exists(path + ".tmp")
    assert peek_step(path) == 9
    like = {
        "w": torch.empty((5, 3), dtype=torch.bfloat16, device="meta"),
        "e": [torch.empty(7), torch.empty(4, dtype=torch.int32)],
        "step": torch.empty((), dtype=torch.int32),
        "count": 0,
    }
    back = restore(path, like)
    _assert_bit_equal(back, tree)
    assert back["w"].device.type == "cpu" and type(back["count"]) is int
    with pytest.raises(ValueError, match="wanted"):
        restore(path, {**like, "w": torch.empty((5, 3))})
    with pytest.raises(KeyError, match="misses"):
        restore(path, {**like, "extra": torch.empty(1)})


def _decay_runner(tmp_path, steps, ckpt_every=0):
    comp_cfg = CompressorConfig(name="lq_sgd", rank=4, schedule_decay=DECAY)
    cfg, comp, opt, bf = _setup(comp_cfg)
    ck = str(tmp_path / "s.ckpt")
    calls = []

    def rebuild(c, seg):
        calls.append(seg)
        return build_train_step(cfg, (N, 1), c, opt)

    tcfg = TrainerConfig(
        steps=steps, log_every=100, ckpt_every=ckpt_every, ckpt_path=ck, verbose=False
    )
    return cfg, comp, opt, bf, ck, calls, rebuild, tcfg


def _runner(cfg, comp, opt, bf, tcfg=None):
    tcfg = tcfg or TrainerConfig(steps=4, log_every=100, verbose=False)
    return Trainer(build_train_step(cfg, (N, 1), comp, opt), bf, tcfg)


def _q_cols(state):
    return {v.shape[-1] for v in state["comp"]["q"].values()}


def test_run_schedule_resumes_mid_decay(tmp_path):
    """Save at step 6 (past the boundary at 4), restore with the compressor
    of the saved step, resume to 12: the finished phase is skipped, the
    entry phase needs no rebuild and the boundary at 8 fires once."""
    cfg, comp, opt, bf, ck, calls, rebuild, tcfg = _decay_runner(tmp_path, 6, 3)
    state = run_schedule(
        _runner(cfg, comp, opt, bf, tcfg),
        comp,
        _state(cfg, comp, opt),
        total_steps=6,
        rebuild=rebuild,
    )
    assert calls == [4] and int(state["step"]) == 6 and _q_cols(state) == {2}
    comp_r = comp.at_step(peek_step(ck) - 1)
    restored = restore(ck, _state(cfg, comp_r, opt))
    calls.clear()
    final = run_schedule(
        _runner(cfg, comp_r, opt, bf),
        comp,
        restored,
        total_steps=12,
        rebuild=rebuild,
        initial=comp_r,
    )
    assert calls == [8]
    assert int(final["step"]) == 12 and _q_cols(final) == {1}


def test_resume_from_a_save_on_a_decay_boundary(tmp_path):
    """A save at step 4, on the boundary, holds the rank-4 Q of the phase
    that made it: restored with ``at_step(3)``, the boundary's adaptation
    then fires once on entry, and the one at 8 once."""
    cfg, comp, opt, bf, ck, calls, rebuild, tcfg = _decay_runner(tmp_path, 4, 4)
    run_schedule(
        _runner(cfg, comp, opt, bf, tcfg),
        comp,
        _state(cfg, comp, opt),
        total_steps=4,
        rebuild=rebuild,
    )
    assert peek_step(ck) == 4
    comp_r = comp.at_step(3)
    restored = restore(ck, _state(cfg, comp_r, opt))
    assert _q_cols(restored) == {4}
    with pytest.raises(ValueError, match="wanted"):
        restore(ck, _state(cfg, comp.at_step(4), opt))
    calls.clear()
    final = run_schedule(
        _runner(cfg, comp_r, opt, bf),
        comp,
        restored,
        total_steps=12,
        rebuild=rebuild,
        initial=comp_r,
    )
    assert calls == [4, 8]
    assert int(final["step"]) == 12 and _q_cols(final) == {1}


def test_launcher_trains_at_smoke_widths_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "gemma3-1b"]
        + ["--smoke", "--device", "cpu", "--steps", "3", "--log-every", "1"],
        capture_output=True,
        text=True,
        timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
    )
    assert out.returncode == 0, out.stderr
    assert "arch=gemma3-1b-smoke params=" in out.stdout
    assert "wire/step=" in out.stdout and "compressor=lq_sgd" in out.stdout
    assert sum(line.startswith("step ") for line in out.stdout.splitlines()) == 3


@pytest.mark.parametrize(
    "argv, item",
    [
        # a model axis above 1 trains with every compressor since step 4
        # (tests/test_torch_tp_train_wire.py); the production mesh is the
        # H100 cluster's since item 17, and takes its 256 ranks
        (["--mesh", "2x2", "--compressor", "topk", "--production-mesh"], "256 ranks"),
        (["--production-mesh"], "256 ranks"),
        # the multi-pod mesh: two scalable units, 512 ranks (mamba2-370m and
        # jamba-v0.1-52b train since the zoo's last slice, over a model axis
        # with every compressor since step 4)
        (["--arch", "mamba2-370m", "--multi-pod"], "512 ranks"),
        (
            ["--arch", "jamba-v0.1-52b", "--mesh", "1x2", "--compressor", "qsgd"]
            + ["--multi-pod"],
            "512 ranks",
        ),
    ],
    ids=["mesh-2x2", "production-mesh", "mamba2", "mixtral"],
)
def test_launcher_refuses_what_is_not_ported(argv, item):
    """The production meshes at a world of one process: a ValueError that
    names the ranks they take (item 17 ported them; the ids are kept)."""
    base = ["--arch", "gemma3-1b", "--smoke", "--device", "cpu", "--steps", "1"]
    with pytest.raises(ValueError, match=f"production mesh .* takes {item}, not 1"):
        launch_train.main(base + argv)


SMOKE_STEP = ["--arch", "gemma3-1b", "--smoke", "--device", "cpu", "--steps", "1"]
SMOKE_STEP += ["--mesh", "2x1", "--batch", "4", "--seq", "32", "--log-every", "1"]


@functools.cache
def _run_line(*argv):
    """The launcher's ``arch=...`` line of one smoke step with ``argv``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_train.main(SMOKE_STEP + list(argv))
    return next(ln for ln in out.getvalue().splitlines() if ln.startswith("arch="))


def _field(line, name):
    return next(w for w in line.split() if w.startswith(name + "="))


@pytest.mark.parametrize(
    "argv, kind",
    [
        (["--codec", "dlog"], "none"),
        (["--codec", "lrq"], "gaussian_equiv"),
        (["--dp-epsilon", "8"], "calibrated"),
    ],
    ids=["codec-dlog", "codec-lrq", "dp-epsilon"],
)
def test_launcher_runs_the_randomized_codecs(argv, kind):
    """One smoke step each: the deterministic run's wire/step, and the
    per-step epsilon and its kind printed beside it (dlog without a budget
    dithers only: no guarantee, an infinite epsilon)."""
    det = _run_line()
    line = _run_line(*argv)
    assert _field(line, "wire/step") == _field(det, "wire/step")
    assert "epsilon/step" not in det
    eps = float(_field(line, "epsilon/step").split("=")[1])
    assert math.isinf(eps) == (kind == "none")
    assert f"({kind})" in line


@pytest.mark.parametrize("wire", ["symmetric", "server"])
def test_checkpoint_rows_are_the_per_worker_leaves(wire):
    """The leaves a checkpoint gathers and cuts by worker are the lazy
    composite's per-worker ones (error feedback, warm-start Q, references,
    the server wire's counters); its cached aggregate, drift tracker and
    the symmetric wire's 0-dim counter are shared, written once."""
    from repro_torch.core.compressors import make_compressor

    abstract = {"b": torch.empty(6), "w": torch.empty(12, 10)}
    kw = dict(topology="server", participation=0.5) if wire == "server" else {}
    cfg = CompressorConfig(
        name="lq_sgd",
        min_compress_numel=16,
        lazy_thresh=2.0,
        lazy_adaptive=2.0 if wire == "symmetric" else 0.0,
        **kw,
    )
    state = make_compressor(cfg, abstract).init_state(0, 3, "cpu")
    rows = {
        ns: {
            k: _is_rows(WORKER_ROWS, f"['comp']['{ns}']['{k}']", v)
            for k, v in sub.items()
        }
        for ns, sub in state.items()
        if isinstance(sub, dict)
    }
    want_rows = {"err", "q", "lazy_ref"}
    if wire == "server":
        want_rows.add("lazy_stale")
    for ns, sub in rows.items():
        assert set(sub.values()) == {ns in want_rows}, ns
        if ns in want_rows:
            assert all(state[ns][k].shape[0] == 3 for k in sub)
    shared = {"lazy_ema", "lazy_stale"} if wire == "symmetric" else set()
    assert shared <= rows.keys()
    if wire == "symmetric":
        assert "lazy_out" in rows and not any(rows["lazy_out"].values())
        assert state["lazy_stale"]["lq_sgd"].dim() == 0
    assert not _is_rows(WORKER_ROWS, "['params']['w']", torch.empty(3, 2))


def test_fingerprints_tell_any_bit_apart_and_split_rows():
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
    y = x.clone()
    y.view(torch.int32)[2, 4] ^= 1  # one bit of one value
    tree = {"comp": {"err": {"0": x}}, "step": 4, "w": x[0].bfloat16()}
    got = leaf_fingerprints(tree, WORKER_ROWS)
    same = {**tree, "comp": {"err": {"0": x.clone()}}}
    assert got == leaf_fingerprints(same, WORKER_ROWS)
    rows = got["['comp']['err']['0']"]
    assert len(rows) == 3 and rows == [leaf_fingerprints({"r": r})["['r']"] for r in x]
    other = leaf_fingerprints({"comp": {"err": {"0": y}}}, WORKER_ROWS)
    assert other["['comp']['err']['0']"][:2] == rows[:2]
    assert other["['comp']['err']['0']"][2] != rows[2]
    assert got["['step']"] == ("int", 4)
    assert got["['w']"][:2] == ("torch.bfloat16", (5,))


def test_launcher_dump_holds_the_run(tmp_path):
    """``--dump``: the history, the gathers, the final parameters'
    fingerprints and the compressor state's by worker row, a time a step."""
    argv = ["--arch", "gemma3-1b", "--smoke", "--device", "cpu", "--mesh", "2x1"]
    argv += ["--batch", "4", "--seq", "32", "--steps", "2", "--log-every", "1"]
    with contextlib.redirect_stdout(io.StringIO()):
        run = launch_train.main(argv + ["--dump", str(tmp_path)])
    dump = torch.load(tmp_path / "rank0.pt", weights_only=False)
    assert dump["history"] == run["history"] and len(dump["step_s"]) == 2
    assert dump["params"] == leaf_fingerprints(run["state"]["params"])
    comp = leaf_fingerprints({"comp": run["state"]["comp"]}, WORKER_ROWS)
    assert dump["comp"] == comp
    assert all(len(v) == 2 for k, v in comp.items() if "['err']" in k)
    assert dump["gathered"] and dump["collective_s"] == [0.0, 0.0]
