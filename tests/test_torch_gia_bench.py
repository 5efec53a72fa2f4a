"""The port's GIA benchmark, ``python -m repro_torch.bench.gia_ssim``,
against the JAX package's ``benchmarks/gia_ssim.py``.

* The setup is the reference's: the same 8 methods with the same knobs,
  the same harness schedules, the same victim net (its loss and gradient
  within 1e-5 of each leaf's largest value from the JAX init, f32) and the
  same target image (within 1e-6).
* The entry point runs on the CPU when asked, at a cut schedule (the test
  swaps ``harness_config``; there is no CLI flag for it), and writes rows
  with the fields of ``BENCH_privacy.json``'s; ``--model resnet18`` runs
  the same harness on the full-width ResNet-18.
* Without ``--device`` it asks for the card, and raises where there is none.
"""

import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from benchmarks import gia_ssim as jax_bench
from repro_torch.bench import gia_ssim as tbench
from repro_torch.core.privacy import GIAConfig, HarnessConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.weights import resnet_params_from_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = HarnessConfig(
    train_steps=2,
    attack_steps=(0, 1),
    n_attack_seeds=2,
    gia=GIAConfig(steps=3, lr=0.05, tv_coef=5e-3),
)


def _reference_row_fields():
    rows = json.loads((ROOT / "BENCH_privacy.json").read_text())["results"]
    return set(rows[0])


def test_methods_and_schedules_are_the_reference_ones():
    assert list(tbench.METHODS) == list(jax_bench.METHODS)
    for name, want in jax_bench.METHODS.items():
        got = tbench.METHODS[name]
        if want is None:
            assert got is None
            continue
        for field in ("name", "rank", "bits", "topk_ratio", "alpha"):
            assert getattr(got, field) == getattr(want, field), (name, field)
    for quick in (False, True):
        got, want = tbench.harness_config(quick), jax_bench.harness_config(quick)
        for field in ("train_steps", "attack_steps", "n_attack_seeds", "victim_lr"):
            assert getattr(got, field) == getattr(want, field)
        for field in ("steps", "lr", "tv_coef", "init_scale"):
            assert getattr(got.gia, field) == getattr(want.gia, field)
    assert set(tbench.RESNET_METHODS) <= set(tbench.METHODS)


def test_victim_net_and_target_match_jax():
    jp = jax_bench._init_net(jax.random.PRNGKey(0))
    img, y = jax_bench._target_image(), jnp.array([3])
    tp = resnet_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    timg = tbench._target_image(16, "cpu")
    np.testing.assert_allclose(timg.numpy(), np.asarray(img), rtol=0, atol=1e-6)
    ty = torch.tensor([3])
    want_loss = float(jax_bench._loss_fn(jp, img, y))
    assert abs(float(tbench._loss_fn(tp, timg, ty)) - want_loss) <= 1e-5 * want_loss
    want = jax.tree.leaves(jax_bench._grad_fn(jp, img, y))
    got = tree_leaves(tbench._grad_fn(tp, timg, ty))
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_entry_point_runs_on_the_cpu_and_writes_the_reference_fields(
    monkeypatch, tmp_path
):
    monkeypatch.setattr(tbench, "harness_config", lambda quick: TINY)
    path = tmp_path / "privacy.json"
    rows = tbench.main(["--quick", "--device", "cpu", "--json", str(path)])
    assert [(r["method"], r["step"]) for r in rows] == [
        (m, s) for m in tbench.METHODS for s in (0, 1)
    ]
    payload = json.loads(path.read_text())
    assert payload["results"] == rows and payload["quick"] is True
    assert payload["attack_steps"] == {"cold_start": 0, "steady_state": 1}
    for r in rows:
        assert set(r) == _reference_row_fields()
        assert r["phase"] == ("cold_start" if r["step"] == 0 else "steady_state")
        assert r["state_threaded"] == (r["method"] != "sgd" and r["step"] > 0)
        assert len(r["seed_ssims"]) == 2 and r["ssim"] == max(r["seed_ssims"])
        assert np.isfinite([r["ssim"], r["psnr"], r["attack_loss"]]).all()


def test_entry_point_attacks_resnet18(monkeypatch):
    """The same harness on the full-width ResNet-18 at 32x32x3."""
    monkeypatch.setattr(
        tbench,
        "harness_config",
        lambda quick: HarnessConfig(
            train_steps=2, attack_steps=(1,), n_attack_seeds=2, gia=GIAConfig(steps=2)
        ),
    )
    rows = tbench.main(["--model", "resnet18", "--device", "cpu"])
    assert [r["method"] for r in rows] == list(tbench.RESNET_METHODS)
    victim = tbench.setup("resnet18", "cpu")
    assert sum(t.numel() for t in tree_leaves(victim["params"])) == 11_173_962
    assert tuple(victim["x"].shape) == (1, 32, 32, 3)


def test_entry_point_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tbench, "harness_config", lambda quick: TINY)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbench.main(["--quick"])


def test_unknown_model_raises():
    with pytest.raises(ValueError, match="unknown model"):
        tbench.setup("vgg", "cpu")
