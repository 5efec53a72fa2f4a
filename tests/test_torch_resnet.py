"""The port's training slice against the JAX package: ResNet-18, the data,
SGD, one data-parallel step with LQ-SGD, and the launcher.

Weights and images come from numpy (or from the JAX package's own init)
and go through both sides. Tolerances, f32 on the CPU: logits atol 1e-4 x
max |logit|, gradients atol 1e-4 x the leaf's max |grad| (convolutions and
batch statistics sum in other orders in the two frameworks, through 18
layers). The data-parallel step is held exactly on its wire (codes equal,
``CommRecord`` equal) where the encode's inputs agree; see
``_check_step`` for what a one-step code flip at a bin edge allows.
"""

import math

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from benchmarks.convergence import _cnn as jax_cnn
from benchmarks.convergence import _init_cnn as jax_init_cnn
from repro.core import AxisComm
from repro.core import CompressorConfig as JaxConfig
from repro.core import make_compressor as jax_make_compressor
from repro.core.codec import unpack_nibbles as jax_unpack
from repro.data.synthetic import ImageDataConfig as JaxDataConfig
from repro.data.synthetic import class_templates as jax_templates
from repro.models.resnet import init_resnet18 as jax_init_resnet18
from repro.models.resnet import resnet18_forward as jax_resnet18
from repro.models.resnet import resnet18_param_count as jax_param_count
from repro.train.optimizer import sgd as jax_sgd
from repro_torch.core.codec import unpack_nibbles
from repro_torch.core.comm import SimComm
from repro_torch.core.compressors import CompressorConfig, make_compressor
from repro_torch.core.tree import flatten_with_paths, tree_leaves, tree_map
from repro_torch.data.synthetic import ImageDataConfig, class_templates, image_batch
from repro_torch.launch import train_resnet
from repro_torch.models.resnet import (
    ResNet18,
    conv_same,
    init_resnet18,
    resnet18_forward,
    resnet18_param_count,
)
from repro_torch.train.data_parallel import (
    cross_entropy,
    mini_cnn_forward,
    train_step,
)
from repro_torch.train.optimizer import sgd
from repro_torch.weights import compressor_state_from_jax, resnet_params_from_jax


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _params(init, seed):
    """Parameters in the tree and layout of a JAX init, drawn with numpy
    (the JAX init itself runs its draws op by op, seconds per call): He
    normal for kernels, 1/sqrt(fan_in) for the head, BN scale 1 + 0.1 n and
    biases 0.1 n so the affine terms are not trivial."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        shape = leaf.shape
        n = rng.standard_normal(shape).astype(np.float32)
        if len(shape) == 4:
            return n * np.float32(np.sqrt(2.0 / np.prod(shape[:3])))
        if len(shape) == 2:
            return n / np.float32(np.sqrt(shape[0]))
        return n * np.float32(0.1) + np.float32("scale" in jax.tree_util.keystr(path))

    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(init))


def _jax_loss(forward):
    """The reference's loss, with the logits as its aux output."""

    def loss(params, images, labels):
        logits = forward(params, images)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(logp[jnp.arange(labels.shape[0]), labels]), logits

    return loss


def _images(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------- conv SAME
@pytest.mark.parametrize("size", [8, 7, 5, 2, 1])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 2)])
def test_conv_same_pads_as_xla(size, k, stride):
    """XLA's SAME: a stride-2 3x3 conv over an even size pads 0/1, atol 1e-5."""
    x = _images((2, size, size, 3), seed=size)
    w = _images((k, k, 3, 4), seed=k)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    got = conv_same(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w), stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-5)


# ----------------------------------------------------------------- ResNet-18
@pytest.mark.parametrize("hw,dtype", [(8, "float64"), (10, "float32")])
def test_resnet18_logits_and_grads_match_jax(hw, dtype):
    """From the JAX package's init at batch 2, logits and every gradient leaf.

    8x8 takes the even-size SAME pads (0 before, 1 after) and ends in a 1x1
    stage whose BatchNorm normalizes 2 values: there the gradient is so
    ill-conditioned that f32 rounding alone moves some leaves by percents in
    either framework (measured against an f64 evaluation), so this case runs
    in f64 on both sides, atol 1e-8 x max. 10x10 takes the odd sizes 5 and 3
    and is compared in f32: logits atol 1e-4 x max |logit|, each gradient
    leaf atol 1e-4 x its max |grad| (sums in other orders through 18
    layers)."""
    jp32 = _params(lambda: jax_init_resnet18(jax.random.PRNGKey(0), 10), seed=1)
    x = np.random.default_rng(hw).standard_normal((2, hw, hw, 3)).astype(dtype)
    labels = np.array([3, 7])
    tol = 1e-8 if dtype == "float64" else 1e-4
    with jax.enable_x64(dtype == "float64"):
        jp = jax.tree.map(lambda a: jnp.asarray(a, dtype), jp32)
        fn = jax.jit(jax.value_and_grad(_jax_loss(jax_resnet18), has_aux=True))
        (_, want_logits), grads = fn(jp, jnp.asarray(x), jnp.asarray(labels))
        want_logits = np.asarray(want_logits)
        want = [
            (jax.tree_util.keystr(kp), np.asarray(w))
            for kp, w in jax.tree_util.tree_flatten_with_path(grads)[0]
        ]

    tp = tree_map(
        lambda a: torch.from_numpy(a.astype(dtype)).requires_grad_(True), jp32
    )
    logits = resnet18_forward(tp, torch.from_numpy(x))
    np.testing.assert_allclose(
        logits.detach().numpy(), want_logits, atol=tol * np.abs(want_logits).max()
    )
    loss = cross_entropy(logits, torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    for (path, _), g, (jpath, w) in zip(flatten_with_paths(tp), grads, want):
        assert path == jpath
        np.testing.assert_allclose(
            g.numpy(), w, atol=tol * np.abs(w).max(), err_msg=path
        )


def test_resnet18_module_carries_the_jax_names_and_layout():
    tree = init_resnet18(10, device="cpu")
    model = ResNet18(tree)
    names = dict(model.named_parameters())
    assert tuple(names["stage1.0.conv1"].shape) == (3, 3, 64, 128)  # HWIO
    assert tuple(names["stage1.0.proj"].shape) == (1, 1, 64, 128)
    assert "stage0.0.proj" not in names and "stem.bn.scale" in names
    jax_count = jax_param_count(_params(lambda: jax_init_resnet18(jax.random.PRNGKey(0), 10), 0))
    assert resnet18_param_count(model.tree()) == jax_count == 11173962
    x = torch.from_numpy(_images((2, 8, 8, 3), seed=0))
    assert torch.equal(model(x), resnet18_forward(tree, x))


def test_resnet18_init_draws_the_reference_distribution():
    """Statistical: He-normal conv kernels (std sqrt(2 / fan_in)) within 3%,
    fc std 1/sqrt(512) within 5%, BN ones/zeros exactly."""
    p = init_resnet18(10, seed=3, device="cpu")
    w = p["stage3"][1]["conv2"]
    assert abs(float(w.std()) / math.sqrt(2 / (9 * 512)) - 1) < 0.03
    assert abs(float(p["fc"]["w"].std()) * math.sqrt(512) - 1) < 0.05
    assert torch.equal(p["stage2"][0]["bn1"]["scale"], torch.ones(256))


# ---------------------------------------------------------------------- data
def test_image_batch_draws_the_reference_distribution():
    """Statistical (the draws are the port's own): templates N(0, 1) like
    JAX's within 5% in mean and std, noise std 0.35 within 3%, labels cover
    every class; the same (seed, step) gives the same batch."""
    cfg = ImageDataConfig(batch=512, hw=8, seed=0)
    b = image_batch(cfg, 3, "cpu")
    assert tuple(b["images"].shape) == (512, 8, 8, 3) and b["labels"].dtype == torch.int64
    assert set(b["labels"].tolist()) == set(range(10))
    t = class_templates(cfg, "cpu")
    jt = np.asarray(jax_templates(JaxDataConfig(batch=512, hw=8, seed=0)))
    assert abs(float(t.mean()) - jt.mean()) < 0.05 and abs(float(t.std()) / jt.std() - 1) < 0.05
    noise = b["images"] - t[b["labels"]]
    assert abs(float(noise.std()) / 0.35 - 1) < 0.03
    again = image_batch(cfg, 3, "cpu")
    assert torch.equal(again["images"], b["images"])
    assert not torch.equal(image_batch(cfg, 4, "cpu")["images"], b["images"])


# ------------------------------------------------------------------ optimizer
@pytest.mark.parametrize("momentum,wd", [(0.0, 0.0), (0.9, 0.0), (0.9, 5e-4)])
def test_sgd_matches_jax(momentum, wd):
    """Three updates of a small tree, atol 1e-6."""
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32), "b": [rng.standard_normal(5).astype(np.float32)]}
    grads = [tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params) for _ in range(3)]
    jopt = jax_sgd(0.1, momentum, wd)
    jp, js = jax.tree.map(jnp.asarray, params), None
    js = jopt.init(jp)
    topt = sgd(0.1, momentum, wd)
    tp = tree_map(torch.from_numpy, tree_map(np.copy, params))
    ts = topt.init(tp)
    for g in grads:
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        ts = topt.update(tree_map(torch.from_numpy, g), ts, tp)
    for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# ------------------------------------------------- one data-parallel step
N = 2
LR = 0.05


def _jax_worker_step(forward, jp, cfg, images, labels):
    """The worker of ``benchmarks/convergence.py::train_one``, recording the
    gathered wire: returns (params, loss, comp state, wire, CommRecord)."""
    comp = jax_make_compressor(cfg, jax.eval_shape(lambda: jp))
    # the state of comp.init_state (E = 0, a normal warm-start Q), drawn with
    # numpy: the JAX init draws Q leaf by leaf, op by op, seconds per call
    rng = np.random.default_rng(7)
    low = [(i, pl) for i, pl in enumerate(comp.plans) if pl.route == "lowrank"]
    state0 = {
        "err": {str(i): np.zeros(pl.shape, np.float32) for i, pl in low},
        "q": {
            str(i): rng.standard_normal((pl.mat_shape[1], pl.eff_rank)).astype(np.float32)
            for i, pl in low
        },
    }
    state = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (N,) + x.shape), state0)
    recs = []

    class Rec(AxisComm):
        log = []

        def all_gather(self, x):
            g = super().all_gather(x)
            self.log.append(g)
            return g

    def worker(params, cs, imgs, lbls):
        comm = Rec(("data",))
        comm.log = []
        (loss, _), g = jax.value_and_grad(_jax_loss(forward), has_aux=True)(
            params, imgs, lbls
        )
        g, cs, rec = comp.sync(g, cs, comm)
        recs.append(rec)
        params = jax.tree.map(lambda w, gg: w - LR * gg, params, g)
        return params, cs, jax.lax.pmean(loss, "data"), comm.log

    vw = jax.jit(
        jax.vmap(
            worker, axis_name="data", in_axes=(None, 0, 0, 0), out_axes=(None, 0, None, 0)
        )
    )
    params, cs, loss, log = vw(jp, state, jnp.asarray(images), jnp.asarray(labels))
    wire = [np.asarray(g[0]) for g in log]
    return _np_tree(params), float(loss), _np_tree(cs), state0, wire, recs[0]


def _check_step(jax_forward, forward, jp, bits, images, labels):
    """Port step vs JAX step from the same params, batch and compressor state.

    Exact: ``CommRecord`` bits and counts. Codes on the wire: equal, except
    that a code may move one step where the encode's input (P, Q or a raw
    leaf, from gradients that agree to ~1e-6) sits at a bin edge; at most
    0.1% of codes may. Loss rtol 1e-5. The update w_new - w of every leaf:
    atol 1e-4 x its max |update| where no code moved; where some did, a
    one-step move of one worker's code shifts a mean code by 1/N level,
    which scales that value by at most (1 + alpha)^(1/(N L)), so the bound
    becomes 2 x ((1 + alpha)^(1/(N L)) - 1) x max |update|."""
    cfg = dict(name="lq_sgd", rank=1, bits=bits)
    jp_np = _np_tree(jp)
    want_params, want_loss, want_state, state0, want_wire, want_rec = _jax_worker_step(
        jax_forward, jp, JaxConfig(**cfg), images, labels
    )

    params = tree_map(lambda t: t.requires_grad_(True), resnet_params_from_jax(jp_np, "cpu"))
    comp = make_compressor(CompressorConfig(**cfg), params)
    cstate = compressor_state_from_jax(state0, N, "cpu")
    opt = sgd(LR)
    comm = SimComm(N, record=True)
    res, _, _, cstate = train_step(
        forward, params, opt, opt.init(params), comp, cstate, comm,
        torch.from_numpy(images), torch.from_numpy(labels),
    )
    assert (res.rec.bits_sent, res.rec.n_collectives) == (
        want_rec.bits_sent, want_rec.n_collectives,
    )
    assert len(comm.gathered) == len(want_wire)
    flips = n_codes = 0
    for g, w in zip(comm.gathered, want_wire):
        if bits <= 4:
            n = 2 * w.shape[-1]
            g, w = unpack_nibbles(g, n).numpy(), np.asarray(jax_unpack(jnp.asarray(w), n))
        else:
            g = g.numpy()
        diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
        assert diff.max() <= 1
        flips += int((diff > 0).sum())
        n_codes += diff.size
    assert flips <= 1e-3 * n_codes, (flips, n_codes)
    np.testing.assert_allclose(res.loss, want_loss, rtol=1e-5)
    levels = (1 << (bits - 1)) - 1
    tol = 1e-4 if flips == 0 else 2 * ((1 + 10.0) ** (1 / (N * levels)) - 1)
    for (path, p), w, w0 in zip(
        flatten_with_paths(params), jax.tree.leaves(want_params), jax.tree.leaves(jp_np)
    ):
        upd, want_upd = p.detach().numpy() - w0, np.asarray(w) - w0
        np.testing.assert_allclose(
            upd, want_upd, atol=tol * np.abs(want_upd).max() + 1e-7, err_msg=path
        )
    for ns in ("err", "q"):
        for key, t in cstate[ns].items():
            want = want_state[ns][key]
            np.testing.assert_allclose(
                t.numpy(), want, atol=max(tol, 1e-4) * np.abs(want).max() + 1e-7
            )
    return flips


def test_resnet18_lq_sgd_b8_step_matches_jax():
    """ResNet-18, 2 workers x batch 2, 10x10 images (well conditioned in
    f32, unlike 8x8: see test_resnet18_logits_and_grads_match_jax), rank 1,
    b = 8."""
    jp = _params(lambda: jax_init_resnet18(jax.random.PRNGKey(0), 10), seed=2)
    images = _images((N, 2, 10, 10, 3), seed=21)
    labels = np.array([[0, 5], [9, 2]])
    _check_step(jax_resnet18, resnet18_forward, jp, 8, images, labels)


def test_mini_cnn_lq_sgd_b4_step_matches_jax():
    """The reference's mini-CNN, 2 workers x batch 4, 8x8 images, b = 4."""
    jp = _params(lambda: jax_init_cnn(jax.random.PRNGKey(0)), seed=3)
    images = _images((N, 4, 8, 8, 3), seed=22)
    labels = np.array([[0, 5, 1, 1], [9, 2, 3, 4]])
    _check_step(jax_cnn, mini_cnn_forward, jp, 4, images, labels)


# ------------------------------------------------------------------ launcher
def test_train_resnet_runs_on_the_cpu_when_asked():
    out = train_resnet.main(
        ["--device", "cpu", "--hw", "8", "--batch", "2", "--workers", "2", "--steps", "2"]
    )
    assert len(out["losses"]) == 2 and all(math.isfinite(v) for v in out["losses"])
    # 370136 bits/step, 12500 steps of 2 x 2 images per 50,000-image epoch
    assert out["mb_per_epoch"] == 370136 / 8e6 * 12500


def test_train_resnet_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_resnet.main(["--steps", "1"])
