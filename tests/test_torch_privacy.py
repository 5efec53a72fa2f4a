"""The port's gradient-inversion trust claim (paper §V-C) against the JAX
package's ``repro.core.privacy``.

The victim is the JAX benchmark's 2-conv net (``benchmarks/gia_ssim.py``)
with the JAX package's own init carried across (``resnet_params_from_jax``),
its 16x16x3 sin·cos target and label 3; ResNet-18 where named. Tolerances:

* metrics (SSIM, PSNR, TV, cosine distance) on the same arrays: 4e-6 x
  max(1, |value|), the spread of f32 means in other reduction orders;
* accounting: every function of the copied module, 1e-12 relative;
* ``sync_once`` from the JAX state and the same gradient: wire codes and
  ``CommRecord`` exact, outputs and new state within 1e-5 of each leaf's
  largest value (the low-rank factor is an f32 matmul, summed in another
  order);
* observed gradients over 3 threaded victim steps, each framework through
  its own net: within 1e-5 of each leaf's largest value;
* the attack gradient (the double backward): mini-net f32 within 1e-4 of
  the largest |∂|; ResNet-18 at 16x16, batch 1, f64 on both sides within
  1e-8 (its last stage is 2x2, so BatchNorm there sees 4 values a channel:
  f32 rounding alone moves the result by more than 1e-4);
* a 10-step attack from the reference's own x̂₀: final losses within 1e-4
  relative, x̂ within 1e-5 everywhere but at most 2 of its 768 elements (a
  sign flip of a near-zero gradient entry moves an element by 2·lr).
"""

import functools
import math
import time

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from benchmarks import gia_ssim as jax_bench
from repro.core import AxisComm
from repro.core import CompressorConfig as JaxConfig
from repro.core import make_compressor as jax_make_compressor
from repro.core.privacy import GIAConfig as JaxGIAConfig
from repro.core.privacy import PostHocNoiseCompressor as JaxPostHoc
from repro.core.privacy import accounting as jacc
from repro.core.privacy import cosine_distance as jax_cosine
from repro.core.privacy import invert_gradients_batched as jax_invert_batched
from repro.core.privacy import observed_gradient as jax_observed
from repro.core.privacy import psnr as jax_psnr
from repro.core.privacy import ssim as jax_ssim
from repro.core.privacy import total_variation as jax_tv
from repro.models.resnet import init_resnet18 as jax_init_resnet18
from repro.models.resnet import resnet18_forward as jax_resnet18
from repro_torch.bench import gia_ssim as tbench
from repro_torch.core.comm import SimComm
from repro_torch.core.compressors import CompressorConfig, make_compressor
from repro_torch.core.privacy import (
    GIAConfig,
    HarnessConfig,
    PostHocNoiseCompressor,
    cosine_distance,
    invert_gradients,
    invert_gradients_batched,
    observed_gradient,
    psnr,
    run_attack_harness,
    ssim,
    sweep_methods,
    total_variation,
)
from repro_torch.core.privacy import accounting as tacc
from repro_torch.core.privacy.gia import attack_loss
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.weights import compressor_state_from_jax, resnet_params_from_jax

ATTACK = dict(lr=0.05, tv_coef=5e-3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), _np(tree))


@pytest.fixture(scope="module")
def victim():
    """The JAX benchmark's victim, both ways: (JAX params, image, label) and
    the same as tensors."""
    jp = jax_bench._init_net(jax.random.PRNGKey(0))
    img, y = jax_bench._target_image(), jnp.array([3])
    tp = resnet_params_from_jax(_np(jp), "cpu")
    return jp, img, y, tp, torch.from_numpy(np.asarray(img)), torch.tensor([3])


def _leaf_close(got, want, label=""):
    """Each leaf within 1e-5 of the reference leaf's largest |value|."""
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want), strict=True):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, label
        atol = 1e-5 * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=atol, err_msg=label)


# ------------------------------------------------------------------ metrics
def _images(seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    return a, (a + 0.5 * rng.standard_normal(a.shape)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("metric", ["ssim", "psnr", "total_variation", "cosine"])
def test_metrics_match_jax(metric, seed):
    """The same arrays through both: within 4e-6 x max(1, |value|). Each is
    a mean or a sum of 10^2-10^3 f32 terms, which the two frameworks reduce
    in other orders (JAX's TV here is up to 2.6e-6 off an f64 evaluation,
    the port's within 2e-7; a PSNR of 22 dB has an f32 spacing of 1.9e-6)."""
    a, b = _images(seed)
    if metric == "ssim":
        got, want = ssim(torch.from_numpy(a), torch.from_numpy(b)), jax_ssim(a, b)
    elif metric == "psnr":
        got, want = psnr(torch.from_numpy(a), torch.from_numpy(b)), jax_psnr(a, b)
    elif metric == "total_variation":
        got, want = total_variation(torch.from_numpy(b)), jax_tv(b)
    else:
        rng = np.random.default_rng(seed)
        g1 = {"a": rng.standard_normal((40, 50)), "b": rng.standard_normal(70)}
        g2 = {k: v + rng.standard_normal(v.shape) for k, v in g1.items()}
        g1, g2 = ({k: v.astype(np.float32) for k, v in g.items()} for g in (g1, g2))
        got = cosine_distance(_t(g1), _t(g2))
        want = jax_cosine(g1, g2)
    tol = 4e-6 * max(1.0, abs(float(want)))
    assert abs(float(got) - float(want)) <= tol, (float(got), float(want))


def test_ssim_of_an_image_with_itself_is_one(victim):
    img = victim[4]
    assert float(ssim(img, img)) > 0.999
    assert float(psnr(img, img)) > 60.0
    assert float(cosine_distance({"g": img}, {"g": img})) < 1e-6


# --------------------------------------------------------------- accounting
EPSILONS = (0.1, 1.0, 4.0, 16.0, math.inf)
DELTAS = (1e-7, 1e-5, 1e-3)


def _same(a, b):
    if math.isnan(a):  # inf composed 0 times, as in the reference
        return math.isnan(b)
    if math.isinf(a):
        return a == b
    return math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0)


def test_accounting_matches_jax():
    """Every function of the copied module on a grid of (epsilon, delta,
    steps, rate): equal to the reference within 1e-12 relative, and the
    same refusals."""
    n = 0
    for delta in DELTAS:
        for sens in (1.0, 2.0):
            for sigma in (0.0, 0.3, 2.5):
                want = jacc.gaussian_epsilon(sigma, delta, sens)
                assert _same(tacc.gaussian_epsilon(sigma, delta, sens), want)
            for eps in EPSILONS[:-1]:
                want = jacc.gaussian_sigma(eps, delta, sens)
                assert _same(tacc.gaussian_sigma(eps, delta, sens), want)
                n += 1
        for eps in EPSILONS:
            for steps in (0, 1, 10, 1000):
                assert _same(
                    tacc.basic_composition(eps, steps), jacc.basic_composition(eps, steps)
                )
                got = tacc.advanced_composition(eps, steps, delta)
                assert _same(got, jacc.advanced_composition(eps, steps, delta))
                for rate in (0.01, 0.5, 1.0):
                    want = jacc.compose_training(
                        eps, steps, delta=delta, sampling_rate=rate
                    )
                    got = tacc.compose_training(eps, steps, delta=delta, sampling_rate=rate)
                    for f in ("epsilon_per_step", "epsilon_basic", "epsilon_advanced"):
                        assert _same(getattr(got, f), getattr(want, f)), f
                    assert _same(got.delta_total, want.delta_total)
                    assert _same(got.epsilon, want.epsilon)
                    n += 1
            for rate in (0.01, 0.5, 1.0):
                got = tacc.amplified_epsilon(eps, rate)
                assert _same(got, jacc.amplified_epsilon(eps, rate))
    ledgers = [tacc.PrivacyAccountant(1e-5), jacc.PrivacyAccountant(1e-5)]
    for led in ledgers:
        led.spend(0.5, 10)
        led.spend(2.0, 3)
        led.spend(1.0, 0)
    got, want = ledgers
    assert got.n_uses == want.n_uses == 13
    assert _same(got.total_basic(), want.total_basic())
    assert _same(got.total_advanced(), want.total_advanced())
    assert _same(got.total_delta(1e-6), want.total_delta(1e-6))
    bad = [
        lambda m: m.gaussian_sigma(0.0, 1e-5),
        lambda m: m.gaussian_sigma(1.0, 1.0),
        lambda m: m.gaussian_epsilon(-1.0, 1e-5),
        lambda m: m.basic_composition(1.0, -1),
        lambda m: m.amplified_epsilon(1.0, 0.0),
        lambda m: m.PrivacyAccountant(0.0),
    ]
    for call in bad:
        for mod in (tacc, jacc):
            with pytest.raises(ValueError):
                call(mod)
    assert n > 100


# ---------------------------------------------------------------- sync_once
class _RecordingComm(AxisComm):
    """The JAX comm, keeping each gathered array."""

    def __init__(self, names):
        super().__init__(names)
        self.log = []

    def all_gather(self, x):
        g = super().all_gather(x)
        self.log.append(g)
        return g


SYNC_CASES = {
    "powersgd_r2": dict(name="powersgd", rank=2),
    "lq_sgd_r1_b8": dict(name="lq_sgd", rank=1, bits=8),
    "lq_sgd_r1_b4": dict(name="lq_sgd", rank=1, bits=4),
    "topk": dict(name="topk", topk_ratio=0.05),
}


def _jax_wire(comp, g, st):
    """The wire arrays of one JAX sync of one worker (the vmap that
    ``sync_once`` wraps, with a recording comm)."""

    def one(g_, s_):
        comm = _RecordingComm(("solo",))
        out, _, _ = comp.sync(g_, s_, comm)
        return out, comm.log

    lift = functools.partial(jax.tree.map, lambda t: t[None])
    _, log = jax.vmap(one, axis_name="solo")(lift(g), lift(st))
    return [np.asarray(w[0]) for w in log]


@pytest.mark.parametrize("case", sorted(SYNC_CASES))
def test_sync_once_matches_jax(victim, case):
    """The mini-net's gradient (JAX's, fed to both) through one worker's
    sync, from the JAX state carried across (its leading worker dim of 1
    kept in the port's state), twice in a row."""
    jp, img, y, tp, _, _ = victim
    g = jax_bench._grad_fn(jp, img, y)
    jcomp = jax_make_compressor(JaxConfig(**SYNC_CASES[case]), jax.eval_shape(lambda: g))
    tcomp = make_compressor(CompressorConfig(**SYNC_CASES[case]), tp)
    jst = jcomp.init_state(jax.random.PRNGKey(3))
    tst = compressor_state_from_jax(_np(jst), 1, "cpu")
    assert tcomp.wire_bits_per_step() == jcomp.wire_bits_per_step()
    for step in range(2):
        want_wire = _jax_wire(jcomp, g, jst)
        want, jst, jrec = jcomp.sync_once(g, jst)
        comm = SimComm(1, record=True)
        got, tst, rec = tcomp.sync_once(_t(g), tst, comm=comm)
        assert (rec.bits_sent, rec.n_collectives) == (jrec.bits_sent, jrec.n_collectives)
        assert rec.bits_sent == tcomp.wire_bits_per_step()
        assert len(comm.gathered) == len(want_wire)
        for gw, ww in zip(comm.gathered, want_wire):
            gw = gw.numpy()
            assert gw.dtype == ww.dtype and gw.shape == ww.shape
            if ww.dtype == np.float32:
                np.testing.assert_allclose(gw, ww, rtol=0, atol=1e-5 * np.abs(ww).max())
            else:
                np.testing.assert_array_equal(gw, ww)
        _leaf_close(got, want, f"{case} step {step}")
        for ns, sub in tst.items():
            for key, t in sub.items():
                assert t.shape[0] == 1
                _leaf_close([t[0]], [jst[ns][key]], f"{case} state {ns}/{key}")


def test_sgd_passes_the_state_through_untouched(victim):
    jp, img, y, tp, timg, ty = victim
    comp = make_compressor(CompressorConfig(name="sgd"), tp)
    state = comp.init_state(0, 1, "cpu")
    g = tbench._grad_fn(tp, timg, ty)
    out, new_state, rec = comp.sync_once(g, state)
    assert new_state == state == {}
    assert rec.bits_sent == comp.wire_bits_per_step()
    for o, w in zip(tree_leaves(out), tree_leaves(g), strict=True):
        assert torch.equal(o, w)
    marker = object()
    g_obs, same = observed_gradient(tbench._grad_fn, tp, timg, ty, None, marker)
    assert same is marker
    _leaf_close(g_obs, jax_bench._grad_fn(jp, img, y))


def _flat_np(tree):
    return np.concatenate([np.asarray(leaf).reshape(-1) for leaf in jax.tree.leaves(tree)])


def test_observed_gradient_threads_state_like_jax(victim):
    """LQ-SGD r1 b8 over 3 victim steps (plain SGD at lr 0.02 on the synced
    gradient), each framework through its own net from the same params and
    state: the observed gradients agree at every step; the error feedback is
    0 before the first step and not after; a threaded observation differs
    from a cold one."""
    jp, img, y, tp, timg, ty = victim
    kw = dict(name="lq_sgd", rank=1, bits=8)
    jcomp = jax_make_compressor(JaxConfig(**kw), jax.eval_shape(lambda: jp))
    tcomp = make_compressor(CompressorConfig(**kw), tp)
    jst = jcomp.init_state(jax.random.PRNGKey(0))
    tst = compressor_state_from_jax(_np(jst), 1, "cpu")
    st0 = tst
    assert all(float(t.abs().max()) == 0 for t in tree_leaves(tst["err"]))
    for step in range(3):
        want, jst = jax_observed(jax_bench._grad_fn, jp, img, y, jcomp, jst)
        got, tst = observed_gradient(tbench._grad_fn, tp, timg, ty, tcomp, tst)
        _leaf_close(got, want, f"step {step}")
        assert all(float(t.abs().max()) > 0 for t in tree_leaves(tst["err"]))
        jp = jax.tree.map(lambda p, g: p - 0.02 * g, jp, want)
        stepped = [p - 0.02 * g for p, g in zip(tree_leaves(tp), tree_leaves(got))]
        tp = tree_unflatten(tp, stepped)
    threaded, _ = observed_gradient(tbench._grad_fn, tp, timg, ty, tcomp, tst)
    cold, _ = observed_gradient(tbench._grad_fn, tp, timg, ty, tcomp, st0)
    d = torch.cat([(a - b).reshape(-1) for a, b in zip(tree_leaves(threaded), tree_leaves(cold))])
    assert float(d.norm()) > 0


# -------------------------------------------------------- the attack gradient
def test_attack_gradient_matches_jax_on_the_mini_net(victim):
    """∂(attack loss)/∂x̂ at a seeded x̂, f32: within 1e-4 of max |∂|."""
    jp, img, y, tp, _, ty = victim
    g_obs = jax_bench._grad_fn(jp, img, y)
    x = (0.5 * np.random.default_rng(4).standard_normal((1, 16, 16, 3))).astype(
        np.float32
    )

    def jax_loss(xh):
        g = jax_bench._grad_fn(jp, xh, y)
        return jax_cosine(g, g_obs) + 5e-3 * jax_tv(xh)

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(x)))
    loss = functools.partial(attack_loss, tbench._grad_fn, tp, _t(g_obs), ty, 5e-3)
    got = torch.func.grad(loss)(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def _cosine64(g1, g2):
    """JAX's ``cosine_distance`` without its cast to f32."""
    a = jnp.concatenate([leaf.reshape(-1) for leaf in jax.tree.leaves(g1)])
    b = jnp.concatenate([leaf.reshape(-1) for leaf in jax.tree.leaves(g2)])
    return 1.0 - jnp.dot(a, b) / (jnp.linalg.norm(a) * jnp.linalg.norm(b) + 1e-12)


def _resnet_params(seed):
    """ResNet-18 params in the JAX package's tree, drawn with numpy (its
    init runs op by op, seconds per call): He normal for the kernels,
    1/sqrt(fan_in) for the head, BN scales 1 + 0.1 n and biases 0.1 n."""
    rng = np.random.default_rng(seed)
    tree = jax.eval_shape(lambda: jax_init_resnet18(jax.random.PRNGKey(0), 10))

    def draw(path, leaf):
        n = rng.standard_normal(leaf.shape)
        if len(leaf.shape) >= 2:
            return n * np.sqrt(2.0 / np.prod(leaf.shape[:-1]))
        return 0.1 * n + (1.0 if "scale" in jax.tree_util.keystr(path) else 0.0)

    return jax.tree_util.tree_map_with_path(draw, tree)


def test_attack_gradient_matches_jax_on_resnet18():
    """ResNet-18 at 16x16, batch 1, f64 on both sides: within 1e-8 of max
    |∂|. The JAX side takes ``_cosine64``, since the JAX package's cosine
    casts to f32; the port's keeps f64."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(5)
    x_true, x = (rng.standard_normal((1, 16, 16, 3)) for _ in range(2))
    params = _resnet_params(seed=6)

    def jax_loss(p, xh, y):
        logp = jax.nn.log_softmax(jax_resnet18(p, xh))
        return -jnp.mean(logp[jnp.arange(xh.shape[0]), y])

    grad_fn = jax.grad(jax_loss)

    def attack(xh, p, g_obs, y):
        return _cosine64(grad_fn(p, xh, y), g_obs) + 5e-3 * jax_tv(xh)

    with jax.enable_x64(True):
        jp = jax.tree.map(jnp.asarray, params)
        y = jnp.array([3])
        g_obs = jax.jit(grad_fn)(jp, jnp.asarray(x_true), y)
        want = np.asarray(jax.jit(jax.grad(attack))(jnp.asarray(x), jp, g_obs, y))

    tp = tree_map(torch.from_numpy, params)
    ty = torch.tensor([3])
    tg_obs = tbench._resnet_grad_fn(tp, torch.from_numpy(x_true), ty)
    loss = functools.partial(attack_loss, tbench._resnet_grad_fn, tp, tg_obs, ty, 5e-3)
    got = torch.func.grad(loss)(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float64 and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8 * np.abs(want).max())
    print(f"ResNet-18 attack gradient, both frameworks: {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------- the inversion
def test_ten_step_attack_matches_jax_from_its_draw(victim):
    """2 restarts x 10 sign-Adam steps from the JAX package's own x̂₀
    (``init_scale`` · N(0, 1) of its keys): final losses within 1e-4
    relative; x̂ within 1e-5 but at most 2 of each restart's 768 elements."""
    jp, img, y, tp, _, ty = victim
    g_obs = jax_bench._grad_fn(jp, img, y)
    jcfg = JaxGIAConfig(steps=10, **ATTACK)
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    want_x, want_loss = jax_invert_batched(
        jax_bench._grad_fn, jp, g_obs, img.shape, y, keys, jcfg
    )
    x0 = jax.vmap(lambda k: jcfg.init_scale * jax.random.normal(k, img.shape))(keys)
    got_x, got_loss = invert_gradients_batched(
        tbench._grad_fn,
        tp,
        _t(g_obs),
        tuple(img.shape),
        ty,
        cfg=GIAConfig(steps=10, **ATTACK),
        x0=torch.from_numpy(np.asarray(x0)),
    )
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(want_loss), rtol=1e-4)
    off = np.abs(got_x.numpy() - np.asarray(want_x)) > 1e-5
    assert off.reshape(2, -1).sum(1).max() <= 2, off.reshape(2, -1).sum(1)


def _keys(seeds):
    return [torch.Generator().manual_seed(s) for s in seeds]


def test_batched_restarts_equal_sequential_ones(victim):
    _, _, _, tp, timg, ty = victim
    g_obs = tbench._grad_fn(tp, timg, ty)
    cfg = GIAConfig(steps=20, **ATTACK)
    xs, losses = invert_gradients_batched(
        tbench._grad_fn, tp, g_obs, tuple(timg.shape), ty, _keys([5, 6]), cfg
    )
    assert xs.shape == (2,) + tuple(timg.shape) and losses.shape == (2,)
    for i, seed in enumerate([5, 6]):
        x1, l1 = invert_gradients(
            tbench._grad_fn, tp, g_obs, tuple(timg.shape), ty, _keys([seed])[0], cfg
        )
        np.testing.assert_allclose(x1.numpy(), xs[i].numpy(), atol=1e-5)
        assert abs(float(l1) - float(losses[i])) <= 1e-6  # 1 - cos, absolute
    with pytest.raises(ValueError):
        invert_gradients_batched(tbench._grad_fn, tp, g_obs, tuple(timg.shape), ty)


# ---------------------------------------------------------------- the harness
def test_harness_schedule_and_contract(victim):
    """One point per attack step, cold start at step 0 (``state_threaded``
    False) and threaded after; as many restart scores as restarts, the
    point's SSIM their max."""
    _, _, _, tp, timg, ty = victim
    comp = make_compressor(CompressorConfig(name="lq_sgd", rank=1, bits=8), tp)
    cfg = HarnessConfig(
        train_steps=3,
        attack_steps=(0, 2),
        n_attack_seeds=2,
        gia=GIAConfig(steps=20, **ATTACK),
    )
    pts = run_attack_harness(tbench._grad_fn, tp, timg, ty, comp, cfg, method="lq_sgd")
    assert [p.step for p in pts] == [0, 2]
    assert [p.phase for p in pts] == ["cold_start", "steady_state"]
    assert [p.state_threaded for p in pts] == [False, True]
    for p in pts:
        assert p.method == "lq_sgd" and len(p.seed_ssims) == 2
        assert p.ssim == max(p.seed_ssims) and p.x_hat.shape == timg.shape
        assert p.attack_seconds > 0 and math.isfinite(p.attack_loss)


@pytest.mark.parametrize("steps", [(0, 4), (-1,), (5,)])
def test_harness_rejects_an_attack_step_outside_training(steps):
    with pytest.raises(ValueError):
        HarnessConfig(train_steps=4, attack_steps=steps)


def test_steady_state_ordering_sgd_leaks_most(victim):
    """The reference test's exact config: at a threaded step, raw SGD leaks
    at least as much as LQ-SGD (best of 4 restarts, 300 attack steps)."""
    _, _, _, tp, timg, ty = victim
    cfg = HarnessConfig(
        train_steps=4,
        attack_steps=(3,),
        n_attack_seeds=4,
        victim_lr=0.02,
        gia=GIAConfig(steps=300, **ATTACK),
    )
    methods = {"sgd": None, "lq_sgd": CompressorConfig(name="lq_sgd", rank=1, bits=8)}
    t0 = time.perf_counter()
    pts = sweep_methods(methods, tbench._grad_fn, tp, timg, ty, cfg)
    by = {p.method: p for p in pts}
    assert by["lq_sgd"].state_threaded and not by["sgd"].state_threaded
    assert by["lq_sgd"].step == 3 == by["sgd"].step
    assert by["sgd"].ssim >= by["lq_sgd"].ssim, (by["sgd"].ssim, by["lq_sgd"].ssim)
    print(f"ordering sweep: {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------- post-hoc noise
def test_posthoc_noise_is_held_to_its_scale():
    """Statistical: on 200,000 values the added noise has mean within 5
    standard errors of 0 and std within 2% of sigma_norm · max |g|; the
    wire record is the inner compressor's; each step draws anew."""
    g = {"a": torch.linspace(-3.0, 2.0, 200_000), "b": torch.ones(1000)}
    inner = make_compressor(CompressorConfig(name="sgd"), g)
    comp = PostHocNoiseCompressor(inner, 0.05)
    state = comp.init_state(11, 1, "cpu")
    out, state2, rec = comp.sync_once(g, state)
    assert rec.bits_sent == inner.wire_bits_per_step()
    sigma = 0.05 * 3.0
    noise = out["a"] - g["a"]
    assert abs(float(noise.mean())) < 5 * sigma / math.sqrt(noise.numel())
    assert abs(float(noise.std()) / sigma - 1) < 0.02
    assert abs(float((out["b"] - 1).std()) / 0.05 - 1) < 0.15
    assert state2["noise_step"] == 1
    again, _, _ = comp.sync_once(g, state2)
    assert not torch.equal(again["a"], out["a"])
    same, _, _ = comp.sync_once(g, comp.init_state(11, 1, "cpu"))
    assert torch.equal(same["a"], out["a"])


def test_posthoc_epsilon_equals_jax(victim):
    jp, _, _, tp, _, _ = victim
    cfg = dict(name="lq_sgd", rank=1, bits=4)
    for sigma in (0.1, 1.7):
        for delta in (1e-5, 1e-3):
            want = JaxPostHoc(
                jax_make_compressor(JaxConfig(**cfg), jax.eval_shape(lambda: jp)), sigma
            ).privacy_epsilon_per_step(delta)
            got = PostHocNoiseCompressor(
                make_compressor(CompressorConfig(**cfg), tp), sigma
            ).privacy_epsilon_per_step(delta)
            assert got == want


@pytest.mark.parametrize("sigma", [0.0, -0.5])
def test_posthoc_rejects_a_non_positive_sigma(victim, sigma):
    comp = make_compressor(CompressorConfig(name="sgd"), victim[3])
    with pytest.raises(ValueError):
        PostHocNoiseCompressor(comp, sigma)


def test_deterministic_compressors_spend_an_infinite_epsilon(victim):
    """Every ported codec is deterministic or of bounded support, so every
    compressor's per-step epsilon is inf, as the JAX package's is."""
    jp, _, _, tp, _, _ = victim
    for kw in [dict(name="sgd"), dict(name="qsgd", bits=4), *SYNC_CASES.values()]:
        comp = make_compressor(CompressorConfig(**kw), tp)
        jcomp = jax_make_compressor(JaxConfig(**kw), jax.eval_shape(lambda: jp))
        assert comp.privacy_epsilon_per_step() == jcomp.privacy_epsilon_per_step()
        assert math.isinf(comp.privacy_epsilon_per_step())
        assert math.isinf(comp.privacy_budget(10).epsilon)
