"""The port's graphed steps, on the CPU: what a CUDA graph needs of them.

A graph replays the addresses and values of its capture, so the graphed
decode takes its position as a (B,) tensor, and the attack its step count
as a 0-dim tensor. On the CPU the same steps run eagerly, and these tests
hold them to the int paths and to the JAX package:

* decode at a (B,) position tensor against the int position, from the same
  prefill, at smoke size: the same tokens, and cache codes, scales and
  states equal byte for byte (gemma3-1b raw, q8 and q4; mamba2-370m);
* the attack step with a device ``t`` against the JAX package's own steps
  from its draw: the tolerance of ``tests/test_torch_privacy.py``'s
  ten-step test (final losses within 1e-4 relative, x̂ within 1e-5 but at
  most 2 of each restart's 768 elements);
* the launch bookkeeping: a capture records and counts nothing, each replay
  adds the record;
* a graph asked for on the CPU raises.

The graphs themselves run on the card: ``tests/test_torch_cuda.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

from benchmarks import gia_ssim as jax_bench
from repro.core.privacy import GIAConfig as JaxGIAConfig
from repro.core.privacy import invert_gradients_batched as jax_invert_batched
from repro_torch import graphs
from repro_torch.bench import gia_ssim as tbench
from repro_torch.configs import get_config
from repro_torch.core.privacy import GIAConfig, invert_gradients_batched
from repro_torch.core.privacy.gia import make_attack_step
from repro_torch.core.tree import tree_map
from repro_torch.kernels import launches, ops
from repro_torch.models.model import init_params
from repro_torch.serving import engine
from repro_torch.serving.kv_cache import CacheQuantConfig, QuantKV, tree_leaves
from repro_torch.serving.scheduler import ContinuousScheduler
from repro_torch.weights import resnet_params_from_jax

PROMPT, GEN = 12, 8
ATTACK = dict(lr=0.05, tv_coef=5e-3)


def _tensors(leaf):
    return (leaf.codes, leaf.scale) if isinstance(leaf, QuantKV) else (leaf,)


@pytest.mark.parametrize(
    "arch, bits",
    [("gemma3-1b", 0), ("gemma3-1b", 8), ("gemma3-1b", 4), ("mamba2-370m", 0)],
)
def test_decode_at_a_device_index_equals_the_int_index(arch, bits):
    cfg = get_config(arch, smoke=True)
    params = init_params(cfg, 0, "cpu")
    qcfg = CacheQuantConfig(bits=bits) if bits else None
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, PROMPT))
    )
    prefill = engine.build_prefill_step(cfg, PROMPT + GEN, qcfg=qcfg)
    generate = engine.build_generate_fn(cfg)
    runs = []
    for index in (PROMPT, torch.full((2,), PROMPT)):
        logits, caches = prefill(params, tokens)
        first = engine.greedy_sample(logits)
        caches, nxt, end, sampled = generate(params, caches, first, index, None, GEN)
        runs.append((caches, nxt, end, sampled))
    (c_int, n_int, e_int, s_int), (c_dev, n_dev, e_dev, s_dev) = runs
    assert s_int.shape == (2, GEN) and torch.equal(s_int, s_dev)
    assert torch.equal(n_int, s_int[:, -1:]) and torch.equal(n_dev, n_int)
    assert e_int == PROMPT + GEN and e_dev.tolist() == [PROMPT + GEN] * 2
    pairs = zip(tree_leaves(c_int), tree_leaves(c_dev), strict=True)
    for (path, a), (_, b) in pairs:
        assert isinstance(a, QuantKV) == (bits > 0 and path[-1] in ("k", "v"))
        for x, y in zip(_tensors(a), _tensors(b), strict=True):
            assert torch.equal(x, y), path


def test_temperature_draws_equal_at_both_indices():
    """At temperature 1 the same generator seed draws the same tokens
    whether the position is an int or a tensor."""
    cfg = get_config("gemma3-1b", smoke=True)
    params = init_params(cfg, 0, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 100, (2, PROMPT)))
    prefill = engine.build_prefill_step(cfg, PROMPT + GEN)
    generate = engine.build_generate_fn(cfg, temperature=1.0)
    got = []
    for index in (PROMPT, torch.full((2,), PROMPT)):
        logits, caches = prefill(params, tokens)
        gen = torch.Generator().manual_seed(3)
        first = engine.greedy_sample(logits)
        got.append(generate(params, caches, first, index, gen, GEN))
    assert torch.equal(got[0][3], got[1][3])


def _raise_generate():
    cfg = get_config("gemma3-1b", smoke=True)
    params = init_params(cfg, 0, "cpu")
    caches = engine.init_serving_caches(cfg, 1, 4, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.long)
    engine.build_generate_fn(cfg, graph=True)(params, caches, tok, 0, None, 2)


def _raise_scheduler():
    cfg = get_config("gemma3-1b", smoke=True)
    params = init_params(cfg, 0, "cpu")
    ContinuousScheduler(cfg, params, slots=1, max_seq=8, device="cpu", graph=True)


def _raise_attack():
    tp = tbench._init_net(0, "cpu")
    x, y = tbench._target_image(16, "cpu"), torch.tensor([3])
    g_obs = tbench._grad_fn(tp, x, y)
    x0 = torch.zeros((1,) + tuple(x.shape))
    cfg = GIAConfig(steps=2, **ATTACK)
    invert_gradients_batched(
        tbench._grad_fn, tp, g_obs, tuple(x.shape), y, cfg=cfg, x0=x0, graph=True
    )


def _raise_step_graph():
    graphs.StepGraph(lambda: None, "cpu")


@pytest.mark.parametrize(
    "call", [_raise_generate, _raise_scheduler, _raise_attack, _raise_step_graph]
)
def test_a_graph_asked_for_on_the_cpu_raises(call):
    with pytest.raises(ValueError, match="CUDA graph needs a CUDA device"):
        call()


def test_use_graph_resolves_the_default_by_device():
    assert graphs.use_graph(None, "cuda") and not graphs.use_graph(None, "cpu")
    assert not graphs.use_graph(False, "cuda") and not graphs.use_graph(False, "cpu")
    assert graphs.use_graph(True, "cuda")


def test_launch_counts_record_a_capture_and_add_it_per_replay():
    """Through the plain-Python bookkeeping: an eager launch counts at once;
    inside ``recording`` (a capture) nothing counts and the record holds
    the launches; each replay adds the record."""
    quant, dequant = ops.KERNELS["log_quantize"], ops.KERNELS["log_dequantize_rows"]
    ops.reset_launch_counts()
    try:
        launches.count(quant)
        with launches.recording() as record:
            for _ in range(3):
                launches.count(dequant)
            launches.count(quant)
            assert ops.launch_counts()["log_dequantize_rows"] == 0
            assert ops.launch_counts()["log_quantize"] == 1
            with pytest.raises(RuntimeError, match="already being recorded"):
                with launches.recording():
                    pass
        assert record == {dequant: 3, quant: 1}
        launches.replayed(record, 4)
        launches.replayed(record)
        counts = ops.launch_counts()
        assert counts["log_dequantize_rows"] == 15 and counts["log_quantize"] == 6
        assert sum(counts.values()) == 21
        launches.count(quant)  # the record is closed: counted again
        assert ops.launch_counts()["log_quantize"] == 7
    finally:
        ops.reset_launch_counts()


def test_attack_step_with_a_device_t_equals_the_jax_steps():
    """6 sign-Adam steps of ``make_attack_step`` (t a 0-dim f32 tensor,
    x, m, v updated in place) from the JAX package's own draw, against its
    jitted scan of the same 6 steps."""
    jp = jax_bench._init_net(jax.random.PRNGKey(0))
    img, y = jax_bench._target_image(), jax.numpy.array([3])
    tp = resnet_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    ty = torch.tensor([3])
    g_obs = jax_bench._grad_fn(jp, img, y)
    jcfg = JaxGIAConfig(steps=6, **ATTACK)
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    want_x, want_loss = jax_invert_batched(
        jax_bench._grad_fn, jp, g_obs, img.shape, y, keys, jcfg
    )
    x0 = jax.vmap(lambda k: jcfg.init_scale * jax.random.normal(k, img.shape))(keys)

    tg_obs = tree_map(lambda a: torch.from_numpy(np.array(a)), g_obs)
    step = make_attack_step(tbench._grad_fn, tp, tg_obs, ty, GIAConfig(**ATTACK))
    x = torch.from_numpy(np.array(x0))
    m, v = torch.zeros_like(x), torch.zeros_like(x)
    t = torch.zeros(())
    buffers = [b.data_ptr() for b in (x, m, v, t)]
    for _ in range(6):
        losses = step(x, m, v, t)
    assert [b.data_ptr() for b in (x, m, v, t)] == buffers
    assert t.dtype == torch.float32 and float(t) == 6.0
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_loss), rtol=1e-4)
    off = np.abs(x.numpy() - np.asarray(want_x)) > 1e-5
    assert off.reshape(2, -1).sum(1).max() <= 2, off.reshape(2, -1).sum(1)
