"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's
``models/moe.py``, on the CPU in f32.

Weights are the JAX package's seeded ``init_moe``, carried across as numpy;
inputs come from numpy with fixed seeds. Exact: the capacity, the dispatch
tables (token ids and, from the same probabilities, the slot weights), the
dropped count under a forced overflow. Where both frameworks route the same
tokens, the output and the gradients agree within atol 1e-5 of the largest
value (f32 products summed in other orders). The routing itself is fed from
the JAX package's choices there; the port's own choices against JAX's may
differ only where JAX's top-k margin is below ``FLIP_MARGIN``.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe
from repro.models.common import KeyGen
from repro_torch.configs import get_config
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import moe as tmoe
from repro_torch.weights import tensor_from_numpy

ARCH = "mixtral-8x7b"  # smoke: d 128, 4 experts, top-2, d_ff 256, cf 2.0
# A routing flip between the two frameworks needs their f32 router
# probabilities (~1e-7 apart) to straddle JAX's top-k boundary: a flip at a
# larger margin would be a routing fault, not rounding.
FLIP_MARGIN = 1e-5


def _cfgs(**kw):
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), **kw)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), **kw)
    return jcfg, cfg


def _params(jcfg, seed=0):
    jp = jax.tree.map(np.asarray, jmoe.init_moe(KeyGen(jax.random.PRNGKey(seed)), jcfg))
    return jp, tree_map(lambda a: tensor_from_numpy(a, "cpu"), jp)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_route(p, xf, k):
    """JAX's top-k (choices, probs) of the tokens xf (T, D), written as
    ``_moe_tokens`` and ``_dispatch_tables`` write it, so that inside the
    same jit XLA computes it once with theirs."""
    logits = xf.astype(jnp.float32) @ p["router"].astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    return jax.lax.top_k(probs, k)[1], probs


def _jax_choices(jp, x, k):
    return [np.asarray(a) for a in jax.jit(_jax_route, static_argnums=2)(jp, x, k)]


def test_capacity_matches_jax_on_a_grid():
    """moe_capacity: max(8, ceil8(int(T k / E cf))), over T, E, k and cf."""
    jcfg, cfg = _cfgs()
    n = 0
    for t in (1, 2, 7, 64, 100, 1024, 10240):
        for e in (4, 8, 16, 256):
            for k in (1, 2, 8):
                for cf in (1.0, 1.25, 2.0):
                    kw = dict(n_experts=e, experts_per_token=k, capacity_factor=cf)
                    want = jmoe.moe_capacity(t, dataclasses.replace(jcfg, **kw))
                    assert tmoe.moe_capacity(t, dataclasses.replace(cfg, **kw)) == want
                    n += 1
    assert n == 7 * 4 * 3 * 3
    full = get_config(ARCH)
    assert tmoe.moe_capacity(10240, full) == 3200  # mixtral prefill, 2 x 5120
    assert tmoe.moe_capacity(2, full) == 8  # its decode step


@functools.cache
def _jax_tables(cap):
    """JAX's ``_dispatch_tables`` and the probabilities and choices it
    computes inside, jitted once."""
    jcfg, _ = _cfgs()

    def f(p, x):
        top_i, probs = _jax_route(p, x, jcfg.experts_per_token)
        return (*jmoe._dispatch_tables(p, x, jcfg, cap), top_i, probs)

    return jax.jit(f)


@pytest.mark.parametrize("case", ["routed", "overflow"])
def test_dispatch_tables_and_aux_equal_jax(case):
    """``_dispatch_tables`` of one token set: from JAX's probabilities, the
    port's choices, (table, wtab) and load-balance loss equal JAX's bit for
    bit; from the tokens, the port's own router gives the same table, and
    wtab and loss within 1e-6 (the two f32 softmaxes differ in the last
    bits). In "routed" the capacity (8) is below the tokens' mean share, so
    ranks past it drop; in "overflow" a router sends every token to expert
    0 first and, the other three tied, to expert 1 (the lower index)
    second: 2 x 24 assignments into 2 x 8 slots, the rest dropped, the
    count JAX's."""
    jcfg, cfg = _cfgs()
    jp, p = _params(jcfg)
    t = 24
    x = _x((t, cfg.d_model), 1)
    if case == "overflow":
        router = np.zeros_like(jp["router"])
        router[:, 0] = 1.0
        jp = dict(jp, router=router)
        p = dict(p, router=torch.from_numpy(router))
        x = np.abs(x)
    cap = 8
    table, wtab, aux, top_i, probs = (
        np.array(a) for a in _jax_tables(cap)(jp, jnp.asarray(x))
    )
    got_i, w, got_aux = tmoe.route_probs(torch.from_numpy(probs)[None], cfg)
    np.testing.assert_array_equal(got_i[0].numpy(), top_i)
    got_table, got_wtab = tmoe.tables(got_i, w, cfg, cap)
    np.testing.assert_array_equal(got_table[0].numpy(), table)
    np.testing.assert_array_equal(got_wtab[0].numpy(), wtab)
    assert float(got_aux[0]) == float(aux)
    own_i, own_w, own_aux, _ = tmoe.route(p, torch.from_numpy(x)[None], cfg)
    own_table, own_wtab = (a[0] for a in tmoe.tables(own_i, own_w, cfg, cap))
    np.testing.assert_array_equal(own_table.numpy(), table)
    np.testing.assert_allclose(own_wtab.numpy(), wtab, rtol=1e-6, atol=1e-7)
    assert abs(float(own_aux[0]) - float(aux)) <= 1e-6 * float(aux)
    dropped = t * cfg.experts_per_token - int((table < t).sum())
    assert t * cfg.experts_per_token - int((own_table < t).sum()) == dropped
    if case == "overflow":
        assert dropped == 2 * t - 2 * cap
        assert (table[:2] < t).all() and (table[2:] == t).all()
    else:
        assert dropped > 0


@functools.cache
def _jax_moe_vjp(impl, shared):
    """JAX's moe_forward, its gradient and its own choices, jitted once."""
    jcfg, _ = _cfgs(moe_impl=impl, n_shared_experts=shared, capacity_factor=1.0)
    k = jcfg.experts_per_token

    def f(p, x, cot):
        y, aux = jmoe.moe_forward(p, x, jcfg, jcfg.mlp_act)
        if impl == "global":
            choices = _jax_route(p, x.reshape(-1, x.shape[-1]), k)[0][None]
        else:
            choices = jax.vmap(lambda xr: _jax_route(p, xr, k)[0])(x)
        return jnp.sum(y * cot) + 0.5 * aux, (y, aux, choices)

    return jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))


def _assert_close(got, want, label):
    want = np.asarray(want, np.float32)
    atol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=atol, err_msg=label)


@pytest.mark.parametrize(
    "impl, shared", [("global", 0), ("batched", 0), ("global", 1)]
)
def test_moe_forward_and_grads_match_jax_with_its_choices(impl, shared):
    """moe_forward's output, load-balance loss and gradients (every weight
    and the input, through sum(y * cot) + aux / 2) against JAX's, the
    port routed by JAX's own choices; capacity factor 1.0 so that some
    assignments drop. atol 1e-5 of each tensor's largest value."""
    jcfg, cfg = _cfgs(moe_impl=impl, n_shared_experts=shared, capacity_factor=1.0)
    jp, p = _params(jcfg, seed=3)
    b, s, d = 2, 20, cfg.d_model
    x, cot = _x((b, s, d), 4), _x((b, s, d), 5)
    (_, (y_want, aux_want, held)), (gp_want, gx_want) = _jax_moe_vjp(impl, shared)(
        jp, jnp.asarray(x), jnp.asarray(cot)
    )
    held = np.array(held)
    p = tree_map(lambda t: t.requires_grad_(True), p)
    xt = torch.from_numpy(x).requires_grad_(True)
    with tmoe.routing([torch.from_numpy(held)]) as rec:
        y, aux = tmoe.moe_forward(p, xt, cfg, cfg.mlp_act)
    assert len(rec.calls) == 1
    np.testing.assert_array_equal(rec.choices[0].numpy(), held)
    _assert_close(y, y_want, "y")
    assert abs(float(aux) - float(aux_want)) <= 1e-6 * abs(float(aux_want))
    obj = torch.sum(y * torch.from_numpy(cot)) + 0.5 * aux
    grads = torch.autograd.grad(obj, [xt, *tree_leaves(p)])
    _assert_close(grads[0], gx_want, "grad x")
    jleaves = jax.tree.leaves(jax.tree.map(np.asarray, gp_want))
    assert len(jleaves) == len(grads) - 1
    for g, w in zip(grads[1:], jleaves):
        _assert_close(g, w, "grad param")


def test_routing_flips_against_jax_lie_at_tiny_margins():
    """The port's own top-2 against JAX's on 4096 tokens: the same choices
    (ties to the lower index) but where JAX's margin between its k-th and
    (k+1)-th probability is below FLIP_MARGIN."""
    jcfg, cfg = _cfgs()
    jp, p = _params(jcfg, seed=6)
    x = _x((1, 4096, cfg.d_model), 7)
    k = cfg.experts_per_token
    want, probs = _jax_choices(jp, x[0], k)
    want, probs = want[None], probs[None]
    got = tmoe.route(p, torch.from_numpy(x), cfg)[0].numpy()
    flipped = (np.sort(got, -1) != np.sort(want, -1)).any(-1)[0]
    top = -np.sort(-probs[0], -1)
    margins = top[:, k - 1] - top[:, k]
    assert (margins[flipped] < FLIP_MARGIN).all(), margins[flipped]
    assert flipped.sum() <= 2, int(flipped.sum())
    # ties: equal probabilities pick the lower index first, as lax.top_k
    tied = torch.zeros((1, 3, cfg.d_model))
    assert tmoe.route(p, tied, cfg)[0].tolist() == [[[0, 1]] * 3]


def test_routing_records_and_holds_calls_in_order():
    """routing() records each call's choices and router logits; holding a
    recorded run's choices routes a perturbed input the same way, its
    weights and loss from its own probabilities."""
    _, cfg = _cfgs()
    _, p = _params(_cfgs()[0], seed=8)
    x = torch.from_numpy(_x((2, 10, cfg.d_model), 9))
    with tmoe.routing() as rec:
        y0, _ = tmoe.moe_forward(p, x, cfg)
        tmoe.moe_forward(p, 2 * x, cfg)
    assert len(rec.calls) == 2 and rec.calls[0][1].shape == (1, 20, cfg.n_experts)
    noisy = x + 0.3 * torch.from_numpy(_x(tuple(x.shape), 10))
    own = tmoe.route(p, noisy.reshape(1, 20, -1), cfg)[0]
    assert not torch.equal(own, rec.choices[0])
    with tmoe.routing(rec.choices) as held:
        tmoe.moe_forward(p, noisy, cfg)
        tmoe.moe_forward(p, noisy, cfg)
        with pytest.raises(RuntimeError, match="holds 2 calls"):
            tmoe.moe_forward(p, noisy, cfg)
    assert all(torch.equal(a, b) for a, b in zip(held.choices, rec.choices))
    assert torch.equal(tmoe.moe_forward(p, x, cfg)[0], y0)
