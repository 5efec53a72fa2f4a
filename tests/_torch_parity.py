"""Shared fixtures of the composite parity tests (``test_torch_policy.py``,
``test_torch_lazy.py``, ``test_torch_wire.py``).

The JAX side runs a compressor's ``sync`` under ``jax.vmap`` over N workers
(``tests/conftest.py::simulate_workers`` semantics), jitted once per
compressor; the port's side runs on ``SimComm(N)``. Both get the same
numpy-seeded gradients, and the port starts from the JAX package's
warm-start Q. Tolerances: rtol 1e-5, atol 1e-5 x the largest value, as in
``tests/test_torch_compressors.py``; counters, bits and collectives exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import core as jcore
from repro.core import AxisComm
from repro_torch.core.comm import SimComm
from repro_torch.core.composite import CompositeCompressor, PolicySchedule
from repro_torch.core.compressors import CompressorConfig, LeafPolicy

N = 4
SHAPES = {"w": (64, 32), "b": (32,), "scan": (3, 48, 16)}
STACKED = {"w": False, "b": False, "scan": True}
# the reference's 4-conv mini-CNN (benchmarks/convergence.py:_init_cnn)
CNN_SHAPES = {
    "c1": (3, 3, 3, 16),
    "c2": (3, 3, 16, 32),
    "c3": (3, 3, 32, 64),
    "w": (64, 10),
    "b": (10,),
}


def grads(seed, n=N, scale=1.0, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return {
        k: (scale * rng.standard_normal((n,) + s)).astype(np.float32)
        for k, s in shapes.items()
    }


def jax_abstract(shapes=SHAPES):
    return {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in shapes.items()}


def torch_abstract(shapes=SHAPES):
    return {k: torch.empty(s, device="meta") for k, s in shapes.items()}


def to_torch(g):
    return {k: torch.from_numpy(v) for k, v in g.items()}


class JaxRun:
    """A JAX compressor's threaded syncs over N vmap'd workers."""

    def __init__(self, comp, n=N):
        self.comp = comp
        self.state0 = comp.init_state(jax.random.PRNGKey(42))
        self.state = jax.tree.map(
            lambda x: jnp.broadcast_to(x[None], (n,) + x.shape), self.state0
        )

        def worker(g, st):
            out, st2, rec = comp.sync(g, st, AxisComm(("data",)))
            return (
                out,
                st2,
                jnp.asarray(rec.effective_bits(), jnp.float32),
                jnp.asarray(rec.effective_collectives(), jnp.float32),
                jnp.asarray(rec.down_bits, jnp.float32),
            )

        self._step = jax.jit(jax.vmap(worker, axis_name="data"))

    def step(self, g):
        """One sync of numpy grads (N, ...) -> (outs (N, ...), (bits,
        collectives, down bits) of worker 0)."""
        out, self.state, eb, ec, db = self._step(
            {k: jnp.asarray(v) for k, v in g.items()}, self.state
        )
        hist = (float(eb[0]), float(ec[0]), float(db[0]))
        return jax.tree.map(np.asarray, out), hist


def composite_pair(kw, policies, schedule=None, jax_kw=None):
    """The same composite on both sides: ``kw`` the config's fields,
    ``policies`` LeafPolicy kwargs in flatten order (b, scan, w),
    ``schedule`` PolicySchedule kwargs; ``jax_kw`` more config fields for
    the JAX side only."""
    jcomp = jcore.CompositeCompressor(
        jcore.CompressorConfig(**kw, **(jax_kw or {})),
        jax_abstract(),
        STACKED,
        policies=[jcore.LeafPolicy(**p) for p in policies],
        schedule=jcore.PolicySchedule(**(schedule or {})),
    )
    tcomp = CompositeCompressor(
        CompressorConfig(**kw),
        torch_abstract(),
        STACKED,
        policies=[LeafPolicy(**p) for p in policies],
        schedule=PolicySchedule(**(schedule or {})),
    )
    return jcomp, tcomp


def threaded(jcomp, tcomp, grads_at, steps, mask_at=None):
    """Both sides through ``steps`` syncs of ``grads_at(step)`` (the port
    given ``mask_at(step)`` as its participation mask): every step's
    (bits, collectives, down bits) equal, outputs close, and the final
    states close. Returns the port's per-step counts and final state."""
    jrun = JaxRun(jcomp)
    tstate = port_state(tcomp, jrun)
    hist = []
    for step in range(steps):
        g = grads_at(step)
        kw = {} if mask_at is None else dict(participation_mask=mask_at(step))
        jout, jh = jrun.step(g)
        tout, tstate, th, _ = port_step(tcomp, g, tstate, **kw)
        assert th == jh, (step, th, jh)
        hist.append(th)
        assert_outs_close(tout, jout, g)
    assert_state_close(tstate, jrun.state)
    return hist, tstate


def port_state(tcomp, jrun, n=N):
    """The port's initial state, its warm-start Q the JAX package's."""
    st = tcomp.init_state(0, n, "cpu")
    for k, q in jrun.state0.get("q", {}).items():
        q = torch.from_numpy(np.array(q))
        st["q"][k] = q.expand((n,) + q.shape).clone()
    return st


def port_step(tcomp, g, state, **kw):
    """One port sync -> (outs, state, (bits, collectives, down bits), rec)."""
    out, state, rec = tcomp.sync(to_torch(g), state, SimComm(N), **kw)
    hist = (
        float(rec.effective_bits()),
        float(rec.effective_collectives()),
        float(rec.down_bits),
    )
    return out, state, hist, rec


def assert_outs_close(tout, jout, g):
    """The port's synced leaves (all of ``tout``) against worker 0's."""
    for k, got in tout.items():
        want = jout[k][0]
        scale = max(np.abs(g[k]).max(), np.abs(want).max())
        np.testing.assert_allclose(
            got.numpy(), want, rtol=1e-5, atol=1e-5 * scale, err_msg=k
        )


def assert_state_close(tstate, jstate, skip=("key",)):
    """Every namespace of the port's state against the JAX package's
    vmap'd one: a tensor with the worker dim against all of it, one
    without (the same on every worker) against worker 0."""
    assert set(tstate) - set(skip) == set(jstate) - set(skip)
    for ns, sub in tstate.items():
        if ns in skip:
            continue
        if ns == "step":
            assert sub == int(np.asarray(jstate["step"])[0])
            continue
        assert set(sub) == set(jstate[ns]), ns
        for key, t in sub.items():
            want = np.asarray(jstate[ns][key])
            if tuple(t.shape) != want.shape:
                assert np.all(want == want[:1]), (ns, key)
                want = want[0]
            got = t.float().numpy()
            if t.dtype in (torch.int32, torch.int64):
                np.testing.assert_array_equal(got, want, err_msg=f"{ns}/{key}")
                continue
            atol = 1e-5 * max(np.abs(want).max(), 1)
            np.testing.assert_allclose(
                got, want, rtol=1e-5, atol=atol, err_msg=f"{ns}/{key}"
            )


def assert_bit_equal(a, b):
    """Two port trees (or dicts of dicts) equal bit for bit."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_bit_equal(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b
