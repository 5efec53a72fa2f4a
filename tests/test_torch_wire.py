"""The port's server wire (``core/wire.py:ServerWire``) and the composite's
server path against the JAX package's (``src/repro/core/wire.py``).

* At full participation the server wire is the symmetric wire bit for bit
  (all four methods, fused and unfused), plus the downlink tier.
* The participation draw is the port's own (a generator seeded by
  ``(seed, step)``): held statistically and for reproducibility. Every
  comparison with the JAX package feeds the port the JAX package's draws
  (``participation_mask``), so masks, counters and bits are exact, and
  outputs and state within rtol 1e-5 / atol 1e-5 x the largest value.
* Static bits equal ``BENCH_comm_cost.json``'s ``federated`` rows.
* Federated label skew: ``client_label_probs`` equals the JAX package's
  exactly; a client's labels follow its row statistically.
"""

import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from _torch_parity import (
    CNN_SHAPES,
    STACKED,
    assert_bit_equal,
    composite_pair,
    grads,
    port_step,
    threaded,
    torch_abstract,
)

from repro import core as jcore
from repro.core.comm import CommRecord as JaxRecord
from repro.data.synthetic import client_label_probs as jax_label_probs
from repro_torch.core import lazy
from repro_torch.core.comm import CommRecord, SimComm
from repro_torch.core.composite import CompositeCompressor
from repro_torch.core.compressors import CompressorConfig, LeafPolicy, make_compressor
from repro_torch.core.wire import (
    PARTICIPATION_FLAG_BITS,
    ServerWire,
    SymmetricWire,
    as_wire,
    participation_draw,
)
from repro_torch.data.synthetic import ImageDataConfig, client_label_probs, image_batch
from repro_torch.train.data_parallel import train_one

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 4


def _jax_flags(seed, step, n, p):
    """The JAX package's draw of round ``step`` (ServerWire.active)."""
    base = jax.random.fold_in(jax.random.PRNGKey(seed), jnp.asarray(step, jnp.int32))
    return np.array(
        [bool(jax.random.bernoulli(jax.random.fold_in(base, i), p)) for i in range(n)]
    )


def _server_pair(participation, thresh=1e-12, max_stale=1000, seed=0):
    kw = dict(
        name="lq_sgd",
        rank=2,
        topology="server",
        participation=participation,
        participation_seed=seed,
    )
    pol = dict(method="lq_sgd", rank=2, lazy_thresh=thresh, max_stale=max_stale)
    return composite_pair(kw, [pol] * 3)


def _threaded(jcomp, tcomp, grads_at, steps, p, seed=0):
    """The JAX package's draws injected as the port's masks."""
    mask_at = lambda t: torch.from_numpy(_jax_flags(seed, t, N, p))
    return threaded(jcomp, tcomp, grads_at, steps, mask_at)


# ---------------------------------------- full participation == symmetric
@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("name", ["topk", "qsgd", "powersgd", "lq_sgd"])
def test_server_full_participation_bit_for_bit(name, fuse):
    kw = dict(name=name, rank=2, bits=8, topk_ratio=0.1, fuse_collectives=fuse)
    sym = make_compressor(CompressorConfig(**kw), torch_abstract(), STACKED)
    srv = make_compressor(
        CompressorConfig(topology="server", **kw), torch_abstract(), STACKED
    )
    ss, sv = sym.init_state(42, N, "cpu"), srv.init_state(42, N, "cpu")
    for step in range(3):
        g = grads(step)
        os_, ss, hs, _ = port_step(sym, g, ss)
        ov, sv, hv, _ = port_step(srv, g, sv)
        assert_bit_equal(os_, ov)
        assert hs[:2] == hv[:2] and hs[2] == 0
        assert hv[2] == 32 * sum(int(np.prod(pl.shape)) for pl in srv.plans)
    assert_bit_equal(ss, sv)


def test_server_lazy_always_fire_matches_eager_composite():
    cfg = CompressorConfig(name="lq_sgd", rank=2)
    eager = CompositeCompressor(
        cfg, torch_abstract(), STACKED, policies=[LeafPolicy(rank=2)] * 3
    )
    pol = LeafPolicy(rank=2, lazy_thresh=1e-12, max_stale=1000)
    srv = CompositeCompressor(
        CompressorConfig(name="lq_sgd", rank=2, topology="server"),
        torch_abstract(),
        STACKED,
        policies=[pol] * 3,
    )
    se, sv = eager.init_state(0, N, "cpu"), srv.init_state(0, N, "cpu")
    for step in range(3):
        g = grads(100 + step)
        oe, se, he, _ = port_step(eager, g, se)
        ov, sv, hv, _ = port_step(srv, g, sv)
        assert_bit_equal(oe, ov)
        assert hv[0] == he[0] + lazy.SERVER_DECISION_BITS_PER_GROUP


# -------------------------------------------- against JAX, draws injected
def test_server_dropout_lazy_matches_jax():
    """Participation 0.5 and a lazy threshold that sometimes votes: the
    JAX package's draws injected; per-worker staleness, effective bits and
    the frozen error feedback of absent workers as in JAX."""
    jcomp, tcomp = _server_pair(0.5, thresh=0.5, max_stale=4)
    hist, st = _threaded(jcomp, tcomp, lambda t: grads(200 + t // 2), 5, 0.5)
    assert st[lazy.STALE_NS]["lq_sgd"].shape == (N,)
    assert len({c for _, c, _ in hist}) == 1  # the collective count is static


def test_per_worker_staleness_tracks_participation():
    jcomp, tcomp = _server_pair(0.5)
    _, st = _threaded(jcomp, tcomp, lambda t: grads(300 + t), 4, 0.5)
    stale = np.full(N, 1000)
    for t in range(4):
        stale = np.where(_jax_flags(0, t, N, 0.5), 0, stale + 1)
    np.testing.assert_array_equal(st[lazy.STALE_NS]["lq_sgd"].numpy(), stale)


def test_dropout_freezes_absent_workers_error_feedback():
    flags = _jax_flags(0, 0, N, 0.5)
    assert 0 < flags.sum() < N
    _, tcomp = _server_pair(0.5)
    st = tcomp.init_state(0, N, "cpu")
    mask = torch.from_numpy(flags)
    _, st, _, _ = port_step(tcomp, grads(400), st, participation_mask=mask)
    for k, e in st["err"].items():
        moved = np.array([bool(e[i].any()) for i in range(N)])
        np.testing.assert_array_equal(moved, flags, err_msg=k)


def test_server_decision_sideband_accounting():
    """A never-voting threshold and a staleness cap: the symmetric fire
    pattern, one 32-bit flag gather a group, and every payload collective
    on a skipped round too."""
    jcomp, tcomp = _server_pair(1.0, thresh=1e6, max_stale=3)
    assert tcomp.decision_bits_per_step() == lazy.SERVER_DECISION_BITS_PER_GROUP
    hist, _ = _threaded(jcomp, tcomp, lambda t: grads(500), 5, 1.0)
    fired, side = tcomp.wire_bits_per_step(), lazy.SERVER_DECISION_BITS_PER_GROUP
    assert [b for b, _, _ in hist] == [fired, side, side, side, fired]
    assert len({c for _, c, _ in hist}) == 1
    jhalf, half = _server_pair(0.5)
    assert half.expected_wire_bits_per_step() < half.wire_bits_per_step()
    assert half.expected_wire_bits_per_step() == jhalf.expected_wire_bits_per_step()


def test_server_init_state_has_no_aggregate_cache():
    _, tcomp = _server_pair(0.5)
    st = tcomp.init_state(0, N, "cpu")
    assert lazy.OUT_NS not in st and lazy.REF_NS in st and lazy.STALE_NS in st


# ----------------------------------------------------- aggregation math
def test_participation_weighted_average_and_pmean():
    """The JAX package's draw injected: average, pmean and the 32-bit
    sideband equal the JAX wire's."""
    p, seed, step = 0.6, 3, 7
    flags = _jax_flags(seed, step, N, p)
    assert 0 < flags.sum() < N
    x = np.arange(1.0, N + 1, dtype=np.float32)

    def worker(xi):
        rec = JaxRecord()
        w = jcore.ServerWire(("data",), participation=p, seed=seed, step=step)
        w.prepare(rec)
        return w.average(w.all_gather(xi)), w.pmean(xi), w.active()

    javg, jpm, jact = jax.vmap(worker, axis_name="data")(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(jact), flags)
    w = ServerWire(SimComm(N), participation=p, mask=torch.from_numpy(flags))
    rec = CommRecord()
    w.prepare(rec)
    xt = torch.from_numpy(x)
    assert rec.bits_sent == PARTICIPATION_FLAG_BITS and rec.n_collectives == 1
    np.testing.assert_allclose(w.average(w.all_gather(xt)).numpy(), javg[0], rtol=1e-6)
    np.testing.assert_allclose(w.pmean(xt).numpy(), jpm[0], rtol=1e-6)


def test_sparsity_agg_counts_nonzero_contributions():
    w = ServerWire(SimComm(2), agg="sparsity", device="cpu")
    stacked = torch.tensor([[1.0, 0.0, 0.0], [3.0, 4.0, 0.0]])
    jw = jcore.ServerWire(("data",), agg="sparsity")
    np.testing.assert_allclose(w.average(stacked).numpy(), [2.0, 4.0, 0.0])
    np.testing.assert_array_equal(
        w.average(stacked).numpy(), np.asarray(jw.average(jnp.asarray(stacked.numpy())))
    )
    dense = torch.tensor([[1.0, 2.0], [3.0, 6.0]])
    np.testing.assert_allclose(w.average(dense).numpy(), [2.0, 4.0])


def test_wire_validation_and_routing():
    with pytest.raises(RuntimeError, match="prepare"):
        ServerWire(SimComm(N), participation=0.5, device="cpu").weights()
    assert ServerWire(SimComm(N), device="cpu").weights() is None
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError, match="participation"):
            ServerWire(SimComm(N), participation=bad)
    with pytest.raises(ValueError, match="agg"):
        ServerWire(SimComm(N), agg="mean")
    with pytest.raises(ValueError, match="mask"):
        ServerWire(SimComm(N), mask=torch.ones(N + 1, dtype=torch.bool))
    with pytest.raises(ValueError, match="topology"):
        as_wire(SimComm(N), topology="ring")
    w = SymmetricWire(SimComm(N))
    assert as_wire(w, topology="server") is w
    with pytest.raises(ValueError, match="topology"):
        make_compressor(CompressorConfig(name="qsgd", topology="ring"), torch_abstract())
    comp = make_compressor(
        CompressorConfig(name="qsgd", topology="server", participation=0.5),
        torch_abstract(),
        STACKED,
    )
    assert isinstance(comp, CompositeCompressor)


def test_participation_draw_rate_and_reproducible():
    """2000 rounds of 4 workers at 0.5: the rate within 4 sd; the same
    (seed, step) gives the same flags, and the rounds differ."""
    p, rounds = 0.5, 2000
    draws = torch.stack([participation_draw(1, t, N, p, "cpu") for t in range(rounds)])
    rate, sd = float(draws.float().mean()), (p * (1 - p) / (rounds * N)) ** 0.5
    assert abs(rate - p) < 4 * sd
    assert torch.equal(participation_draw(1, 17, N, p, "cpu"), draws[17])
    assert len({tuple(d.tolist()) for d in draws[:64]}) > 8
    w = ServerWire(SimComm(N), participation=p, seed=1, step=17, device="cpu")
    assert torch.equal(w.active(), draws[17])


# ------------------------------------------ BENCH_comm_cost.json, exactly
FEDERATED = {
    "eager": dict(),
    "server_full": dict(topology="server"),
    "dropout_p0.5": dict(topology="server", participation=0.5),
}


@pytest.mark.parametrize("row", sorted(FEDERATED))
def test_federated_static_bits_equal_the_committed_table(row):
    """The mini-CNN's lq_sgd r1 b8 fused: 13104 bits a step, and 32 more
    for the participation flag under drop-out (0.001642 MB/step); the
    downlink 32 x the parameter count; the collectives of a step."""
    bench = json.loads((ROOT / "BENCH_comm_cost.json").read_text())["federated"]
    want = {r["name"]: r for r in bench["results"]}[row]
    cfg = CompressorConfig(name="lq_sgd", rank=1, bits=8, fuse_collectives=True, **FEDERATED[row])
    comp = make_compressor(cfg, torch_abstract(CNN_SHAPES))
    g = grads(600, shapes=CNN_SHAPES)
    _, _, hist, _ = port_step(comp, g, comp.init_state(0, N, "cpu"))
    assert round(hist[0] / 8e6, 6) == want["wire_mb_per_step"]
    assert hist[1] == want["collectives_per_step"]
    assert hist[2] / 8e6 == pytest.approx(want["down_mb_per_step"], abs=1e-12)


# ----------------------------------------------------- federated label skew
def test_client_label_probs_equal_jax_and_labels_follow_them():
    got, want = client_label_probs(10, 5, 0.3, seed=2), jax_label_probs(10, 5, 0.3, seed=2)
    np.testing.assert_array_equal(got, want)
    cfg = ImageDataConfig(batch=4000, hw=4, noniid_alpha=0.3, n_clients=5, seed=2)
    for client in (0, 3):
        labels = image_batch(cfg, 0, "cpu", client=client)["labels"]
        freq = np.bincount(labels.numpy(), minlength=10) / cfg.batch
        sd = np.sqrt(got[client] * (1 - got[client]) / cfg.batch)
        assert np.all(np.abs(freq - got[client]) <= 4 * sd + 1e-12)
    with pytest.raises(ValueError, match="alpha"):
        client_label_probs(10, 5, 0.0)


def test_train_one_federated_on_the_cpu():
    """The (i3) setting, tiny: server wire, drop-out, lazy, label skew."""
    cfg = CompressorConfig(
        name="lq_sgd",
        fuse_collectives=True,
        topology="server",
        participation=0.5,
        lazy_thresh=1.5,
        max_stale=4,
    )
    out = train_one(
        cfg, model="cnn", n_workers=3, batch=4, hw=8, steps=3, device="cpu",
        noniid_alpha=0.3,
    )
    assert all(np.isfinite(out.losses))
    assert all(st.rec.down_bits == 32 * 24122 for st in out.steps)
    assert out.comp_state[lazy.STALE_NS]["lq_sgd"].shape == (3,)


# ------------------------------------------------- one rank's rows of a round
class _RankRows(SimComm):
    """Rank ``rank`` of a process group whose ranks hold ``k`` of the
    ``n`` workers each (no collective is called)."""

    def __init__(self, n, k, rank):
        super().__init__(n)
        self.k, self.rank = k, rank

    def local_size(self):
        return self.k


@pytest.mark.parametrize("rank", [0, 1])
def test_server_wire_active_is_this_ranks_rows_of_the_draw(rank):
    """A rank holding k of N workers acts on its rows of the round's (N,)
    draw (and of an (N,) mask passed in), which every rank makes whole."""
    comm = _RankRows(N, 2, rank)
    rows = slice(2 * rank, 2 * rank + 2)
    draw = participation_draw(3, 17, N, 0.5, "cpu")
    w = ServerWire(comm, participation=0.5, seed=3, step=17, device="cpu")
    assert torch.equal(w.active(), draw[rows])
    mask = torch.tensor([True, False, False, True])
    w = ServerWire(comm, participation=0.5, mask=mask)
    assert torch.equal(w.active(), mask[rows])
    with pytest.raises(ValueError, match="participation mask"):
        ServerWire(comm, participation=0.5, mask=mask[rows])
