"""The port's lazy aggregation (``core/lazy.py`` and the composite's lazy
groups) against the JAX package's (``src/repro/core/lazy.py``).

* ``lazy_thresh = 0`` builds none of the machinery: the composite is the
  port's dedicated compressor bit for bit (all four methods, fused and
  unfused).
* Threaded syncs against the JAX composite on the same gradients: fire
  patterns, counters and effective bits exact; outputs and state within
  rtol 1e-5 / atol 1e-5 x the largest value. The inputs take clear margins
  (identical gradients skip, fresh ones fire), as the JAX tests do, since
  the decision psum sums in another order than XLA's.
* ``lazy_mode='elide'`` equals ``'gate'`` bit for bit in every output,
  state tensor and effective count; a skipped elide round records no
  gather.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np
from _torch_parity import (
    STACKED,
    assert_bit_equal,
    composite_pair,
    grads,
    jax_abstract,
    port_step,
    threaded,
    to_torch,
    torch_abstract,
)

from repro import core as jcore
from repro.core import lazy as jlazy
from repro.core import policy as jpolicy
from repro.roofline import hw as tpu_hw
from repro_torch.core import lazy
from repro_torch.core.comm import CommRecord, SimComm
from repro_torch.core.composite import CompositeCompressor, PolicySchedule
from repro_torch.core.compressors import CompressorConfig, LeafPolicy, make_compressor
from repro_torch.core.policy import CostModel, parse_policy_spec, plan_auto

N = 4


def _pols(method, thresh, max_stale, n=3, **kw):
    return [
        dict(
            method=method,
            rank=2,
            topk_ratio=0.1,
            lazy_thresh=thresh,
            max_stale=max_stale,
            **kw,
        )
    ] * n


def _threaded(jcomp, tcomp, grads_at, steps):
    hist, st = threaded(jcomp, tcomp, grads_at, steps)
    return [h[:2] for h in hist], st


# ------------------------------------------- lazy_thresh = 0 is eager
@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("name", ["topk", "qsgd", "powersgd", "lq_sgd"])
def test_lazy_thresh_zero_bit_for_bit_eager(name, fuse):
    cfg = CompressorConfig(
        name=name, rank=2, bits=8, topk_ratio=0.1, fuse_collectives=fuse
    )
    pols = [LeafPolicy(**p) for p in _pols(name, 0.0, 4)]
    eager = CompositeCompressor(cfg, torch_abstract(), STACKED, policies=pols)
    ded = make_compressor(cfg, torch_abstract(), STACKED)
    assert eager.lazy_groups == {} and eager.decision_bits_per_step() == 0
    st = eager.init_state(42, N, "cpu")
    assert not any(ns in st for ns in (lazy.OUT_NS, lazy.REF_NS, lazy.STALE_NS))
    assert eager.wire_bits_per_step() == ded.wire_bits_per_step()
    assert eager.expected_wire_bits_per_step() == eager.wire_bits_per_step()
    sd = ded.init_state(42, N, "cpu")
    for step in range(3):
        g = grads(step)
        od, sd, hd, _ = port_step(ded, g, sd)
        oe, st, he, _ = port_step(eager, g, st)
        assert_bit_equal(od, oe)
        assert hd == he


# ---------------------------------------------------- against the JAX path
def test_max_stale_forces_fire_pattern():
    """A never-voting threshold: fire at round 0 (the counter is born at
    the cap), then exactly max_stale skips, each one collective."""
    jcomp, tcomp = composite_pair(
        dict(name="lq_sgd", rank=2, fuse_collectives=True), _pols("lq_sgd", 1e6, 2)
    )
    hist, st = _threaded(jcomp, tcomp, lambda t: grads(100 + t), 7)
    fired, side = tcomp.wire_bits_per_step(), tcomp.decision_bits_per_step()
    assert side == 64 * 3 + 32
    assert [b for b, _ in hist] == [fired, side, side] * 2 + [fired]
    assert all(c == 1.0 for b, c in hist if b == side)
    assert int(st[lazy.STALE_NS]["lq_sgd"]) == 0


def test_skip_reuses_cached_aggregate_and_freezes_state():
    jcomp, tcomp = composite_pair(dict(name="lq_sgd", rank=2), _pols("lq_sgd", 1e6, 3))
    st0 = tcomp.init_state(0, N, "cpu")
    out0, st0, _, _ = port_step(tcomp, grads(0), st0)
    out1, st1, _, _ = port_step(tcomp, grads(99), st0)  # other grads, skipped
    assert_bit_equal(out0, out1)
    for ns in ("err", "q", lazy.OUT_NS, lazy.REF_NS):
        assert_bit_equal(st0[ns], st1[ns])
    assert int(st1[lazy.STALE_NS]["lq_sgd"]) == 1 and st1["step"] == 2


def test_small_innovation_skips_large_fires():
    """Identical gradients after round 0 skip (innovation ~ 0); a fresh
    gradient fires."""
    jcomp, tcomp = composite_pair(dict(name="powersgd", rank=2), _pols("powersgd", 0.5, 50))
    seeds = [7, 7, 7, 77]
    hist, _ = _threaded(jcomp, tcomp, lambda t: grads(seeds[t]), 4)
    fired, side = tcomp.wire_bits_per_step(), tcomp.decision_bits_per_step()
    assert [b for b, _ in hist] == [fired, side, side, fired]


def test_adaptive_thresholds_match_jax():
    """A group with the drift EMA on, against the JAX package's: the same
    decisions and the same tracker state over a run of shrinking
    gradients."""
    jcomp, tcomp = composite_pair(
        dict(name="lq_sgd", rank=2), _pols("lq_sgd", 0.5, 3, lazy_adaptive=4.0)
    )
    scales = [1.0, 1.0, 0.5, 0.5, 0.2, 1.0]
    _, st = _threaded(
        jcomp, tcomp, lambda t: grads(200 + t % 2, scale=scales[t]), len(scales)
    )
    assert lazy.EMA_NS in st and float(st[lazy.EMA_NS]["lq_sgd"][1]) > 0


def test_drift_tracker_and_threshold_scale_equal_jax():
    """``ema_update`` and ``tau_scale2`` over a sequence of drifts, fires
    and skips: the JAX package's values exactly (f32)."""
    rng = np.random.default_rng(5)
    ema, jema = torch.zeros(2), jnp.zeros(2)
    for step in range(12):
        drift = np.float32(rng.uniform(0.1, 10.0) * 0.8**step)
        fire = bool(step % 3 != 2)
        ema = lazy.ema_update(ema, torch.tensor(drift), torch.tensor(fire))
        jema = jlazy.ema_update(jema, jnp.asarray(drift), jnp.asarray(fire))
        np.testing.assert_array_equal(ema.numpy(), np.asarray(jema))
        for cap in (1.0, 2.5, 4.0):
            got = lazy.tau_scale2(ema, cap).numpy()
            np.testing.assert_array_equal(got, np.asarray(jlazy.tau_scale2(jema, cap)))
    assert float(lazy.tau_scale2(ema, 4.0)) > 1.0


def test_mixed_eager_and_lazy_leaves_split_groups():
    pol = dict(method="lq_sgd", rank=2)
    lazy_pol = dict(pol, lazy_thresh=1e6, max_stale=2)
    jcomp, tcomp = composite_pair(dict(name="lq_sgd", rank=2), [pol, lazy_pol, pol])
    assert tcomp.lazy_groups == {"lq_sgd": [1]}
    hist, _ = _threaded(jcomp, tcomp, lambda t: grads(300 + t), 2)
    h = tcomp.handlers["lq_sgd"]
    eager_bits = sum(h.leaf_wire_bits(tcomp.plans[i]) for i in (0, 2))
    lazy_bits = h.leaf_wire_bits(tcomp.plans[1])
    assert [b for b, _ in hist] == [eager_bits + lazy_bits + 96, eager_bits + 96]


def test_warmup_forces_fire():
    jcomp, tcomp = composite_pair(
        dict(name="lq_sgd", rank=2), _pols("lq_sgd", 1e6, 50), dict(warmup_steps=2)
    )
    hist, _ = _threaded(jcomp, tcomp, lambda t: grads(400 + t), 3)
    fired, side = tcomp.wire_bits_per_step(), tcomp.decision_bits_per_step()
    assert [b for b, _ in hist] == [fired, fired, side]


# ------------------------------------------------------------ elide = gate
@pytest.mark.parametrize(
    "name,state_dtype",
    [
        ("lq_sgd", "float32"),
        ("powersgd", "float32"),
        ("topk", "float32"),
        ("qsgd", "float32"),
        ("lq_sgd", "bfloat16"),
    ],
)
def test_elide_equals_gate_bit_for_bit(name, state_dtype):
    """Identical and fresh gradients in turn give fires and skips; every
    output, state tensor and effective count is equal in the two modes,
    and a skipped elide round gathers nothing."""
    seeds = [1, 1, 1, 2, 2, 3, 3, 3]
    outs, states, hists, gathers = {}, {}, {}, {}
    for mode in ("elide", "gate"):
        cfg = CompressorConfig(
            name=name,
            rank=2,
            fuse_collectives=True,
            lazy_mode=mode,
            state_dtype=state_dtype,
        )
        pols = [LeafPolicy(**p) for p in _pols(name, 0.5, 2)]
        comp = CompositeCompressor(cfg, torch_abstract(), STACKED, policies=pols)
        st = comp.init_state(5, N, "cpu")
        outs[mode], hists[mode], gathers[mode] = [], [], []
        for seed in seeds:
            comm = SimComm(N, record=True)
            out, st, rec = comp.sync(to_torch(grads(seed)), st, comm)
            outs[mode].append(out)
            hists[mode].append(
                (rec.effective_bits(), rec.effective_collectives(), rec.bits_sent)
            )
            gathers[mode].append(len(comm.gathered))
        states[mode] = st
    for a, b in zip(outs["elide"], outs["gate"]):
        assert_bit_equal(a, b)
    assert_bit_equal(states["elide"], states["gate"])
    for (eb, ec, es), (gb, gc, gs) in zip(hists["elide"], hists["gate"]):
        assert torch.equal(eb, gb) and torch.equal(ec, gc) and es == gs
    fired = [float(c) > 1 for _, c, _ in hists["elide"]]
    assert fired[0] and any(fired[1:]) and not all(fired)
    for f, n_elide, n_gate in zip(fired, gathers["elide"], gathers["gate"]):
        assert n_elide == (n_gate if f else 0)


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("name", ["topk", "qsgd", "powersgd", "lq_sgd"])
def test_elide_fire_accounting_equals_a_gated_fire(name, fuse):
    """The static accounting elide charges for a fire equals what the
    handler's sync records, per method, fused and unfused, with b4 and b8
    leaves in one group."""
    cfg = CompressorConfig(name=name, fuse_collectives=fuse, topk_ratio=0.1)
    pols = [
        LeafPolicy(method=name, bits=8, lazy_thresh=1.0),
        LeafPolicy(method=name, rank=2, bits=4, lazy_thresh=1.0),
        LeafPolicy(method=name, rank=2, bits=8, lazy_thresh=1.0),
    ]
    comp = CompositeCompressor(cfg, torch_abstract(), STACKED, policies=pols)
    g = to_torch(grads(0))
    (m, idxs), = comp.lazy_groups.items()
    items = [(i, g[k], comp.plans[i]) for i, k in zip(idxs, ("b", "scan", "w"))]
    rec = CommRecord()
    comp.handlers[m].sync_group(items, comp.init_state(0, N, "cpu"), SimComm(N), rec)
    assert comp._fired_accounting(m, idxs) == (rec.bits_sent, rec.n_collectives)


# --------------------------------------------------- plumbing and planner
def test_policy_validation_and_spec_knobs():
    with pytest.raises(ValueError, match="lazy_thresh"):
        LeafPolicy(lazy_thresh=-1.0)
    with pytest.raises(ValueError, match="max_stale"):
        LeafPolicy(lazy_thresh=0.5, max_stale=0)
    with pytest.raises(ValueError, match="lazy_adaptive"):
        LeafPolicy(lazy_adaptive=0.5)
    rules = parse_policy_spec("scan=lq_sgd:rank=2:lazy_thresh=1.5:max_stale=8,*=lq_sgd")
    assert (rules[0][1].lazy_thresh, rules[0][1].max_stale) == (1.5, 8)
    assert rules[1][1].lazy_thresh == 0.0
    comp = make_compressor(
        CompressorConfig(name="lq_sgd", lazy_thresh=1.5, max_stale=4),
        torch_abstract(),
        STACKED,
    )
    assert isinstance(comp, CompositeCompressor) and comp.lazy_groups
    with pytest.raises(ValueError, match="lazy_mode"):
        CompositeCompressor(
            CompressorConfig(lazy_mode="skip"), torch_abstract(), policies=[LeafPolicy()] * 3
        )


def test_p_fire_and_staleness_match_jax():
    for thresh in (0.0, 0.1, 0.5, 1.0, 2.0, 100.0):
        for stale in (1, 4, 8):
            assert lazy.p_fire(thresh, stale) == jlazy.p_fire(thresh, stale)
            assert lazy.staleness_err(thresh, stale) == jlazy.staleness_err(thresh, stale)
    assert lazy.p_fire(100.0, 4) == pytest.approx(1 / 5)


def test_auto_planner_trades_wire_for_staleness():
    kw = dict(name="lq_sgd", lazy_thresh=2.0, max_stale=8, policy="auto", error_budget=0.5)
    costs = CostModel(link_bw=tpu_hw.ICI_LINK_BW, peak_flops=tpu_hw.PEAK_FLOPS_BF16)
    pols, report = plan_auto(torch_abstract(), STACKED, cfg=CompressorConfig(**kw), cost_model=costs)
    jpols, jreport = jpolicy.plan_auto(jax_abstract(), STACKED, cfg=jcore.CompressorConfig(**kw))
    assert [dataclasses.asdict(p) for p in pols] == [dataclasses.asdict(p) for p in jpols]
    assert [r["wire_bits"] for r in report] == [r["wire_bits"] for r in jreport]
    assert any(p.lazy_thresh > 0 for p in pols)
    comp = CompositeCompressor(CompressorConfig(**kw), torch_abstract(), STACKED, policies=pols)
    assert sum(r["wire_bits"] for r in report) == comp.wire_bits_per_step()
    assert comp.expected_wire_bits_per_step() < comp.wire_bits_per_step()
    assert sum(comp.wire_bits_by_method().values()) == comp.wire_bits_per_step()


def test_schedule_decay_preserves_lazy_knobs():
    comp = CompositeCompressor(
        CompressorConfig(name="lq_sgd", rank=4),
        torch_abstract(),
        STACKED,
        policies=[LeafPolicy(**p) for p in _pols("lq_sgd", 1.5, 4)],
        schedule=PolicySchedule(decay=((10, 1, None),)),
    )
    c10 = comp.at_step(10)
    assert c10 is not comp and c10.lazy_groups == comp.lazy_groups
    assert all(p.lazy_thresh == 1.5 and p.max_stale == 4 for p in c10.policies)
    _, st, _, _ = port_step(comp, grads(0), comp.init_state(0, N, "cpu"))
    st10 = c10.adapt_state(st)
    assert set(st10) >= {lazy.OUT_NS, lazy.REF_NS, lazy.STALE_NS}
    assert all(v.shape[-1] == 1 for v in st10["q"].values())
    out, _, _, _ = port_step(c10, grads(1), st10)
    assert all(bool(torch.isfinite(v).all()) for v in out.values())
    np.testing.assert_equal(int(st10[lazy.STALE_NS]["lq_sgd"]), 0)


# ----------------------------------------- the decision over a rank's rows
class _RankRows(SimComm):
    """Rank ``rank`` of a process group whose ranks hold ``k`` of the N
    workers each; its gather returns every worker's statistics, as a
    gather across the ranks would (``full``, in global worker order)."""

    def __init__(self, full, k, rank):
        super().__init__(full.shape[0])
        self.full, self.k, self.rank = full, k, rank

    def local_size(self):
        return self.k

    def gather(self, x):
        assert torch.equal(x, self.full[self.workers()])
        return self.full


def test_group_decision_is_the_same_over_any_split_of_the_workers():
    """One leaf over 4 workers whose innovations sum to 1 in worker order
    but to 1 + 2^-23 as two ranks' partial sums (an f32 all-reduce of 2
    ranks x 2): with the threshold at 1 the two orders would disagree, and
    the decision, summed in worker order over a gather, is SimComm's on
    every rank of any split."""
    x = torch.tensor([[1.0], [0.0], [0.0], [0.0]])
    ref = torch.tensor([[0.0], [2.0**-12], [2.0**-12], [2.0**-12]])
    stale = torch.zeros((), dtype=torch.int32)

    def decide(comm, rows):
        rec = CommRecord()
        dec = lazy.group_decision([x[rows]], [ref[rows]], [1.0], stale, 4, comm, rec)
        return bool(dec.fire), int(dec.new_stale), (rec.bits_sent, rec.n_collectives)

    innov = (x - ref).square()
    assert float(innov.sum(0)) == 1.0  # the order SimComm sums in
    assert float(innov[:2].sum(0) + innov[2:].sum(0)) > 1.0  # two ranks' partials
    want = decide(SimComm(4), slice(None))
    assert want == (False, 1, (lazy.DECISION_BITS_PER_LEAF + 32, 1))
    stats = torch.cat([innov, x.square(), torch.zeros(4, 1)], dim=1)
    for k in (1, 2):
        for rank in range(4 // k):
            comm = _RankRows(stats, k, rank)
            assert decide(comm, comm.workers()) == want, (k, rank)
