"""The port's per-leaf policies and composite compressor against the JAX
package's (``src/repro/core/{policy,composite}.py``).

* A uniform composite equals the port's dedicated compressor bit for bit
  (topk, qsgd, powersgd, lq_sgd; fused and unfused), and a uniform raw
  composite equals ``none``.
* Mixed policies, per-leaf bit subgroups, warm-up and decay: threaded syncs
  against the JAX composite on the same gradients, within rtol 1e-5 /
  atol 1e-5 x the largest value; bits and collectives exact. QSGD's draws
  are the port's own, so a QSGD leaf is held by its bits only.
* The planner with the JAX package's TPU constants injected picks the JAX
  package's policies; the port's default constants are the H100's.
* Static bits equal ``BENCH_comm_cost.json``'s ``policy_sweep`` exactly.
"""

import dataclasses
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (
    CNN_SHAPES,
    STACKED,
    JaxRun,
    assert_bit_equal,
    composite_pair,
    assert_outs_close,
    assert_state_close,
    grads,
    jax_abstract,
    port_state,
    port_step,
    torch_abstract,
)

from repro import core as jcore
from repro.core import policy as jpolicy
from repro.roofline import hw as tpu_hw
from repro_torch.core.comm import SimComm
from repro_torch.core.composite import CompositeCompressor, PolicySchedule
from repro_torch.core.compressors import CompressorConfig, LeafPolicy, make_compressor
from repro_torch.core.policy import (
    CostModel,
    format_plan_report,
    match_policies,
    parse_decay_spec,
    parse_policy_spec,
    plan_auto,
    resolve_policies,
    uniform_policy,
)
from repro_torch.roofline import hw as h100_hw

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 4
TPU_COSTS = dict(link_bw=tpu_hw.ICI_LINK_BW, peak_flops=tpu_hw.PEAK_FLOPS_BF16)


# --------------------------------------------------- uniform == dedicated
@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("name", ["topk", "qsgd", "powersgd", "lq_sgd"])
def test_uniform_composite_bit_for_bit(name, fuse):
    cfg = CompressorConfig(
        name=name, rank=2, bits=8, topk_ratio=0.1, fuse_collectives=fuse
    )
    ded = make_compressor(cfg, torch_abstract(), STACKED)
    pol = LeafPolicy(method=ded.method, rank=2, bits=8, topk_ratio=0.1)
    uni = CompositeCompressor(cfg, torch_abstract(), STACKED, policies=[pol] * 3)
    sd, su = ded.init_state(42, N, "cpu"), uni.init_state(42, N, "cpu")
    for step in range(3):
        g = grads(step)
        od, sd, hd, rd = port_step(ded, g, sd)
        ou, su, hu, ru = port_step(uni, g, su)
        assert_bit_equal(od, ou)
        assert hd == hu and ru.bits_sent == ded.wire_bits_per_step()
    for ns in ded.handler.namespaces:
        assert_bit_equal(sd[ns], su[ns])
    assert ded.wire_bits_per_step() == uni.wire_bits_per_step()
    assert uni.handlers[ded.method].group_collectives(uni.plans) == rd.n_collectives


def test_uniform_raw_composite_matches_none():
    cfg = CompressorConfig(name="none")
    ded = make_compressor(cfg, torch_abstract(), STACKED)
    uni = CompositeCompressor(
        cfg, torch_abstract(), STACKED, policies=[LeafPolicy(method="raw")] * 3
    )
    g = grads(1)
    od, _, hd, _ = port_step(ded, g, ded.init_state(0, N, "cpu"))
    ou, _, hu, _ = port_step(uni, g, uni.init_state(0, N, "cpu"))
    assert_bit_equal(od, ou)
    assert hd == hu


# ------------------------------------------- threaded syncs against JAX
MIXED = [
    dict(method="lq_sgd", rank=2, bits=4),  # b: the raw route, quantized
    dict(method="topk", topk_ratio=0.1),  # scan
    dict(method="qsgd", bits=8),  # w
]


def test_mixed_policy_groups_state_and_accounting():
    """Three method groups, merged state, per-method accounting; the QSGD
    leaf (the port's own draws) is held by its bits."""
    jcomp, tcomp = composite_pair(dict(name="lq_sgd"), MIXED)
    jrun = JaxRun(jcomp)
    tstate = port_state(tcomp, jrun)
    assert set(tstate) == set(jrun.state0) == {"step", "err", "q", "key"}
    for step in range(2):
        g = grads(10 + step)
        jout, jh = jrun.step(g)
        tout, tstate, th, rec = port_step(tcomp, g, tstate)
        assert th == jh and rec.bits_sent == tcomp.wire_bits_per_step()
        assert_outs_close({k: tout[k] for k in ("b", "scan")}, jout, g)
    assert_state_close(tstate, jrun.state)
    by_method = tcomp.wire_bits_by_method()
    assert by_method == jcomp.wire_bits_by_method()
    assert sum(by_method.values()) == tcomp.wire_bits_per_step()
    assert tcomp.physical_bits_by_method() == jcomp.physical_bits_by_method()


@pytest.mark.parametrize("bits", [4, 16])
def test_per_leaf_bits_subgroup_one_phase_per_wire_dtype(bits):
    """b8 leaves and a b4 (or b16) leaf in one lq_sgd group: one fused phase
    pair per wire dtype (P 4 + Q 4 + the raw leaf's pmax and gather = 10
    collectives), bits and collectives as in JAX. Values are compared at
    b4, the card's case; at b16 a bin-edge code flip from the two
    frameworks' f32 sums moves a value by ~1e-4 relative, above the f32
    tolerance, so b16 is held on its accounting."""
    pols = [
        dict(method="lq_sgd", bits=8),
        dict(method="lq_sgd", rank=2, bits=bits),
        dict(method="lq_sgd", rank=2, bits=8),
    ]
    jcomp, tcomp = composite_pair(dict(name="lq_sgd", fuse_collectives=True), pols)
    jrun = JaxRun(jcomp)
    tstate = port_state(tcomp, jrun)
    for step in range(2):
        g = grads(20 + step)
        jout, jh = jrun.step(g)
        tout, tstate, th, rec = port_step(tcomp, g, tstate)
        assert rec.n_collectives == 10 and th == jh
        assert rec.bits_sent == tcomp.wire_bits_per_step()
        if bits == 4:
            assert_outs_close(tout, jout, g)
    if bits == 4:
        assert_state_close(tstate, jrun.state)


def test_pallas_backend_reference_matches_the_port():
    """The JAX side through its Pallas kernels (interpret mode): the port's
    uniform lq_sgd composite, b4 fused, still agrees."""
    pols = [dict(method="lq_sgd", rank=2, bits=4)] * 3
    jcomp, tcomp = composite_pair(
        dict(name="lq_sgd", bits=4, fuse_collectives=True),
        pols,
        jax_kw=dict(quant_backend="pallas"),
    )
    jrun = JaxRun(jcomp)
    tstate = port_state(tcomp, jrun)
    for step in range(2):
        g = grads(30 + step)
        jout, jh = jrun.step(g)
        tout, tstate, th, _ = port_step(tcomp, g, tstate)
        assert th == jh
        assert_outs_close(tout, jout, g)
    assert_state_close(tstate, jrun.state)


def test_warmup_full_precision_then_compressed():
    """Warm (W = 2): the exact f32 mean, error feedback at zero, warm Q
    advancing as in JAX; then compressed, lossy, error feedback moving."""
    pols = [dict(method="lq_sgd", rank=2)] * 3
    jcomp, tcomp = composite_pair(dict(name="lq_sgd", rank=2), pols, dict(warmup_steps=2))
    jrun = JaxRun(jcomp)
    tstate = port_state(tcomp, jrun)
    for step in range(4):
        g = grads(40 + step)
        jout, jh = jrun.step(g)
        tout, tstate, th, _ = port_step(tcomp, g, tstate)
        assert th == jh
        assert_outs_close(tout, jout, g)
        assert_state_close(tstate, jrun.state)
        exact = torch.from_numpy(g["w"]).mean(0)
        dev = float((tout["w"] - exact).norm() / exact.norm())
        err_moved = any(bool(v.any()) for v in tstate["err"].values())
        assert (dev < 1e-5 and not err_moved) if step < 2 else (dev > 1e-4)
    assert tstate["step"] == 4
    assert tcomp.warmup_extra_bits() == jcomp.warmup_extra_bits() > 0


def test_decay_phases_and_state_adaptation():
    pols = [dict(method="lq_sgd", rank=4, bits=8)] * 3
    sched = dict(decay=((10, 2, None), (20, 1, 4)))
    jcomp, tcomp = composite_pair(dict(name="lq_sgd", rank=4, bits=8), pols, sched)
    assert tcomp.schedule.boundaries() == [10, 20]
    assert tcomp.at_step(5) is tcomp
    for t in (10, 20):
        tc, jc = tcomp.at_step(t), jcomp.at_step(t)
        assert [pl.eff_rank for pl in tc.plans] == [pl.eff_rank for pl in jc.plans]
        assert tc.wire_bits_per_step() == jc.wire_bits_per_step()
        assert [p.bits for p in tc.policies] == [p.bits for p in jc.policies]
    # state carries across: err kept, warm Q truncated; the phase runs on
    jrun = JaxRun(jcomp)
    tstate = port_state(tcomp, jrun)
    g = grads(50)
    jrun.step(g)
    _, tstate, _, _ = port_step(tcomp, g, tstate)
    c10, j10 = tcomp.at_step(10), jcomp.at_step(10)
    tstate, jrun.state = c10.adapt_state(tstate), j10.adapt_state(jrun.state)
    assert_state_close(tstate, jrun.state)
    jrun10 = JaxRun(j10)
    jrun10.state = jrun.state
    g = grads(51)
    jout, jh = jrun10.step(g)
    tout, tstate, th, _ = port_step(c10, g, tstate)
    assert th == jh
    assert_outs_close(tout, jout, g)
    assert_state_close(tstate, jrun10.state)


def test_warmup_end_is_a_rebuild_boundary():
    cfg = CompressorConfig(name="lq_sgd", rank=2)
    sched = PolicySchedule(warmup_steps=2, decay=((10, 1, None),))
    comp = CompositeCompressor(
        cfg,
        torch_abstract(),
        STACKED,
        policies=[LeafPolicy(method="lq_sgd", rank=2)] * 3,
        schedule=sched,
    )
    assert sched.boundaries() == [2, 10] and comp.at_step(1) is comp
    steady = comp.at_step(2)
    assert steady is not comp and steady.schedule.warmup_steps == 0
    assert comp.warmup_extra_bits() > 0 and steady.warmup_extra_bits() == 0
    assert steady.wire_bits_per_step() == comp.wire_bits_per_step()


def test_per_leaf_min_numel_override():
    abstract = {"w": torch.empty(20, 10, device="meta")}
    cfg = CompressorConfig(name="lq_sgd", rank=1)
    default = CompositeCompressor(cfg, abstract, policies=[LeafPolicy()])
    forced = CompositeCompressor(cfg, abstract, policies=[LeafPolicy(min_numel=128)])
    assert default.plans[0].route == "raw" and forced.plans[0].route == "lowrank"
    assert forced.wire_bits_per_step() < default.wire_bits_per_step()


# --------------------------------------------------------- specs, routing
def _fields(pol):
    return dataclasses.asdict(pol)


def test_parse_specs_match_jax():
    spec = "scan=lq_sgd:rank=2:bits=4:lazy_thresh=1.5:max_stale=8,w=topk:topk_ratio=0.05,*=lq_sgd:bits=8"
    got, want = parse_policy_spec(spec), jpolicy.parse_policy_spec(spec)
    assert [(p, _fields(q)) for p, q in got] == [(p, _fields(q)) for p, q in want]
    pols = match_policies(torch_abstract(), got, LeafPolicy(method="raw"))
    jpols = jpolicy.match_policies(jax_abstract(), want, jcore.LeafPolicy(method="raw"))
    assert [_fields(p) for p in pols] == [_fields(p) for p in jpols]
    assert parse_decay_spec("200:rank=1,500:bits=4") == ((200, 1, None), (500, None, 4))
    for bad in ("w=lq_sgd:volume=11", "w=warp_drive"):
        with pytest.raises(ValueError):
            parse_policy_spec(bad)
    with pytest.raises(ValueError):
        parse_decay_spec("200:rk=1")
    assert uniform_policy(CompressorConfig(name="sgd")).method == "raw"
    cfg = CompressorConfig(name="none")
    assert all(p.method == "raw" for p in resolve_policies(cfg, torch_abstract()))


@pytest.mark.parametrize(
    "knob",
    [
        dict(policy="auto"),
        dict(policy="w=topk,*=lq_sgd"),
        dict(warmup_steps=3),
        dict(schedule_decay=((5, 1, None),)),
    ],
    ids=["auto", "spec", "warmup", "decay"],
)
def test_make_compressor_routes_composite(knob):
    cfg = CompressorConfig(name="lq_sgd", **knob)
    assert isinstance(make_compressor(cfg, torch_abstract(), STACKED), CompositeCompressor)
    plain = make_compressor(CompressorConfig(name="lq_sgd"), torch_abstract(), STACKED)
    assert not isinstance(plain, CompositeCompressor)


# ----------------------------------------------------------- the planner
@pytest.mark.parametrize("budget", [0.0, 0.075, 0.25, 0.3])
def test_plan_auto_with_jax_constants_matches_jax(budget):
    cfg = CompressorConfig(name="lq_sgd")
    pols, report = plan_auto(
        torch_abstract(), STACKED, cfg=cfg, error_budget=budget,
        cost_model=CostModel(**TPU_COSTS),
    )
    jpols, jreport = jpolicy.plan_auto(
        jax_abstract(), STACKED, cfg=jcore.CompressorConfig(name="lq_sgd"),
        error_budget=budget,
    )
    assert [_fields(p) for p in pols] == [_fields(p) for p in jpols]
    for row, jrow in zip(report, jreport):
        for k in ("path", "shape", "method", "wire_bits", "est_err", "raw_bits"):
            assert row[k] == jrow[k], k
        assert row["est_cost_us"] == pytest.approx(jrow["est_cost_us"], rel=1e-12)
    comp = CompositeCompressor(cfg, torch_abstract(), STACKED, policies=pols)
    assert sum(r["wire_bits"] for r in report) == comp.wire_bits_per_step()
    if budget == 0.0:
        assert all(p.method == "raw" for p in pols)
    assert "total" in format_plan_report(report)


def test_cost_model_defaults_are_the_h100s():
    cm = CostModel()
    assert cm.peak_flops == h100_hw.PEAK_FLOPS_BF16 == 989e12
    assert cm.link_bw == h100_hw.NVLINK_LINK_BW == 25e9
    assert (cm.link_bw, cm.peak_flops) != (tpu_hw.ICI_LINK_BW, tpu_hw.PEAK_FLOPS_BF16)


# ------------------------------------------ BENCH_comm_cost.json, exactly
POLICY_SWEEP = {
    "uniform_lq_r1_b8": dict(name="lq_sgd", rank=1, bits=8),
    "uniform_lq_r2_b8": dict(name="lq_sgd", rank=2, bits=8),
    "mixed": dict(
        name="lq_sgd",
        rank=1,
        bits=8,
        policy="c2=lq_sgd:rank=1:bits=4,c3=lq_sgd:rank=1:bits=4,*=lq_sgd:bits=8",
    ),
    "auto": dict(name="lq_sgd", policy="auto", error_budget=0.25),
    "auto_tight": dict(name="lq_sgd", policy="auto", error_budget=0.075),
}


@pytest.mark.parametrize("row", sorted(POLICY_SWEEP))
def test_policy_sweep_static_bits_equal_the_committed_table(row):
    """Exact on the mini-CNN: 13104 / 17328 / 10992 / 8776 / 193136 bits a
    step, by method; the planner's rows with the TPU constants injected."""
    bench = json.loads((ROOT / "BENCH_comm_cost.json").read_text())["policy_sweep"]
    want = {r["policy"]: r for r in bench["results"]}[row]
    cfg = CompressorConfig(**POLICY_SWEEP[row])
    abstract = torch_abstract(CNN_SHAPES)
    if cfg.policy == "auto":
        pols, _ = plan_auto(abstract, cfg=cfg, cost_model=CostModel(**TPU_COSTS))
        comp = CompositeCompressor(cfg, abstract, policies=pols)
    else:
        comp = make_compressor(cfg, abstract)
    assert comp.wire_bits_per_step() == want["wire_bits_per_step"]
    by_method = (
        comp.wire_bits_by_method()
        if isinstance(comp, CompositeCompressor)
        else {cfg.name: comp.wire_bits_per_step()}
    )
    assert by_method == want["wire_bits_by_method"]


def test_policy_sweep_syncs_charge_their_static_bits():
    """The mixed and auto composites' syncs send what they account."""
    abstract = torch_abstract(CNN_SHAPES)
    g = {k: torch.from_numpy(v) for k, v in grads(60, shapes=CNN_SHAPES).items()}
    for row in ("mixed", "auto"):
        comp = make_compressor(CompressorConfig(**POLICY_SWEEP[row]), abstract)
        _, _, rec = comp.sync(g, comp.init_state(0, N, "cpu"), SimComm(N))
        assert rec.bits_sent == comp.wire_bits_per_step()
