"""Per-leaf policy resolution: spec parsing and the cost-model auto-planner.

Three ways to give every gradient leaf a
:class:`~repro_torch.core.compressors.LeafPolicy` (``CompressorConfig.policy``
selects one; :func:`~repro_torch.core.compressors.make_compressor` routes a
non-uniform result to the composite):

* **uniform**: ``cfg.name`` everywhere (the paper's global config);
* **spec string**: ``"pattern=method[:knob=value]*"`` rules, comma-separated,
  first match wins (fnmatch or substring against the leaf's path, as
  ``jax.tree_util.keystr`` writes it; ``*`` is the catch-all), e.g.
  ``"fc=qsgd:bits=4,stage3=lq_sgd:rank=1:bits=4,*=lq_sgd:bits=8"``;
* **auto**: :func:`plan_auto` picks, per leaf, the cheapest method whose
  *error proxy* fits under ``cfg.error_budget``.

The planner's cost of shipping one leaf is interconnect time plus compute
time:

    cost(policy) = wire_bits / 8 / link_bw  +  flops / peak_flops

with the H100's constants by default (:mod:`repro_torch.roofline.hw`);
``wire_bits`` is the exact static accounting the handlers charge. The error
proxies are coarse static heuristics (error feedback recycles the residual,
modelled as a constant ``ef_discount``):

    raw                      : 0
    low-rank r on (n, m)     : ef * sqrt(1 - H(r)/H(d)),  d = min(n, m)
    + log-quant to b bits    : + 2^-(b-1)
    lq raw path (1-D leaves) : 2^-(b-1)
    topk at ratio rho        : ef * sqrt(1 - rho)
    qsgd at b bits           : 3 * 2^-(b-1)
"""

from __future__ import annotations

import dataclasses
import fnmatch
from collections.abc import Sequence
from typing import Any

from repro_torch.core.compressors import (
    CompressorConfig,
    LeafPolicy,
    _leaf_plan,
    _numel,
)
from repro_torch.core.lazy import (
    DECISION_BITS_PER_GROUP,
    DECISION_BITS_PER_LEAF,
    SERVER_DECISION_BITS_PER_GROUP,
    p_fire,
    staleness_err,
)
from repro_torch.core.tree import Tree, flatten_with_paths, tree_leaves
from repro_torch.roofline import hw

__all__ = [
    "CostModel",
    "parse_policy_spec",
    "parse_decay_spec",
    "match_policies",
    "plan_auto",
    "resolve_policies",
    "uniform_policy",
    "format_plan_report",
]

_NAME_ALIASES = {"none": "raw", "sgd": "raw"}

# knob name -> caster, for spec strings
_POLICY_KNOBS = {
    "rank": int,
    "bits": int,
    "bits_q": int,
    "topk_ratio": float,
    "min_numel": int,
    "lazy_thresh": float,
    "max_stale": int,
    "lazy_adaptive": float,
    "codec": str,
    "dp_epsilon": float,
}


def uniform_policy(cfg: CompressorConfig) -> LeafPolicy:
    return LeafPolicy(
        method=_NAME_ALIASES.get(cfg.name, cfg.name),
        rank=cfg.rank,
        bits=cfg.bits,
        bits_q=cfg.bits_q,
        topk_ratio=cfg.topk_ratio,
        codec=cfg.codec,
        dp_epsilon=cfg.dp_epsilon,
        lazy_thresh=cfg.lazy_thresh,
        max_stale=cfg.max_stale,
        lazy_adaptive=cfg.lazy_adaptive,
    )


# --------------------------------------------------------------------------
# spec strings
# --------------------------------------------------------------------------


def parse_policy_spec(spec: str) -> list[tuple[str, LeafPolicy]]:
    """``"pattern=method[:knob=value]*"`` rules, comma-separated."""
    rules: list[tuple[str, LeafPolicy]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        pat, sep, rhs = part.partition("=")
        if not sep or not rhs:
            raise ValueError(
                f"bad policy rule {part!r}: want pattern=method[:knob=value]*"
            )
        fields = rhs.split(":")
        method = _NAME_ALIASES.get(fields[0].strip(), fields[0].strip())
        kw: dict[str, Any] = {}
        for f in fields[1:]:
            k, ksep, v = f.partition("=")
            k = k.strip()
            if not ksep or k not in _POLICY_KNOBS:
                raise ValueError(
                    f"bad policy knob {f!r} in rule {part!r}; "
                    f"options: {sorted(_POLICY_KNOBS)}"
                )
            kw[k] = _POLICY_KNOBS[k](v)
        rules.append((pat.strip(), LeafPolicy(method=method, **kw)))
    if not rules:
        raise ValueError(f"empty policy spec {spec!r}")
    return rules


def parse_decay_spec(spec: str) -> tuple[tuple[int, int | None, int | None], ...]:
    """``"STEP[:rank=R][:bits=B]"`` entries, comma-separated: the
    piecewise-constant caps of
    :class:`~repro_torch.core.composite.PolicySchedule`, e.g.
    ``"200:rank=1,500:bits=4"``."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        step = int(fields[0])
        rank_cap = bits_cap = None
        for f in fields[1:]:
            k, sep, v = f.partition("=")
            if k == "rank" and sep:
                rank_cap = int(v)
            elif k == "bits" and sep:
                bits_cap = int(v)
            else:
                raise ValueError(
                    f"bad decay knob {f!r} in {part!r} (want rank=R or bits=B)"
                )
        out.append((step, rank_cap, bits_cap))
    if not out:
        raise ValueError(f"empty decay spec {spec!r}")
    return tuple(out)


def _match(path: str, pattern: str) -> bool:
    return pattern == "*" or pattern in path or fnmatch.fnmatch(path, pattern)


def match_policies(
    abstract_grads: Tree,
    rules: Sequence[tuple[str, LeafPolicy]],
    default: LeafPolicy,
) -> list[LeafPolicy]:
    """First matching rule wins; unmatched leaves get ``default``."""
    out = []
    for path, _leaf in flatten_with_paths(abstract_grads):
        for pat, pol in rules:
            if _match(path, pat):
                out.append(pol)
                break
        else:
            out.append(default)
    return out


# --------------------------------------------------------------------------
# the auto-planner
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Roofline per-step cost and the error-proxy constants. The defaults
    are one H100 SXM's (:mod:`repro_torch.roofline.hw`)."""

    link_bw: float = hw.NVLINK_LINK_BW  # bytes/s a link, one direction
    peak_flops: float = hw.PEAK_FLOPS_BF16
    ef_discount: float = 0.25  # error feedback recycles the residual
    # lazy aggregation: the modelled per-round relative innovation
    # (core/lazy.p_fire)
    innovation_rate: float = 0.25

    def wire_s(self, bits: float) -> float:
        return bits / 8.0 / self.link_bw

    def flops_s(self, flops: float) -> float:
        return flops / self.peak_flops

    def cost_s(self, wire_bits: float, flops: float) -> float:
        return self.wire_s(wire_bits) + self.flops_s(flops)

    def expected_wire_bits(
        self,
        pol: LeafPolicy,
        wire_bits: int,
        *,
        topology: str = "symmetric",
        participation: float = 1.0,
    ) -> float:
        """The p_fire-weighted wire of one leaf plus its 64 bits a round of
        decision sideband. An adaptive policy is costed at its mid-run
        threshold ``tau * sqrt((1 + cap) / 2)``. On the server wire every
        upload is scaled by ``participation`` and the per-leaf sideband
        vanishes (the test is local)."""
        server = topology == "server"
        part = participation if server else 1.0
        if pol.lazy_thresh <= 0:
            return part * float(wire_bits)
        t = pol.lazy_thresh
        if pol.lazy_adaptive > 1:
            t = t * ((1.0 + pol.lazy_adaptive) / 2.0) ** 0.5
        p = p_fire(t, pol.max_stale, self.innovation_rate)
        side = 0.0 if server else float(DECISION_BITS_PER_LEAF)
        return p * part * wire_bits + side


def _spectral_mass(k: int) -> float:
    """H(k) = sum_{j<=k} j^-2, the energy of the top-k modes of a 1/j
    spectrum (exact below 4096, the tail-corrected asymptote above)."""
    if k <= 0:
        return 0.0
    if k <= 4096:
        return sum(1.0 / (j * j) for j in range(1, k + 1))
    return 1.6449340668482264 - 1.0 / k


def _lowrank_err(r: int, n: int, m: int) -> float:
    d = min(n, m)
    if r >= d:
        return 0.0
    return max(0.0, 1.0 - _spectral_mass(r) / _spectral_mass(d)) ** 0.5


def _quant_err(bits: int) -> float:
    return 2.0 ** -(bits - 1)


def _privacy_terms(
    codec: str | None, dp_epsilon: float, dp_delta: float, lrq_layers: int, bits: int
) -> tuple[str | None, float, float]:
    """(effective codec name, dp_epsilon, extra error proxy) of the privacy
    knobs. The extra error is the std of the codec's injected noise in
    normalized units: the calibrated Gaussian sigma for ``dlog``, the layer
    mixture's rounding std for ``lrq``. So a tighter dp_epsilon (more noise)
    pushes the planner toward more bits and ranks."""
    if dp_epsilon <= 0 and codec is None:
        return None, 0.0, 0.0
    eff = codec or "dlog"
    extra = 0.0
    if eff == "lrq":
        # the layer mixture's extra rounding noise over plain b-bit codes
        mix = (sum(4.0**j for j in range(lrq_layers)) / lrq_layers) ** 0.5
        extra += _quant_err(bits) * mix
    if dp_epsilon > 0 and eff == "dlog":
        from repro_torch.core.privacy.accounting import gaussian_sigma

        extra += gaussian_sigma(dp_epsilon, dp_delta)
    return eff, dp_epsilon, extra


def _candidates(
    pl,
    cm: CostModel,
    *,
    ranks,
    bits_options,
    topk_ratios,
    qsgd_bits,
    lazy_options: Sequence[tuple[float, int]] = (),
    lazy_adaptive: float = 0.0,
    codec: str | None = None,
    dp_epsilon: float = 0.0,
    dp_delta: float = 1e-5,
    lrq_layers: int = 2,
) -> list[tuple[LeafPolicy, float]]:
    """(policy, error proxy) candidates for one leaf. ``lazy_options``
    ((lazy_thresh, max_stale) pairs) add a skip-round variant of every
    lossy candidate, its error grown by the staleness penalty. The privacy
    knobs (:func:`_privacy_terms`) set every lq_sgd candidate's codec and
    budget and add their noise to its error."""
    out: list[tuple[LeafPolicy, float]] = [(LeafPolicy(method="raw"), 0.0)]
    inst = pl.shape[1:] if pl.stacked else pl.shape

    def lq(b: int, err: float, **kw) -> tuple[LeafPolicy, float]:
        eff, eps, extra = _privacy_terms(codec, dp_epsilon, dp_delta, lrq_layers, b)
        pol = LeafPolicy(method="lq_sgd", bits=b, codec=eff, dp_epsilon=eps, **kw)
        return pol, err + _quant_err(b) + extra

    if pl.route == "lowrank":
        n, m = pl.mat_shape
        for r in ranks:
            lr = cm.ef_discount * _lowrank_err(min(r, n, m), n, m)
            out.append((LeafPolicy(method="powersgd", rank=r), lr))
            for b in bits_options:
                out.append(lq(b, lr, rank=r))
        for rho in topk_ratios:
            out.append(
                (
                    LeafPolicy(method="topk", topk_ratio=rho),
                    cm.ef_discount * (1.0 - rho) ** 0.5,
                )
            )
        for b in qsgd_bits:
            out.append((LeafPolicy(method="qsgd", bits=b), 3.0 * _quant_err(b)))
    elif len(inst) >= 1:
        # raw-route leaves: lq_sgd still quantizes them on its raw path, the
        # only method that saves wire here (no error feedback)
        for b in bits_options:
            out.append(lq(b, 0.0))
    variants = []
    for pol, err in out:
        if pol.method == "raw":
            continue
        for thresh, stale in lazy_options:
            if thresh <= 0:
                continue
            lazy = dataclasses.replace(
                pol, lazy_thresh=thresh, max_stale=stale, lazy_adaptive=lazy_adaptive
            )
            variants.append(
                (lazy, err + staleness_err(thresh, stale, cm.innovation_rate))
            )
    return out + variants


def _leaf_flops(pol: LeafPolicy, pl) -> float:
    numel = _numel(pl.shape)
    if pl.route != "lowrank" or pol.method == "raw":
        return float(numel)  # touch-once
    if pol.method in ("powersgd", "lq_sgd"):
        n, m = pl.mat_shape
        n_layers = pl.shape[0] if pl.stacked else 1
        # P = GQ, Q = G^T P, recon P Q^T: three rank-r passes over (n, m)
        return 6.0 * n_layers * n * m * pl.eff_rank
    if pol.method == "topk":
        return 10.0 * numel  # top-k selection
    return 8.0 * numel  # quantize / dequantize


def plan_auto(
    abstract_grads: Tree,
    stacked: Tree | None = None,
    *,
    cfg: CompressorConfig | None = None,
    error_budget: float | None = None,
    cost_model: CostModel | None = None,
    ranks: Sequence[int] = (1, 2, 4),
    bits_options: Sequence[int] = (4, 8),
    topk_ratios: Sequence[float] = (0.01, 0.05),
    qsgd_bits: Sequence[int] = (8,),
    lazy_options: Sequence[tuple[float, int]] | None = None,
) -> tuple[list[LeafPolicy], list[dict]]:
    """Pick, per leaf, the cheapest policy whose error proxy fits the
    budget. Returns ``(policies, report)``: report rows carry the chosen
    policy, its wire bits, cost and error, and the raw baseline.
    ``lazy_options`` defaults to ``cfg``'s lazy knobs when
    ``cfg.lazy_thresh > 0``."""
    from repro_torch.core.composite import handler_for

    cfg = cfg or CompressorConfig()
    budget = cfg.error_budget if error_budget is None else error_budget
    cm = cost_model or CostModel()
    if lazy_options is None:
        lazy_options = (
            ((cfg.lazy_thresh, cfg.max_stale),) if cfg.lazy_thresh > 0 else ()
        )
    server = cfg.topology == "server"
    flat = flatten_with_paths(abstract_grads)
    stacked_flags = [False] * len(flat) if stacked is None else tree_leaves(stacked)
    handlers: dict[str, Any] = {}

    def fired_bits(pol: LeafPolicy, path, leaf, st) -> tuple[int, Any]:
        pl = _leaf_plan(path, leaf, pol, cfg.min_compress_numel, bool(st))
        h = handlers.setdefault(pol.method, handler_for(pol.method, cfg))
        return h.leaf_wire_bits(pl), pl

    policies: list[LeafPolicy] = []
    report: list[dict] = []
    for (path, leaf), st in zip(flat, stacked_flags):
        # route probe (every non-raw method sees the same routing test)
        probe = _leaf_plan(
            path,
            leaf,
            LeafPolicy(method="powersgd", rank=min(ranks)),
            cfg.min_compress_numel,
            bool(st),
        )
        numel = _numel(probe.shape)
        best = None  # ((cost_s, bits, err), pol, bits, err)
        for pol, err in _candidates(
            probe,
            cm,
            ranks=ranks,
            bits_options=bits_options,
            topk_ratios=topk_ratios,
            qsgd_bits=qsgd_bits,
            lazy_options=lazy_options,
            lazy_adaptive=cfg.lazy_adaptive,
            codec=cfg.codec,
            dp_epsilon=cfg.dp_epsilon,
            dp_delta=cfg.dp_delta,
            lrq_layers=cfg.lrq_layers,
        ):
            if err > budget:
                continue
            wire, pl = fired_bits(pol, path, leaf, st)
            # accounted wire: a fired round + the leaf's share of the lazy
            # decision sideband; the cost reads the expected wire
            bits = wire + (
                DECISION_BITS_PER_LEAF if pol.lazy_thresh > 0 and not server else 0
            )
            cost = cm.cost_s(
                cm.expected_wire_bits(
                    pol,
                    wire,
                    topology=cfg.topology,
                    participation=cfg.participation,
                ),
                _leaf_flops(pol, pl),
            )
            key = (cost, bits, err)
            if best is None or key < best[0]:
                best = (key, pol, bits, err)
        if best is None:  # unreachable for budget >= 0 (raw has err 0)
            raw_bits = numel * 32
            best = (
                (cm.cost_s(raw_bits, numel), raw_bits, 0.0),
                LeafPolicy(method="raw"),
                raw_bits,
                0.0,
            )
        (cost, _, _), pol, bits, err = best
        policies.append(pol)
        report.append(
            {
                "path": path,
                "shape": list(probe.shape),
                "numel": numel,
                "method": pol.method,
                "rank": pol.rank,
                "bits": pol.bits,
                "topk_ratio": pol.topk_ratio,
                "codec": pol.codec,
                "epsilon": pol.dp_epsilon if pol.dp_epsilon > 0 else None,
                "lazy_thresh": pol.lazy_thresh,
                "max_stale": pol.max_stale,
                "lazy_adaptive": pol.lazy_adaptive,
                "p_fire": (
                    p_fire(pol.lazy_thresh, pol.max_stale, cm.innovation_rate)
                    if pol.lazy_thresh > 0
                    else 1.0
                ),
                "wire_bits": bits,
                "est_err": err,
                "est_cost_us": cost * 1e6,
                "raw_bits": numel * 32,
            }
        )
    # each lazy method group's decision carries one more slot (the force
    # votes; on the server wire the contribution flag): charge it to the
    # method's first lazy leaf, so the report sums to wire_bits_per_step()
    group_slot = SERVER_DECISION_BITS_PER_GROUP if server else DECISION_BITS_PER_GROUP
    seen_lazy: set[str] = set()
    for pol, row in zip(policies, report):
        if pol.lazy_thresh > 0 and pol.method not in seen_lazy:
            seen_lazy.add(pol.method)
            row["wire_bits"] += group_slot
    return policies, report


def format_plan_report(report: list[dict]) -> str:
    """Human-readable planner summary (the training launcher prints it)."""
    lines = ["per-leaf plan (auto):"]
    tot = sum(r["wire_bits"] for r in report)
    raw = sum(r["raw_bits"] for r in report)
    for r in report:
        knobs = {
            "powersgd": f"r{r['rank']}",
            "lq_sgd": f"r{r['rank']}b{r['bits']}",
            "topk": f"p{r['topk_ratio']}",
            "qsgd": f"b{r['bits']}",
        }.get(r["method"], "")
        if r.get("codec"):
            knobs += f"+{r['codec']}"
            if r.get("epsilon"):
                knobs += f"(eps={r['epsilon']:g})"
        if r.get("lazy_thresh", 0) > 0:
            knobs += f"~lazy(p={r['p_fire']:.2f})"
        lines.append(
            f"  {r['path']:<40} {str(tuple(r['shape'])):<20} "
            f"-> {r['method']}{knobs:<8} {r['wire_bits'] / 8e3:8.2f}KB "
            f"(raw {r['raw_bits'] / 8e3:.2f}KB, err~{r['est_err']:.3f})"
        )
    lines.append(
        f"  total {tot / 8e6:.3f}MB/step vs raw {raw / 8e6:.3f}MB/step "
        f"({raw / max(tot, 1):.1f}x)"
    )
    return "\n".join(lines)


def resolve_policies(
    cfg: CompressorConfig, abstract_grads: Tree, stacked: Tree | None = None
) -> list[LeafPolicy]:
    """``CompressorConfig.policy`` -> one LeafPolicy per flattened leaf."""
    spec = cfg.policy
    if spec in (None, "uniform"):
        return [uniform_policy(cfg)] * len(tree_leaves(abstract_grads))
    if spec == "auto":
        policies, _ = plan_auto(abstract_grads, stacked, cfg=cfg)
        return policies
    return match_policies(
        abstract_grads, parse_policy_spec(spec), uniform_policy(cfg)
    )
