"""The dry run: one rank's step of every (architecture x input shape)
traced for the H100 production mesh, with its roofline terms. The port's
counterpart of the JAX package's ``python -m repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
        --shape train_4k [--multi-pod] [--out results.json] [--device cpu]

The JAX dry run lowers and compiles one rank's step on 256 (512) fake host
devices and reads the compiled module's memory, cost and collectives. The
port has no compiler, so it runs one rank's step eagerly over fake tensors
(``FakeTensorMode``: shapes, dtypes and devices, no memory) inside a fake
process group of the mesh's size (``launch/mesh.py:
init_fake_distributed``), whose collectives return at once: nothing is
allocated and no card is touched. ``roofline/fake_trace.py`` counts the
step's FLOPs, its bytes, its peak live bytes and its collectives by axis;
``roofline/analysis.py`` turns them into the roofline terms on the H100
cluster's constants. ``--device cpu`` traces fake CPU tensors (the CPU
tests: a fake CUDA tensor's product needs PyTorch built with CUDA);
``--device cuda`` (the default) traces fake CUDA tensors on a host with a
card, which it still does not touch.

What runs is the JAX dry run's, on the port's modules:

* **train**: ``init_train_state(..., tp=, mesh=)`` and one step of
  ``build_train_step`` with remat on and SGD(1e-2), the compressor's sync
  over the data axis included; lazy groups in gate mode (bit-identical to
  elide, ``tests/test_torch_lazy.py``), since elide reads the decision on
  the host (ROADMAP item 20);
* **prefill**: ``build_prefill_step`` at ``max_seq = seq_len + cond_len``;
* **decode**: one ``build_decode_step`` against a ``seq_len``-deep raw
  bf16 cache, at per-row positions;
* serving lays out parameters, caches and rows by ``serve_shard`` over the
  mesh.

The step runs its plain path, as the JAX dry run lowers ``backend="xla"``:
the training forward's plain attention, and the kernels' plain versions
(``ops.reference_mode()``); a fake tensor that reaches a kernel's launch
raises. ``long_500k`` is skipped where ``configs.shape_supported`` says.
Every layer is traced (there is no scan body counted once), so the FLOPs
are counted, not modelled; the analytic model (``roofline/
flops_model.py``, the JAX package's) stands beside them.

Each record is rank 0's. One rank stands for all: the sharding rules
split every tensor evenly over its axis or replicate it (``launch/
sharding.py``), so every rank runs the same ops on the same shapes. The
record keeps the JAX record's keys where they mean the same; ``trace_s``
stands for ``compile_s`` and ``counted_flops_per_device`` for
``hlo_flops_per_device_measured``; ``unrolled`` is gone (the port has no
scan to unroll). ``memory`` keeps its five keys over the traced storages:
``argument_bytes`` the step's inputs (the training state and the batch;
parameters, caches and tokens), ``output_bytes`` what it returns,
``alias_bytes`` the outputs that are inputs updated in place (the donated
state), ``peak_est_bytes`` the traced peak of live bytes and
``temp_bytes`` the rest of it (``peak = args + out + temp - alias``).
A combination that raises is recorded as ``status: error`` and fails the
run, as in the JAX package.

The JAX CLI's compressor flags carry over. ``--mesh DxM`` traces a small
mesh in place of the production one (the JAX package's
``REPRO_DRYRUN_DEVICES``). Refused: ``--lint`` (the graph lint, ROADMAP
item 18), and XLA's own ``--unroll``, ``--moe-hints`` and ``--dump-hlo``,
which have no meaning without a compiler.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.configs import INPUT_SHAPES, get_config, list_archs, shape_supported
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.comm import DistComm, ModelAxis, ModelComm
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.tree import flatten_with_paths, tree_leaves
from repro_torch.kernels import ops
from repro_torch.launch.inputs import input_specs
from repro_torch.launch.mesh import (
    PRODUCTION_MESH_SHAPE,
    init_fake_distributed,
    make_comm,
    make_mesh,
    make_model_comm,
)
from repro_torch.launch.train import parse_mesh
from repro_torch.models.model import init_caches, init_params
from repro_torch.roofline import fake_trace, hw
from repro_torch.roofline.analysis import (
    RooflineReport,
    collective_stats,
    model_flops,
)
from repro_torch.roofline.flops_model import per_device_flops
from repro_torch.serving.engine import (
    build_decode_step,
    build_prefill_step,
    serve_shard,
)
from repro_torch.train.optimizer import Optimizer, sgd
from repro_torch.train.step import (
    abstract_grads_of,
    build_train_step,
    init_train_state,
    make_model_compressor,
    train_param_specs,
)
from repro_torch.weights import init_sharded_params

__all__ = ["trace_one", "params_total", "params_active", "main", "LINT"]

LINT = "ROADMAP Queue 1, item 18 (the graph lint)"
# the JAX CLI's flags that act on XLA alone
XLA_ONLY = {
    "unroll": "the port has no scan to unroll: every layer is traced and counted",
    "moe_hints": "sharding constraints steer XLA's partitioner; the port's "
    "MoE layout is written out in models/moe.py",
    "dump_hlo": "the port compiles nothing, so there is no HLO",
}


def params_total(cfg: ModelConfig) -> int:
    """The parameters of the training tree (``meta``: no allocation)."""
    return sum(w.numel() for w in tree_leaves(abstract_grads_of(cfg)[0]))


def params_active(cfg: ModelConfig) -> int:
    """Parameter count with MoE experts scaled to the routed top-k."""
    total = 0
    for path, w in flatten_with_paths(abstract_grads_of(cfg)[0]):
        n = w.numel()
        if any(k in path for k in ("w_gate", "w_up", "w_down")):
            n = int(n * cfg.experts_per_token / max(cfg.n_experts, 1))
        total += n
    return total


def _storages(ts: list[torch.Tensor]) -> dict[int, int]:
    """Each distinct storage of ``ts``: its bytes."""
    return {
        t.untyped_storage()._cdata: t.untyped_storage().nbytes()
        for t in ts
        if isinstance(t, torch.Tensor)
    }


def _tensors(tree: Any) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _rows(x: torch.Tensor, rows: slice) -> torch.Tensor:
    """A rank's rows of a global input, in storage of their own."""
    return x[rows].clone()


def _trace_train(cfg, shape, mesh, comp_cfg, optimizer, dev):
    compressor = make_model_compressor(cfg, comp_cfg)
    tp = None
    if mesh.model > 1:
        tp = ModelAxis(
            comm=make_model_comm(mesh),
            seq=ModelComm(),
            specs=train_param_specs(cfg, mesh.model),
        )
    comm = make_comm(mesh)
    recs = []
    step = build_train_step(
        cfg,
        mesh.shape,
        compressor,
        optimizer,
        remat=True,
        comm=comm,
        graph=False,
        tp=tp,
        on_sync=lambda grads, synced, comp, rec: recs.append(rec),
    )
    state = init_train_state(
        cfg, 0, optimizer, compressor, mesh.local, dev, tp=tp, mesh=mesh
    )
    rows = comm.rows(shape.global_batch)
    batch = {k: _rows(v, rows) for k, v in input_specs(cfg, shape, dev).items()}
    comms = {
        "model": [tp.comm] if tp is not None else [],
        "data": [comm] if isinstance(comm, DistComm) else [],
    }
    args = _tensors(state) + _tensors(batch)
    with fake_trace.count(live=args, comms=comms) as counts:
        out = step(state, batch)
    extra = {
        "compressor_wire_bits_per_step": compressor.wire_bits_per_step(),
        "compressor_phys_bits": recs[-1].phys_bits,
        "param_bytes": sum(_storages(_tensors(state["params"])).values()),
    }
    return counts, args, _tensors(out), extra


def _serve_layout(cfg, shape, mesh, dev):
    """(shard or None, parameters, comms by axis) of a serving step."""
    if not mesh.distributed:
        return None, init_params(cfg, 1, dev), {"model": [], "data": []}
    shard = serve_shard(cfg, mesh, shape.global_batch, cache_dtype=torch.bfloat16)
    params = init_sharded_params(cfg, 1, dev, shard.param_specs, mesh)
    axis = shard.axis
    # the sequence's group is the model axis's, or spans every rank (across
    # nodes: the data axis's fabric)
    seq_axis = "model" if axis.seq is axis.comm else "data"
    comms = {"model": [axis.comm], "data": [axis.data]}
    comms[seq_axis].append(axis.seq)
    return shard, params, comms


def _trace_serve(cfg, shape, mesh, dev):
    shard, params, comms = _serve_layout(cfg, shape, mesh, dev)
    rows = shard.rows() if shard is not None else slice(None)
    specs = input_specs(cfg, shape, dev)
    tokens = _rows(specs["tokens"], rows)
    if shape.mode == "prefill":
        cond = _rows(specs["cond"], rows) if "cond" in specs else None
        fn = build_prefill_step(cfg, max_seq=shape.seq_len + cfg.cond_len, shard=shard)
        inputs = (params, tokens, cond)
    else:
        bf16 = torch.bfloat16
        if shard is not None:
            caches = shard.zero_caches(cfg, shape.seq_len, bf16, dev)
        else:
            caches = init_caches(cfg, shape.global_batch, shape.seq_len, bf16, dev)
        # the JAX step's one position, as the (B,) positions the port's
        # decode reads
        index = specs["index"].to(torch.int64).expand(tokens.shape[0]).clone()
        fn = build_decode_step(cfg, shard)
        inputs = (params, caches, tokens, index)
    args = _tensors(inputs)
    with fake_trace.count(live=args, comms=comms) as counts:
        out = fn(*inputs)
    extra = {
        "compressor_wire_bits_per_step": 0,
        "param_bytes": sum(_storages(_tensors(params)).values()),
    }
    return counts, args, _tensors(out), extra


def _memory(counts, args, outs) -> dict[str, int]:
    a, o = _storages(args), _storages(outs)
    arg_b, out_b = sum(a.values()), sum(o.values())
    alias = sum(n for k, n in o.items() if k in a)
    peak = counts.peak_bytes
    return {
        "argument_bytes": arg_b,
        "output_bytes": out_b,
        "temp_bytes": peak - arg_b - out_b + alias,
        "alias_bytes": alias,
        "peak_est_bytes": peak,
        "hbm_bytes_per_chip": hw.HBM_BYTES,
    }


def trace_one(
    arch: str | ModelConfig,
    shape: str | InputShape,
    *,
    multi_pod: bool = False,
    mesh: tuple[int, int] | None = None,
    one_process: bool = False,
    comp_cfg: CompressorConfig | None = None,
    optimizer: Optimizer | None = None,
    device: torch.device | str = "cuda",
    dp_only: bool = False,
    moe_impl: str | None = None,
    perf_tag: str | None = None,
    verbose: bool = True,
) -> dict:
    """Trace one combination; return the roofline record (rank 0's).

    ``arch`` is a name or a config, ``shape`` a name of ``INPUT_SHAPES`` or
    an ``InputShape``. The mesh is the production mesh (``multi_pod``: two
    units), or ``mesh`` (data, model), over a fake process group of its
    size; ``one_process`` runs it without a group, one process holding the
    data axis's workers (a model axis of 1). ``dp_only`` takes every rank
    for the data axis (no model axis). ``optimizer`` is SGD(1e-2) by
    default, as in the JAX dry run."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    name = arch if isinstance(arch, str) else cfg.name
    if moe_impl and cfg.n_experts:
        cfg = dataclasses.replace(cfg, moe_impl=moe_impl)
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    head = {"arch": name, "shape": shape.name, "multi_pod": multi_pod}
    if not shape_supported(name, shape.name):
        return {
            **head,
            "status": "skipped",
            "reason": "full-attention arch: long_500k requires a "
            "sub-quadratic path (DESIGN.md §5)",
        }
    data, model = mesh if mesh is not None else PRODUCTION_MESH_SHAPE[multi_pod]
    if dp_only:
        data, model = data * model, 1
    if one_process and model != 1:
        raise ValueError(f"one process holds a data axis only, not {data}x{model}")
    # the elide mode reads its decision on the host; gate is bit-identical
    comp_cfg = dataclasses.replace(
        comp_cfg or CompressorConfig(name="lq_sgd", rank=1, bits=8), lazy_mode="gate"
    )
    optimizer = optimizer or sgd(1e-2)
    t0 = time.time()
    created = False
    if not one_process:
        init_fake_distributed(data * model)
        created = True
    try:
        dm = make_mesh((data, model), device)
        dev = dm.device
        with ops.reference_mode(), fake_trace.fake_mode():
            if shape.mode == "train":
                counts, args, outs, extra = _trace_train(
                    cfg, shape, dm, comp_cfg, optimizer, dev
                )
            else:
                counts, args, outs, extra = _trace_serve(cfg, shape, dm, dev)
    finally:
        if created:
            dist.destroy_process_group()
    t_trace = time.time() - t0
    chips = data * model if not one_process else 1
    ndp, msize = (data, model) if not one_process else (1, 1)
    train = shape.mode == "train"
    analytic = per_device_flops(cfg, shape, ndp=ndp, msize=msize, remat=train)
    dense = per_device_flops(
        cfg, shape, ndp=ndp, msize=msize, remat=train, attn_ctx="dense"
    )
    rep = RooflineReport(
        flops_per_device=float(counts.flops),
        bytes_per_device=float(counts.bytes),
        model_axis=collective_stats(counts.collectives.get("model")),
        data_axis=collective_stats(counts.collectives.get("data")),
        chips=chips,
    )
    n_total, n_active = params_total(cfg), params_active(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.mode != "decode" else 1)
    # 6·N·D already counts fwd+bwd (train); inference is forward-only 2·N·D
    mf = model_flops(n_active, tokens) if train else 2.0 * n_active * tokens
    flops_global = rep.flops_per_device * chips
    data_book = counts.collectives.get("data") or {"sent": {}}
    record = {
        **head,
        "status": "ok",
        "mode": shape.mode,
        "chips": chips,
        "mesh": [data, model],
        "one_process": one_process,
        "device": str(dev),
        "perf_tag": perf_tag,
        "dp_only": dp_only,
        "compressor": dataclasses.asdict(comp_cfg),
        "trace_s": round(t_trace, 1),
        "params_total": n_total,
        "params_active": n_active,
        "tokens_per_step": tokens,
        "model_flops": mf,
        "counted_flops_per_device": rep.flops_per_device,
        "analytic_flops_per_device": analytic,
        "analytic_dense_attn_flops_per_device": dense,
        "flops_global": flops_global,
        "useful_flops_ratio": (mf / flops_global) if flops_global else None,
        "memory": _memory(counts, args, outs),
        "data_axis_sent_bytes": {
            k: v for k, v in data_book["sent"].items() if k != "gather"
        },
        **extra,
        **rep.as_dict(),
    }
    if verbose:
        _print(record)
    return record


def _print(r: dict) -> None:
    mem = r["memory"]
    print(
        f"== {r['arch']} x {r['shape']} ({r['mesh'][0]}x{r['mesh'][1]}, "
        f"{r['chips']} cards{', 2 units' * r['multi_pod']}) traced in "
        f"{r['trace_s']:.0f}s on {r['device']}"
    )
    print(
        f"   memory: args={mem['argument_bytes'] / 1e9:.2f}GB "
        f"temp={mem['temp_bytes'] / 1e9:.2f}GB out={mem['output_bytes'] / 1e9:.2f}GB "
        f"peak={mem['peak_est_bytes'] / 1e9:.2f}GB (a card)"
    )
    print(
        f"   counted: flops/card={r['flops_per_device']:.3e} (analytic "
        f"{r['analytic_flops_per_device']:.3e}) bytes/card="
        f"{r['bytes_per_device']:.3e}"
    )
    print(
        f"   collectives: {r['collective_counts']} model-axis wire="
        f"{r['model_axis_wire_bytes'] / 1e6:.2f}MB data-axis wire="
        f"{r['data_axis_wire_bytes'] / 1e6:.2f}MB a card"
    )
    print(
        f"   roofline: compute={r['compute_s'] * 1e3:.2f}ms "
        f"memory={r['memory_s'] * 1e3:.2f}ms "
        f"collective={r['collective_s'] * 1e3:.2f}ms (NVLink "
        f"{r['model_collective_s'] * 1e3:.2f} + InfiniBand "
        f"{r['data_collective_s'] * 1e3:.2f}) -> dominant: {r['dominant']}",
        flush=True,
    )


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=list_archs() + ["all"])
    ap.add_argument(
        "--shape",
        required=True,
        help=f"one of {sorted(INPUT_SHAPES)}, several joined by commas, or all",
    )
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument(
        "--mesh",
        default=None,
        help="'DxM': trace this mesh in place of the production one",
    )
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None, help="JSON output path")
    ap.add_argument(
        "--compressor",
        default="lq_sgd",
        choices=["none", "topk", "qsgd", "powersgd", "lq_sgd"],
    )
    ap.add_argument(
        "--policy",
        default=None,
        help="per-leaf policy: 'uniform', 'auto' (cost-model planner), or a "
        "spec string (README)",
    )
    ap.add_argument("--error-budget", type=float, default=0.3)
    ap.add_argument("--warmup", type=int, default=0)
    ap.add_argument("--rank", type=int, default=1)
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument(
        "--wire-accounting",
        "--wire",
        "--wire-mode",
        dest="wire_accounting",
        default="allgather_codes",
        choices=["allgather_codes", "psum_sim"],
    )
    ap.add_argument(
        "--avg-mode", default="paper", choices=["paper", "dequant_then_mean"]
    )
    ap.add_argument("--perf-tag", default=None)
    ap.add_argument("--dp-only", action="store_true")
    ap.add_argument("--moe-impl", default=None, choices=["global", "batched"])
    ap.add_argument("--comp-dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--fuse", action="store_true")
    ap.add_argument("--lint", action="store_true", help=f"not ported ({LINT})")
    for flag in XLA_ONLY:
        ap.add_argument(
            "--" + flag.replace("_", "-"),
            nargs="?",
            const=True,
            default=None,
            help="XLA's alone: refused",
        )
    return ap


def main(argv: list[str] | None = None) -> list[dict]:
    args = _parser().parse_args(argv)
    if args.lint:
        raise NotImplementedError(f"--lint: the graph lint is not ported ({LINT})")
    for flag, why in XLA_ONLY.items():
        if getattr(args, flag) is not None:
            raise ValueError(f"--{flag.replace('_', '-')} acts on XLA alone: {why}")
    if args.mesh is not None and args.multi_pod:
        raise ValueError("--mesh names the mesh; --multi-pod picks a production one")
    comp_cfg = CompressorConfig(
        name=args.compressor,
        rank=args.rank,
        bits=args.bits,
        wire_accounting=args.wire_accounting,
        avg_mode=args.avg_mode,
        state_dtype=args.comp_dtype,
        fuse_collectives=args.fuse,
        policy=args.policy,
        error_budget=args.error_budget,
        warmup_steps=args.warmup,
    )
    mesh = parse_mesh(args.mesh) if args.mesh else None
    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = sorted(INPUT_SHAPES) if args.shape == "all" else args.shape.split(",")
    unknown = [x for x in shapes if x not in INPUT_SHAPES]
    if unknown:
        raise ValueError(f"--shape {unknown}: options {sorted(INPUT_SHAPES)}, all")
    records = []
    for a in archs:
        for s in shapes:
            try:
                records.append(
                    trace_one(
                        a,
                        s,
                        multi_pod=args.multi_pod,
                        mesh=mesh,
                        comp_cfg=comp_cfg,
                        device=args.device,
                        dp_only=args.dp_only,
                        moe_impl=args.moe_impl,
                        perf_tag=args.perf_tag,
                    )
                )
            except Exception as e:  # record failures: they are bugs to fix
                traceback.print_exc()
                records.append(
                    {
                        "arch": a,
                        "shape": s,
                        "multi_pod": args.multi_pod,
                        "status": "error",
                        "error": repr(e),
                    }
                )
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {args.out}")
    n_bad = sum(r["status"] == "error" for r in records)
    if n_bad:
        raise SystemExit(f"{n_bad} combination(s) FAILED")
    return records


if __name__ == "__main__":
    main()
