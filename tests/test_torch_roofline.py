"""The port's roofline pieces against the JAX package's, on the CPU.

* ``roofline/flops_model.py:per_device_flops`` equals the JAX function to
  1e-12 relative for the ten architectures x four input shapes x meshes
  (16, 16), (32, 8), (64, 8) and (256, 1), and keeps the JAX test's pin
  (gemma3-1b ``train_4k`` at 16 x 16 within 15% of 9.063e13).
* ``launch/inputs.py:input_specs`` gives the JAX package's shapes (all 40
  combinations; dtypes int32 and the config's), and ``make_concrete_batch``
  their values' structure.
* ``launch/dryrun.py:params_total`` / ``params_active`` equal the JAX dry
  run's ``_total_params`` / ``_active_params`` exactly (abstract shapes).
* The production mesh over a fake process group: each rank's coordinates
  and its groups' members at world 256 (32 x 8) and 512 (64 x 8), and a
  ValueError at any other world. A rank's parameters on it are the JAX
  specs' shard shapes (``launch/sharding.py``) leaf by leaf.
* ``roofline/analysis.py``: the ring conventions of ``_wire_bytes``, the
  books as collective stats, and ``RooflineReport``'s terms and dominance
  under the H100 constants (exact arithmetic).
* ``roofline/fake_trace.py``: the live-bytes tracker's peak over known
  allocations (exact), the traffic and FLOP counts of one product.
"""

import os

import pytest

torch = pytest.importorskip("torch")

import jax
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import inputs as jinputs
from repro.launch import sharding as jsharding
from repro.models import model as jmodel
from repro.roofline import flops_model as jflops
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.core.comm import ModelAxis, ModelComm
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.tree import flatten_with_paths
from repro_torch.launch import dryrun, inputs
from repro_torch.launch.mesh import (
    PRODUCTION_MESH,
    init_fake_distributed,
    make_model_comm,
    make_production_mesh,
)
from repro_torch.roofline import analysis, fake_trace, flops_model, hw
from repro_torch.train.optimizer import sgd
from repro_torch.train.step import (
    init_train_state,
    make_model_compressor,
    train_param_specs,
)

FLOPS_REL = 1e-12
MESHES = ((16, 16), (32, 8), (64, 8), (256, 1))
SHAPES = sorted(INPUT_SHAPES)
JAX_PIN = 9.063e13  # tests/test_roofline.py's measured 16x16 figure
JAX_PIN_REL = 0.15


def _jax_dryrun():
    """The JAX dry-run module: its import sets XLA_FLAGS for a 512-device
    host platform, which is put back at once (no JAX backend starts in
    between, so nothing else in this process sees it)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jdry
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdry


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", list_archs())
def test_per_device_flops_equals_jax(arch, shape, mesh):
    ndp, msize = mesh
    for remat in (True, False):
        want = jflops.per_device_flops(
            jax_get_config(arch), JAX_SHAPES[shape], ndp=ndp, msize=msize, remat=remat
        )
        got = flops_model.per_device_flops(
            get_config(arch), INPUT_SHAPES[shape], ndp=ndp, msize=msize, remat=remat
        )
        assert got == pytest.approx(want, rel=FLOPS_REL)
    rep = flops_model.analytic_flops_report(
        get_config(arch), INPUT_SHAPES[shape], ndp=ndp, msize=msize
    )
    assert rep == pytest.approx(
        jflops.analytic_flops_report(
            jax_get_config(arch), JAX_SHAPES[shape], ndp=ndp, msize=msize
        ),
        rel=FLOPS_REL,
    )


def test_analytic_flops_keep_the_jax_pin():
    f = flops_model.per_device_flops(
        get_config("gemma3-1b"), INPUT_SHAPES["train_4k"], ndp=16, msize=16
    )
    assert abs(f - JAX_PIN) / JAX_PIN < JAX_PIN_REL


def test_dense_attention_charges_every_key():
    """``attn_ctx="dense"`` differs from the JAX model in the attention
    term alone: S keys a layer in place of S/2 (or the window)."""
    cfg, shape = get_config("mistral-nemo-12b"), INPUT_SHAPES["prefill_32k"]
    causal = flops_model.per_device_flops(cfg, shape, ndp=32, msize=8)
    dense = flops_model.per_device_flops(cfg, shape, ndp=32, msize=8, attn_ctx="dense")
    tokens = shape.global_batch * shape.seq_len / 32
    per_key = 2 * cfg.n_heads * cfg.head_dim * 2 / 8  # QK^T + PV, heads split
    extra = cfg.n_layers * tokens * per_key * (shape.seq_len - shape.seq_len / 2)
    assert dense - causal == pytest.approx(extra, rel=FLOPS_REL)
    with pytest.raises(ValueError, match="attn_ctx"):
        flops_model.per_device_flops(cfg, shape, ndp=1, msize=1, attn_ctx="x")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_equal_jax(arch, shape):
    want = jinputs.input_specs(jax_get_config(arch), JAX_SHAPES[shape])
    got = inputs.input_specs(get_config(arch), INPUT_SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k, spec in want.items():
        assert tuple(got[k].shape) == tuple(spec.shape), k
        assert got[k].device.type == "meta"
        assert str(got[k].dtype).removeprefix("torch.") == str(spec.dtype), k


def test_make_concrete_batch_has_the_specs_structure():
    cfg = get_config("musicgen-medium", smoke=True)
    for shape in INPUT_SHAPES.values():
        small = type(shape)(shape.name, 8, 2, shape.mode)
        got = inputs.make_concrete_batch(cfg, small, torch.Generator().manual_seed(1))
        specs = inputs.input_specs(cfg, small)
        assert sorted(got) == sorted(specs)
        for k, t in got.items():
            assert t.shape == specs[k].shape and t.dtype == specs[k].dtype
        tok = got["tokens"]
        assert 0 <= int(tok.min()) and int(tok.max()) < cfg.vocab_size
        if "index" in got:
            assert int(got["index"]) == 0


@pytest.mark.parametrize("arch", list_archs())
def test_param_counts_equal_the_jax_dry_run(arch):
    jdry = _jax_dryrun()
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    assert dryrun.params_total(cfg) == jdry._total_params(jcfg)
    assert dryrun.params_active(cfg) == jdry._active_params(jcfg)


@pytest.fixture
def fake_world():
    """Builds a fake process group of a given world (and rank), destroyed
    after the test."""

    def make(world, rank=0):
        if dist.is_initialized():
            dist.destroy_process_group()
        init_fake_distributed(world, rank)

    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True], ids=["unit", "multi_pod"])
def test_production_mesh_over_a_fake_group(fake_world, multi_pod):
    data, model = (64, 8) if multi_pod else (32, 8)
    world = data * model
    for rank in (0, 9, world - 1):
        fake_world(world, rank)
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        assert (mesh.data, mesh.model, mesh.world, mesh.rank) == (
            data,
            model,
            world,
            rank,
        )
        d, m = rank // model, rank % model
        assert (mesh.data_index, mesh.model_index, mesh.local) == (d, m, 1)
        assert dist.get_process_group_ranks(mesh.model_group) == [
            d * model + j for j in range(model)
        ]
        assert dist.get_process_group_ranks(mesh.data_group) == [
            i * model + m for i in range(data)
        ]


@pytest.mark.parametrize(
    "world, multi_pod, ranks",
    [(4, False, 256), (512, False, 256), (256, True, 512), (1, True, 512)],
)
def test_production_mesh_refuses_another_world(fake_world, world, multi_pod, ranks):
    fake_world(world)
    with pytest.raises(ValueError, match=f"{PRODUCTION_MESH} .* takes {ranks} ranks"):
        make_production_mesh(multi_pod=multi_pod, device="cpu")


def _jax_shard_shapes(arch, model):
    """Each leaf's shard shape on a rank: the JAX specs' ``model`` entries
    divide their dims (no parameter is split over the data axis)."""
    jcfg = jax_get_config(arch)
    abstract = jax.eval_shape(
        lambda k: jmodel.init_params(jcfg, k), jax.random.PRNGKey(0)
    )
    specs = jsharding.param_specs(
        abstract, jmodel.stacked_flags(abstract), axis_size=model, cfg=jcfg
    )
    flat_a = jax.tree_util.tree_flatten_with_path(abstract)[0]
    flat_s = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))
    out = {}
    for (kp, leaf), spec in zip(flat_a, flat_s, strict=True):
        shape = list(leaf.shape)
        for i, e in enumerate(tuple(spec)):
            names = e if isinstance(e, tuple) else (e,)
            if "model" in names:
                shape[i] //= model
        out[jax.tree_util.keystr(kp)] = (tuple(shape), leaf.dtype.itemsize)
    return out


@pytest.mark.parametrize("arch", ["gemma3-1b", "mixtral-8x7b", "deepseek-v3-671b"])
def test_rank_parameters_on_the_production_mesh_are_the_jax_shards(fake_world, arch):
    """Rank 0's training state on the 32 x 8 mesh, drawn as the dry run
    draws it (fake tensors): every leaf's shape is the JAX spec's shard,
    and the bytes sum alike."""
    fake_world(256)
    mesh = make_production_mesh(device="cpu")
    cfg = get_config(arch)
    tp = ModelAxis(
        comm=make_model_comm(mesh), seq=ModelComm(), specs=train_param_specs(cfg, 8)
    )
    comp = make_model_compressor(cfg, CompressorConfig(name="none"))
    with fake_trace.fake_mode():
        state = init_train_state(cfg, 0, sgd(1e-2), comp, 1, "cpu", tp=tp, mesh=mesh)
    got = {
        p: (tuple(w.shape), w.element_size())
        for p, w in flatten_with_paths(state["params"])
    }
    want = _jax_shard_shapes(arch, 8)
    assert got == want
    leaves = [w for _, w in flatten_with_paths(state["params"])]
    nbytes = sum(w.numel() * w.element_size() for w in leaves)
    assert nbytes == sum(size * _prod(shape) for shape, size in want.values())


def _prod(shape):
    out = 1
    for d in shape:
        out *= d
    return out


def test_wire_bytes_keep_the_jax_ring_conventions():
    assert analysis._wire_bytes("all-reduce", 100) == 200
    assert analysis._wire_bytes("all-gather", 100) == 100
    assert analysis._wire_bytes("reduce-scatter", 100) == 200
    assert analysis._wire_bytes("all-to-all", 100) == 100
    assert analysis._wire_bytes("collective-permute", 100) == 100
    book = {
        "calls": {"tp.attn.wo": 3, "tp.q.gather": 1},
        "bytes": {"tp.attn.wo": 3 * 4096, "tp.q.gather": 512},
        "sent": {"tp.attn.wo": 3 * 4096, "tp.q.gather": 64},
        "ops": {"tp.attn.wo": "all-reduce", "tp.q.gather": "all-gather"},
    }
    st = analysis.collective_stats(book)
    assert st.counts == {"all-reduce": 3, "all-gather": 1}
    assert st.out_bytes == {"all-reduce": 3 * 4096, "all-gather": 512}
    assert st.wire_bytes == 2 * 3 * 4096 + 512 and st.total_out() == 3 * 4096 + 512
    assert analysis.collective_stats(None).wire_bytes == 0


def _stats(wire, op="all-reduce"):
    return analysis.CollectiveStats({op: 1}, {op: wire}, wire)


def test_roofline_terms_and_dominance_on_h100_constants():
    none = analysis.collective_stats(None)
    rep = analysis.RooflineReport(
        flops_per_device=hw.PEAK_FLOPS_BF16,  # 1 s of compute
        bytes_per_device=hw.HBM_BW / 10,  # 0.1 s
        model_axis=none,
        data_axis=none,
        chips=256,
    )
    assert rep.dominant == "compute" and rep.compute_s == 1.0
    assert rep.memory_s == pytest.approx(0.1, rel=1e-15)
    d = rep.as_dict()
    assert d["dominant"] == "compute" and d["chips"] == 256
    # the model axis on NVLink, the data axis on InfiniBand, summed
    rep = analysis.RooflineReport(
        flops_per_device=0.0,
        bytes_per_device=hw.HBM_BW,  # 1 s
        model_axis=_stats(hw.NVLINK_BW),  # 1 s
        data_axis=_stats(hw.IB_BW / 2),  # 0.5 s
        chips=512,
    )
    assert rep.model_collective_s == 1.0 and rep.data_collective_s == 0.5
    assert rep.collective_s == 1.5 and rep.dominant == "collective"
    d = rep.as_dict()
    assert d["collective_wire_bytes"] == hw.NVLINK_BW + hw.IB_BW / 2
    assert d["collective_counts"] == {"all-reduce": 2}
    assert hw.NVLINK_BW == 450e9 and hw.IB_BW == 50e9
    assert hw.GPUS_PER_NODE * hw.NODES_PER_SU == hw.GPUS_PER_SU == 256
    assert hw.NVLINK_LINK_BW == 25e9  # core/policy.py's CostModel reads it


def test_live_bytes_peak_over_known_allocations():
    """The tracker in PyTorch's fake mode: storages counted once (views
    free), freed storages leave ``live``, the peak stays; the same on real
    CPU tensors."""
    for fake in (True, False):
        mode = fake_trace.fake_mode() if fake else torch.no_grad()
        with mode:
            base = torch.empty(100, dtype=torch.float32)
            with fake_trace.count(live=[base, base[:10]]) as c:
                a = torch.empty(1000, dtype=torch.float32)
                b = torch.empty(500, dtype=torch.float32)
                a.view(10, 100).t()
                del a
                d = torch.empty(250, dtype=torch.float64)
            assert (c.arg_bytes, c.peak_bytes) == (400, 400 + 6000)
            assert c.end_bytes == 400 + 2000 + 2000
            del b, d


def test_trace_counts_one_product():
    m, k, n = 64, 32, 16
    with fake_trace.fake_mode():
        x = torch.empty(m, k)
        w = torch.empty(k, n, requires_grad=True)
        with fake_trace.count(live=[x, w]) as c:
            y = x @ w
            y.sum().backward()
    # forward 2mkn, the weight's gradient 2mkn (x needs none)
    assert c.flops == 4 * m * k * n
    # mm reads x and w and writes y; the views (t) are free
    assert c.bytes >= 4 * (m * k + k * n + m * n)


def test_trace_flops_are_flop_counter_modes():
    """The counter applies ``FlopCounterMode``'s formulas: a smoke LM's
    training forward and backward count the same under both."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.train.loss import lm_loss
    from repro_torch.train.step import init_train_params

    cfg = get_config("mixtral-8x7b", smoke=True)
    with fake_trace.fake_mode():
        params = init_train_params(cfg, 0, "cpu")
        tokens = torch.zeros((2, 16), dtype=torch.int32)
        got = []
        for mode in ("counter", "flop_counter_mode"):
            ctx = fake_trace.count() if mode == "counter" else FlopCounterMode(
                display=False
            )
            with ctx as c:
                loss, _ = lm_loss(params, {"tokens": tokens}, cfg=cfg)
                loss.backward()
            got.append(c.flops if mode == "counter" else c.get_total_flops())
    assert got[0] == got[1] > 0
