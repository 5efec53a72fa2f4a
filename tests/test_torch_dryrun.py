"""The port's dry run on the CPU (``launch/dryrun.py``): one rank's step
traced over fake tensors and a fake process group.

* A smoke config on a fake 2 x 2 mesh gives a record for train, prefill
  and decode, with the JAX record's keys (``trace_s`` and
  ``counted_flops_per_device`` renamed), memory that adds up, and the
  collectives of both axes. The bytes rank 0 puts into its data-axis wire
  collectives (its contributions: the codes it gathers, the scales it
  maxes, the raw leaves it sums; not the gathered output) equal the LQ-SGD
  record's ``phys_bits / 8`` exactly.
* Full-width gemma3-1b ``train_4k`` on the production mesh (32 x 8):
  the counted FLOPs lie within ``ANALYTIC_REL`` = 15% (the JAX package's
  pin of its model against the unrolled HLO) of the analytic model with
  the attention term charged as the plain attention computes it
  (``attn_ctx="dense"``: every one of the S keys, the mask applied after
  the products). The JAX model's causal S/2 and window terms are the one
  term that differs: against them the count is 1.5-2x, which the test
  states too.
* The CLI's refusals (``--lint``, XLA's own flags), a failed combination
  recorded as an error that fails the run, a fake CUDA tensor refused at a
  kernel's launch, and the report's tables.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import INPUT_SHAPES, get_config, shape_supported
from repro_torch.configs.base import InputShape
from repro_torch.core.compressors import CompressorConfig
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.roofline import fake_trace, hw, report

ANALYTIC_REL = 0.15
SMOKE_SHAPES = {
    "train": InputShape("train_4k", 32, 8, "train"),
    "prefill": InputShape("prefill_32k", 32, 4, "prefill"),
    "decode": InputShape("decode_32k", 32, 4, "decode"),
}
JAX_KEYS = {  # the JAX record's keys the port keeps (dryrun.py:166-197)
    "arch",
    "shape",
    "multi_pod",
    "status",
    "mode",
    "chips",
    "perf_tag",
    "dp_only",
    "compressor",
    "params_total",
    "params_active",
    "tokens_per_step",
    "model_flops",
    "analytic_flops_per_device",
    "useful_flops_ratio",
    "memory",
    "compressor_wire_bits_per_step",
    "flops_per_device",
    "bytes_per_device",
    "collective_wire_bytes",
    "collective_counts",
    "collective_out_bytes",
    "compute_s",
    "memory_s",
    "collective_s",
    "dominant",
}


@pytest.fixture(scope="module")
def smoke_records():
    cfg = get_config("gemma3-1b", smoke=True)
    comp = CompressorConfig(name="lq_sgd", rank=1, bits=8)
    return {
        mode: dryrun.trace_one(
            cfg, shape, mesh=(2, 2), comp_cfg=comp, device="cpu", verbose=False
        )
        for mode, shape in SMOKE_SHAPES.items()
    }


@pytest.mark.parametrize("mode", list(SMOKE_SHAPES))
def test_smoke_records_on_a_fake_2x2_mesh(smoke_records, mode):
    r = smoke_records[mode]
    assert r["status"] == "ok" and r["mode"] == mode
    assert JAX_KEYS <= set(r) and "trace_s" in r and "counted_flops_per_device" in r
    assert "compile_s" not in r and "hlo_flops_per_device_measured" not in r
    assert r["chips"] == 4 and r["mesh"] == [2, 2] and r["device"] == "cpu"
    assert r["flops_per_device"] == r["counted_flops_per_device"] > 0
    mem = r["memory"]
    assert set(mem) == {
        "argument_bytes",
        "output_bytes",
        "temp_bytes",
        "alias_bytes",
        "peak_est_bytes",
        "hbm_bytes_per_chip",
    }
    assert mem["hbm_bytes_per_chip"] == hw.HBM_BYTES == 80e9
    assert mem["peak_est_bytes"] == (
        mem["argument_bytes"]
        + mem["output_bytes"]
        + mem["temp_bytes"]
        - mem["alias_bytes"]
    )
    assert mem["temp_bytes"] >= 0 and mem["peak_est_bytes"] >= mem["argument_bytes"]
    assert r["param_bytes"] <= mem["argument_bytes"]
    # the model axis splits the products: its all-reduces on NVLink
    assert r["model_axis_counts"].get("all-reduce", 0) > 0
    assert r["model_collective_s"] == r["model_axis_wire_bytes"] / hw.NVLINK_BW
    assert r["data_collective_s"] == r["data_axis_wire_bytes"] / hw.IB_BW
    assert r["compute_s"] == r["flops_per_device"] / hw.PEAK_FLOPS_BF16


def test_train_record_donates_its_state_and_syncs_over_the_data_axis(smoke_records):
    r = smoke_records["train"]
    mem = r["memory"]
    # the state is updated in place: what the step returns is the state
    assert mem["alias_bytes"] > 0 and mem["alias_bytes"] >= r["param_bytes"]
    assert r["data_axis_counts"]["all-gather"] > 0
    assert r["compressor_wire_bits_per_step"] > 0


def test_data_axis_contributions_are_the_phys_bits(smoke_records):
    """What rank 0 puts into its data-axis wire (gathers, scale maxes and
    raw sums; each its own contribution) is LQ-SGD's physical wire."""
    r = smoke_records["train"]
    sent = r["data_axis_sent_bytes"]
    assert set(sent) <= {"all_gather", "pmax", "psum"} and "all_gather" in sent
    assert sum(sent.values()) * 8 == r["compressor_phys_bits"] > 0


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_serving_records_hold_no_wire(smoke_records, mode):
    r = smoke_records[mode]
    assert r["compressor_wire_bits_per_step"] == 0
    assert "compressor_phys_bits" not in r
    if mode == "decode":  # the cache is appended in place
        assert r["memory"]["alias_bytes"] > 0


def test_full_width_gemma3_train_flops_are_the_analytic_models():
    """One rank of gemma3-1b at train_4k on 32 x 8 (8 rows of 4096 tokens,
    remat): counted FLOPs within 15% of the analytic model, attention
    charged as computed; the JAX model's causal attention term is the one
    that differs."""
    r = dryrun.trace_one("gemma3-1b", "train_4k", device="cpu", verbose=False)
    assert r["chips"] == 256 and r["mesh"] == [32, 8]
    counted = r["counted_flops_per_device"]
    dense = r["analytic_dense_attn_flops_per_device"]
    assert abs(counted - dense) / dense < ANALYTIC_REL
    # against the JAX model: the plain attention spans 4096 keys where it
    # charges 2048 (global layers) and 512 (the 22 windowed layers)
    assert 1.5 < counted / r["analytic_flops_per_device"] < 2.0
    # the data axis ships LQ-SGD's codes, the rank's phys bits
    assert sum(r["data_axis_sent_bytes"].values()) * 8 == r["compressor_phys_bits"]
    assert r["memory"]["peak_est_bytes"] < hw.HBM_BYTES


def test_cli_refusals():
    base = ["--arch", "gemma3-1b", "--shape", "train_4k", "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="item 18"):
        dryrun.main(base + ["--lint"])
    for flag in (["--unroll"], ["--moe-hints"], ["--dump-hlo", "x.txt"]):
        with pytest.raises(ValueError, match="acts on XLA alone"):
            dryrun.main(base + flag)
    with pytest.raises(ValueError, match="--multi-pod"):
        dryrun.main(base + ["--mesh", "2x2", "--multi-pod"])


def test_a_failed_combination_is_an_error_record(monkeypatch, tmp_path):
    def boom(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(dryrun, "trace_one", boom)
    out = tmp_path / "r.json"
    argv = ["--arch", "gemma3-1b", "--shape", "decode_32k", "--device", "cpu"]
    with pytest.raises(SystemExit, match="1 combination"):
        dryrun.main(argv + ["--out", str(out)])
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "error" and "boom" in rec["error"]


def test_long_context_is_skipped_for_full_attention():
    r = dryrun.trace_one("qwen2-72b", "long_500k", device="cpu", verbose=False)
    assert r["status"] == "skipped"
    assert shape_supported("gemma3-1b", "long_500k")


def test_a_fake_cuda_tensor_never_reaches_a_kernel():
    with fake_trace.fake_mode():
        x = torch.empty(64, device="cuda")
        with pytest.raises(RuntimeError, match="fake tensor reached a kernel"):
            ops.log_quantize(x, 1.0)
        with ops.reference_mode():
            assert ops.log_quantize(x, 1.0).shape == x.shape


def test_report_tables(smoke_records):
    recs = {}
    for mode, r in smoke_records.items():
        r = {**r, "arch": "gemma3-1b"}
        recs[(r["arch"], r["shape"], False)] = r
    recs[("gemma3-1b", "long_500k", False)] = {"status": "skipped"}
    table = report.dryrun_table(recs, False)
    assert "peak fits 80GB?" in table and "16GB" not in table
    rows = [line for line in table.splitlines() if line.startswith("| gemma3-1b ")]
    assert len(rows) == 3 and "| ok |" in rows[0]
    assert table.endswith("Skipped (full attention): gemma3-1b long_500k.")
    roof = report.roofline_table(recs)
    assert len(roof.splitlines()) == 2 + 3
    assert INPUT_SHAPES["train_4k"].name in roof


@pytest.mark.parametrize(
    "flag, ranks", [("--production-mesh", 256), ("--multi-pod", 512)]
)
def test_serve_launcher_takes_the_production_mesh(flag, ranks):
    """At a world of one process the serving launcher's production meshes
    raise, naming the ranks they take (the training launcher's:
    ``tests/test_torch_runtime.py``)."""
    from repro_torch.launch import serve as launch_serve

    argv = ["--arch", "gemma3-1b", "--smoke", "--device", "cpu", flag]
    with pytest.raises(ValueError, match=f"takes {ranks} ranks, not 1"):
        launch_serve.main(argv)
