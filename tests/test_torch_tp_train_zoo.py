"""The port's tensor-parallel training of the rest of the zoo on the CPU,
against its one-process run and the JAX package.

ONE spawn of 4 gloo ranks (``_torch_tp_train_zoo.py`` through
``_torch_dist.spawn``) trains the f32 smoke configs of mixtral-8x7b (MoE:
one or two of 4 experts a rank), deepseek-v3-671b (MLA, the shared expert,
the MTP head), jamba-v0.1-52b (Mamba-2, attention and MoE layers),
musicgen-medium (codebooks, the conditioning prefix) and mamba2-370m, on
the zoo tests' weights, at meshes 2x2 and 1x4, with ``none`` and
``lq_sgd`` b8 (and musicgen with b4 at 2x2), 3 SGD steps each, against the
one-process port (``SimComm`` of the data axis) on the same weights and
batches. Each run is held as ``test_torch_tp_train.py`` holds the dense
models (its checks, shared): step 0's per-worker gradient of every leaf is
the block of the one-process one (within 1e-5 of the leaf's largest
value); the wire, the synced gradients, error feedback and parameters;
replicated leaves bit-identical across ranks; the accounted and physical
bits the plan's.

Each fault that training over the model axis would carry if the refusal
were only lifted has its own test: MLA's gathered latents (the
down-projections' gradients and what flows into the layer's input), the
MoE load-balance loss charged once (the router's gradient with
``router_aux_coef`` raised to 1.0), the MTP head's CE, musicgen's codebook
CE, and a training step's routing without the data-axis gather of
serving. In the same spawn: deepseek ``lq_sgd`` b8 at 2x2 from the JAX
package's compressor state against the JAX step composed from its parts,
``launch/train.py --mesh 2x2`` on mixtral against one process, its
checkpoint resumed in one process, and a time pin.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import _torch_dist as td
import _torch_tp_train as tt
import _torch_tp_train_zoo as tz
import jax
import numpy as np
import test_torch_tp_train as ttt
from _torch_lm import zoo_models

from repro_torch.launch import train as launch_train

RANKS_S = 100  # the ranks' work, their imports excluded
LOSS_RTOL = ttt.LOSS_RTOL


@pytest.fixture(scope="module")
def zoo_run(tmp_path_factory):
    """The inputs, the spawn, then the one-process and JAX references while
    the ranks run, and the resume of the ranks' checkpoint."""
    tmp = tmp_path_factory.mktemp("tp_train_zoo")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        weights = {arch: zoo_models(arch)[2] for arch in tz.ARCHS}
        arch, (data, _), cname = tz.JAX_RUN
        jcomp = ttt._jax_parts(arch, cname, data)[0]
        jax_comp = jax.tree.map(np.asarray, jcomp.init_state(jax.random.PRNGKey(1)))
        inputs = dict(weights=weights, jax_comp=jax_comp)
        inputs_path = str(tmp / "inputs.pt")
        torch.save(inputs, inputs_path)
        join = td.spawn(
            inputs_path,
            str(tmp),
            world=tz.WORLD,
            target=tz.run_rank,
            extra=(inputs_path,),
        )
        one = {}
        for arch, (data, _), cname in tz.run_names():
            if (arch, data, cname) not in one:
                one[(arch, data, cname)] = tt.train_run(
                    arch, weights[arch], tz.batches(arch), cname, (data, 1)
                )
        arch, (data, _), cname = tz.AUX_RUN
        one["aux"] = tt.train_run(
            arch,
            weights[arch],
            tz.batches(arch),
            cname,
            (data, 1),
            cfg=tz.config(arch, aux=True),
        )
        arch = tz.JAX_RUN[0]
        tokens = tz.batches(arch)[0]["tokens"]
        jax_ref = ttt.jax_step_of_parts(weights[arch], tokens, jax_comp, tz.JAX_RUN)
        one_argv = tz.LAUNCH_ARGS + ["--mesh", "2x1"]
        uninterrupted, _ = td.quiet_call(
            launch_train.main, one_argv + ["--steps", str(tz.LAUNCH_STEPS)]
        )
        ranks = join()
        resumed, _ = td.quiet_call(
            launch_train.main,
            one_argv
            + ["--steps", str(tz.LAUNCH_STEPS), "--resume"]
            + ["--ckpt-path", str(tmp / "tp.ckpt")],
        )
    finally:
        torch.set_num_threads(n)
    return ranks, dict(
        one=one,
        jax=jax_ref,
        uninterrupted=uninterrupted["history"],
        resumed=resumed["history"],
    )


RUN_IDS = [f"{a}-{m[0]}x{m[1]}-{c}" for a, m, c in tz.run_names()]
RUNS = dict(zip(RUN_IDS, tz.run_names()))


def _one(ref, run):
    arch, (data, _), cname = run
    return ref["one"][(arch, data, cname)]


def _runs_of(*archs):
    return [name for name, run in RUNS.items() if run[0] in archs]


@pytest.mark.parametrize("name", RUN_IDS)
def test_step0_gradients_are_the_blocks_of_one_process(zoo_run, name):
    """The per-worker gradient of every leaf into the sync (the partial ones
    of replicated leaves summed over the model axis) against the block of
    the one-process worker's, within 1e-5 of the leaf's largest value."""
    ranks, ref = zoo_run
    run = RUNS[name]
    ttt.check_step0_gradients(ranks, run, _one(ref, run), name)


@pytest.mark.parametrize("name", RUN_IDS)
def test_wire_is_the_blocks_of_one_process(zoo_run, name):
    ranks, ref = zoo_run
    run = RUNS[name]
    ttt.check_wire(ranks, run, _one(ref, run), run, name)


@pytest.mark.parametrize("name", RUN_IDS)
def test_synced_state_and_parameters_close_to_one_process(zoo_run, name):
    ranks, ref = zoo_run
    run = RUNS[name]
    ttt.check_synced(ranks, run, _one(ref, run), run, name)


@pytest.mark.parametrize("name", RUN_IDS)
def test_replicated_leaves_are_bit_identical_across_ranks(zoo_run, name):
    """The Mamba-2 mixer, the router and every other leaf the model axis
    does not split: the same bits on all four ranks."""
    ttt.check_replicated(zoo_run[0], RUNS[name], name)


@pytest.mark.parametrize("name", RUN_IDS)
def test_wire_bits_and_collectives_are_the_plans(zoo_run, name):
    """The accounted bits the JAX package's global figure, the data-axis
    collectives one process's; a data row's model ranks ship the
    accounting plus (M - 1) x the bits replicated over the axis (the
    Mamba-2 and router leaves among them)."""
    ranks, ref = zoo_run
    run = RUNS[name]
    ttt.check_bits(ranks, run, _one(ref, run), run)


@pytest.mark.parametrize("name", _runs_of("deepseek-v3-671b"))
def test_mla_latent_gradients_are_one_process(zoo_run, name):
    """MLA's column-split ``wq_a`` / ``wkv_a``, gathered before the norms
    and the head-split up-projections: each rank's gradient of a gathered
    latent is its heads' part, so the gather's backward must sum the ranks'
    before it keeps its block. The down-projections, the latent norms and,
    through the layers' input, the embedding and the pre-norms hold one
    process's gradient at a model axis of 2 (each data row of the 2x2
    mesh) and 4."""
    ranks, ref = zoo_run
    run = RUNS[name]
    worst = ttt.check_step0_gradients(ranks, run, _one(ref, run), name)
    named = {p: w for p, w in worst.items() if "wq_a" in p or "wkv_a" in p}
    assert len(named) == 2 * 3  # the lead, the scan and the MTP block's
    for key in ("q_a_norm", "kv_a_norm", "['embed']", "ln1"):
        assert any(key in p for p in worst), key
    print(f"{name}: largest shares {named}")


def test_router_gradient_counts_the_load_balance_loss_once(zoo_run):
    """mixtral at 2x2 with ``router_aux_coef`` 1.0: the load-balance loss is
    the same on every model rank, so its gradient must reach the router and
    the FFN's input once, not once a rank, while the combine weights'
    part is summed over the experts' ranks. The router's gradient, every
    other leaf's and the loss against one process's."""
    ranks, ref = zoo_run
    one = ref["one"]["aux"]
    worst = ttt.check_step0_gradients(ranks, "aux", one, "aux")
    assert any("router" in p for p in worst)
    for res in ranks:
        got = [m["moe_aux"] for m in res["aux"]["metrics"]]
        want = [m["moe_aux"] for m in one["metrics"]]
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
        np.testing.assert_allclose(res["aux"]["losses"], one["losses"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", _runs_of("deepseek-v3-671b"))
def test_mtp_ce_is_one_process(zoo_run, name):
    """The MTP head's vocab-parallel CE two ahead is reported and equals one
    process's at every step, as does the loss it joins at 0.3."""
    ranks, ref = zoo_run
    run = RUNS[name]
    one = _one(ref, run)
    want = [m["mtp_ce"] for m in one["metrics"]]
    for res in ranks:
        got = [m.get("mtp_ce") for m in res[run]["metrics"]]
        assert None not in got, name
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", _runs_of("musicgen-medium"))
def test_codebook_ce_is_one_process(zoo_run, name):
    """musicgen's vocab-parallel CE of its (B, S, cb) targets, averaged over
    the codebooks: one process's at every step."""
    ranks, ref = zoo_run
    run = RUNS[name]
    want = [m["ce"] for m in _one(ref, run)["metrics"]]
    for res in ranks:
        got = [m["ce"] for m in res[run]["metrics"]]
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize(
    "name", _runs_of("mixtral-8x7b", "deepseek-v3-671b", "jamba-v0.1-52b")
)
def test_a_training_step_routes_without_the_data_axis_gather(zoo_run, name):
    """Each worker routes its own rows through its own capacity table, as
    the JAX step's vmapped workers do: no ``tp.moe.route`` gather (serving's
    global table over the data axis) runs in a training step; the combine
    weights' and the experts' input gradients are summed over the model
    axis once an MoE layer a step."""
    run = RUNS[name]
    cfg = tz.config(run[0])
    n_moe = sum(spec.moe for spec in cfg.layers) * tt.STEPS
    for res in zoo_run[0]:
        calls = res[run]["model_calls"]
        assert "tp.moe.route" not in calls, calls
        assert calls["tp.moe.w.grad"] == calls["tp.moe.in.grad"] == n_moe, calls


def test_one_step_from_the_jax_state_matches_the_jax_step(zoo_run):
    """deepseek ``lq_sgd`` b8 at 2x2 from the JAX package's warm-start Q,
    against the JAX step composed from its parts on the whole model: each
    worker's gradients (1e-5 of a leaf's largest value), the synced
    gradients and the parameters (``flip_tol``), the wire bits."""
    ranks, ref = zoo_run
    ttt.check_jax_step(ranks, "jax", ref["jax"], tz.JAX_RUN)


def test_launcher_over_ranks_equals_one_process(zoo_run):
    """``launch/train.py --mesh 2x2`` on mixtral: the losses of the
    one-process ``--mesh 2x1`` run; rank 0 alone prints, the step's time
    and its shares in the two axes' collectives among it."""
    ranks, ref = zoo_run
    want = [h["loss"] for h in ref["uninterrupted"][: tz.CKPT_STEPS]]
    for res in ranks:
        got = [h["loss"] for h in res["launch"]["history"]]
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    printed = ranks[0]["launch"]["printed"]
    assert "arch=mixtral-8x7b-smoke" in printed
    assert "# mesh: {'data': 2, 'model': 2} over 4 ranks (gloo)" in printed
    line = next(x for x in printed.splitlines() if x.startswith("# tp step: "))
    assert "model-axis collectives" in line and "data-axis" in line, line
    assert all(res["launch"]["printed"] == "" for res in ranks[1:])


def test_sharded_checkpoint_resumes_in_one_process(zoo_run):
    """The 2x2 checkpoint of mixtral's expert stacks (written in the
    one-process layout) resumed in one process: its later steps equal the
    uninterrupted one-process run's."""
    ranks, ref = zoo_run
    want = [h["loss"] for h in ref["uninterrupted"][tz.CKPT_STEPS :]]
    got = [h["loss"] for h in ref["resumed"]]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert [h["step"] for h in ref["resumed"]] == [tz.CKPT_STEPS]


def test_tp_train_zoo_file_stays_within_its_time(zoo_run):
    for res in zoo_run[0]:
        assert res["seconds"] < RANKS_S, res["seconds"]


def test_jax_is_not_imported_by_the_tp_train_zoo_rank_helper():
    src = open(tz.__file__).read()
    assert "import jax" not in src and "from repro." not in src


@functools.cache
def _flat_specs(arch, size):
    from repro_torch.launch.sharding import spec_tree_leaves
    from repro_torch.train.step import train_param_specs

    return dict(spec_tree_leaves(train_param_specs(tz.config(arch), size)))


@pytest.mark.parametrize("size", [2, 4])
def test_expert_stacks_split_by_experts_and_the_mixers_replicate(size):
    """The smoke trees the spawn trains: mixtral's expert stacks split on E
    (the row split of their (E*D, F) matricization), its router whole;
    jamba's Mamba-2 projections whole."""
    specs = _flat_specs("mixtral-8x7b", size)
    assert specs["['scan'][0]['ffn']['w_gate']"] == (None, "model", None, None)
    assert specs["['scan'][0]['ffn']['router']"] == (None, None, None)
    specs = _flat_specs("jamba-v0.1-52b", size)
    assert specs["['scan'][0]['mixer']['in_proj']"] == (None, None, None)


@pytest.mark.parametrize("n", [100, 128, 4096, 7168, 14336, 129280])
def test_dump_sample_keeps_the_same_positions_of_a_block(n):
    """``launch/train.py --dump-sample``: the positions a rank keeps of its
    block of a leaf's last dim are the whole leaf's kept positions in that
    block, for every model axis that divides 8 and the dim, at least 64 of
    them where the dim has that many."""
    stride = launch_train.sample_stride(n)
    whole = torch.arange(n)
    kept = whole[::stride]
    assert len(kept) >= min(n, 64)
    for m in (1, 2, 4, 8):
        if n % m:
            continue
        size = n // m
        for r in range(m):
            block = whole[r * size : (r + 1) * size][::stride]
            assert torch.equal(block, kept[r * len(block) : (r + 1) * len(block)])
