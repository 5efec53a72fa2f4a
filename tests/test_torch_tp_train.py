"""The port's tensor-parallel training on the CPU, against its one-process run
and the JAX package.

* Spec parity, exact: ``GradCompressor.state_pspecs`` against the JAX
  package's for ``powersgd`` and ``lq_sgd`` on abstract trees of all ten
  architectures at model axes of 1, 2, 4 and 8; the leaves whose gradient
  a rank holds in part (``launch/sharding.py:partial_grad_flags``); the
  sharded training init. The per-run checks of the spawn are helpers
  (``check_*``) that ``test_torch_tp_train_zoo.py`` shares.
* ONE spawn of 4 gloo ranks (``_torch_tp_train.py`` through
  ``_torch_dist.spawn``) trains gemma3-1b (a replicated K/V projection over
  one KV head), mistral-nemo-12b (every attention leaf split at 2, the K/V
  replicated at 4), qwen2-72b (split biases) and granite-20b (MQA), f32
  smoke configs on the zoo tests' weights, at meshes 2x2 and 1x4, with
  ``none``, ``powersgd`` (rank 2) and ``lq_sgd`` b8 / b4, 3 SGD steps each,
  against the one-process port (``SimComm`` of the data axis) on the same
  weights and batches:

  - step 0's per-worker gradient of every leaf is the block of the
    one-process one (``assert_leaves_close``'s default: within 1e-5 of the
    leaf's largest value, rtol 1e-4);
  - the wire: f32 factors within that tolerance, LQ-SGD codes within one
    step (flips counted), each data-axis gather against the block of the
    one-process gather its split cuts;
  - every step's synced gradient, the final error feedback and parameters
    within 1e-5 of the leaf's largest value (the f32 wires), or
    :func:`_torch_lm.flip_tol` per step (LQ-SGD: a code on a bin edge may
    flip, and a flip's move is carried into the later steps);
  - replicated leaves bit-identical on every rank, split ones on the ranks
    of one model coordinate;
  - the accounted wire bits equal the JAX package's global figure, the
    data-axis collectives the plan's, and the model ranks' physical bits
    sum to the accounting plus (M - 1) x the replicated factors' bits.

  In the same spawn: gemma3-1b ``lq_sgd`` b8 at 2x2 from the JAX package's
  compressor state against the JAX step composed from its parts (its
  gradients, its sync under vmap'd workers, its SGD); ``launch/train.py
  --mesh 2x2`` against one process; a 2x2 checkpoint resumed in one
  process and a one-process checkpoint resumed on 2x2; the launcher at 2x2
  with TopK, QSGD, dlog, a per-leaf policy, lazy groups, the server wire at
  participation 0.5 and 1.0, the async runtime and microbatches, each
  against its one-process ``--mesh 2x1`` run; a time pin.

``test_torch_tp_train_wire.py`` holds those compressors' synced blocks and
state to one process and the JAX step.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import _torch_dist as td
import _torch_tp_train as tt
import jax
import jax.numpy as jnp
import numpy as np
from _torch_lm import flip_tol, zoo_models
from conftest import broadcast_state, simulate_workers
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.core import AxisComm
from repro.core import CompressorConfig as JaxCompressorConfig
from repro.launch import sharding as jsharding
from repro.models import model as jmodel
from repro.train import optimizer as jax_opt
from repro.train import step as jax_step
from repro.train.loss import lm_loss as jax_lm_loss
from repro_torch.configs import get_config
from repro_torch.core.codec import unpack_nibbles
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.tree import flatten_with_paths, tree_leaves
from repro_torch.launch import sharding as tsharding
from repro_torch.launch import train as launch_train
from repro_torch.train.step import make_model_compressor, train_param_specs

SPEC_ARCHS = (
    "gemma3-1b",
    "mistral-nemo-12b",
    "qwen2-72b",
    "granite-20b",
    "chameleon-34b",
    "mixtral-8x7b",
    "deepseek-v3-671b",
    "jamba-v0.1-52b",
    "musicgen-medium",
    "mamba2-370m",
)
SPEC_SIZES = (1, 2, 4, 8)
# CompressorConfig fields by case: the dedicated compressors, and a lazy
# composite (lazy_out / lazy_ref mirror their parameters)
SPEC_CONFIGS = {
    "powersgd": dict(name="powersgd"),
    "lq_sgd": dict(name="lq_sgd"),
    "topk": dict(name="topk"),
    "qsgd": dict(name="qsgd"),
    "lazy": dict(
        name="lq_sgd",
        policy="w=powersgd:lazy_thresh=2.0,*=lq_sgd:lazy_thresh=2.0",
        lazy_adaptive=2.0,
    ),
}
SPEC_COMPRESSORS = tuple(SPEC_CONFIGS)
RANKS_S = 150  # the ranks' work, their imports excluded
F32_TOL = 1e-5  # of a leaf's largest value: f32 sums in other orders
LOSS_RTOL = 1e-5
MAX_FLIPS = 8  # one-step code flips at step 0, as the cache tests allow


# ------------------------------------------------------------ spec parity


@functools.cache
def _jax_abstract(arch):
    jcfg = jax_get_config(arch)
    abstract = jax.eval_shape(
        lambda k: jmodel.init_params(jcfg, k), jax.random.PRNGKey(0)
    )
    return jcfg, abstract


@functools.cache
def _jax_comp(arch, name):
    jcfg, _ = _jax_abstract(arch)
    jcc = JaxCompressorConfig(**SPEC_CONFIGS[name])
    jcomp = jax_step.make_model_compressor(jcfg, jcc)
    return jcomp, jax.eval_shape(jcomp.init_state, jax.random.PRNGKey(0))


def _jax_specs(arch, size, name):
    jcfg, abstract = _jax_abstract(arch)
    pspecs = jsharding.param_specs(
        abstract, jmodel.stacked_flags(abstract), axis_size=size, cfg=jcfg
    )
    jcomp, state = _jax_comp(arch, name)
    return jcomp.state_pspecs(state, pspecs, ("data",))


@functools.cache
def _port_comp(arch, name):
    from repro_torch.core.lazy import SHARED_NS

    cfg = get_config(arch)
    comp = make_model_compressor(cfg, CompressorConfig(**SPEC_CONFIGS[name]))
    state = comp.init_state(0, 1, "meta")

    def strip(v):  # the worker dim, where a leaf has one
        return v[0] if isinstance(v, torch.Tensor) and v.dim() else v

    inner = {
        ns: sub if ns in SHARED_NS or not isinstance(sub, dict) else {
            k: strip(v) for k, v in sub.items()
        }
        for ns, sub in state.items()
    }
    return comp, inner


@functools.cache
def _port_abstract(arch):
    from repro_torch.train.step import abstract_grads_of

    return abstract_grads_of(get_config(arch))


def _port_specs(arch, size):
    abstract, flags = _port_abstract(arch)
    return tsharding.param_specs(
        abstract, flags, axis_size=size, cfg=get_config(arch)
    )


def _jax_flat(specs):
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P)
    )[0]
    return {jax.tree_util.keystr(kp): tuple(s) for kp, s in flat}


def _port_flat(specs):
    return {path: tuple(s) for path, s in tsharding.spec_tree_leaves(specs)}


@pytest.mark.parametrize("name", SPEC_COMPRESSORS)
@pytest.mark.parametrize("size", SPEC_SIZES)
@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_state_pspecs_equal_jax(arch, size, name):
    """Every compressor-state leaf's spec, keyed as the JAX package keys it
    (namespace, flattened leaf index), on abstract shapes (no allocation):
    the error feedback and the lazy groups' cached aggregate and references
    mirror their parameters, the warm-start Q, the counters and the seed
    replicate (the port's seed is an int, the JAX package's a (2,) key)."""
    comp, inner = _port_comp(arch, name)
    got = _port_flat(comp.state_pspecs(inner, _port_specs(arch, size)))
    want = _jax_flat(_jax_specs(arch, size, name))
    if "['key']" in want:
        assert want.pop("['key']") == (None,) and got.pop("['key']") == ()
    assert got == want
    shaped = {"['err']", "['lazy_out']", "['lazy_ref']"}
    present = {p.split("]")[0] + "]" for p in got} & shaped
    split = {p.split("]")[0] + "]" for p, s in got.items() if "model" in s}
    assert split <= shaped
    if size > 1:
        assert split == present


@pytest.mark.parametrize(
    "arch, size, partial",
    [
        ("gemma3-1b", 2, {"wk", "wv", "q_norm", "k_norm"}),
        ("granite-20b", 2, {"wk", "wv"}),
        ("mistral-nemo-12b", 2, set()),
        ("mistral-nemo-12b", 16, {"wk", "wv"}),
        ("qwen2-72b", 16, {"wk", "wv", "bk", "bv"}),
        ("mixtral-8x7b", 2, set()),
        ("mixtral-8x7b", 16, {"wk", "wv"}),
        ("deepseek-v3-671b", 2, {"q_a_norm", "kv_a_norm"}),
        ("jamba-v0.1-52b", 16, {"wk", "wv"}),
        ("musicgen-medium", 8, set()),
        ("mamba2-370m", 2, set()),
    ],
)
def test_partial_grad_leaves_follow_the_specs(arch, size, partial):
    """The replicated leaves inside a split mixer or FFN, by name: never a
    pre-norm, the final norm or a leaf of a branch that does not split
    (a Mamba-2 mixer), nor an MoE router, which routes on the FFN's input
    itself; MLA's latent norms, in the trunk's layers and the MTP block's,
    inside a mixer whose heads split."""
    specs = _port_specs(arch, size)
    flags = tsharding.partial_grad_flags(specs)
    names, paths = set(), set()
    for (path, flag), (_, spec) in zip(
        tsharding.spec_tree_leaves(flags), tsharding.spec_tree_leaves(specs)
    ):
        if flag:
            assert tsharding.split_dim(spec) is None, path
            names.add(path.split("[")[-1].strip("']"))
            paths.add(path)
    assert names == partial
    cfg = get_config(arch)
    if cfg.mtp:
        assert "['mtp']['layer']['mixer']['q_a_norm']" in paths
        assert not any("['mtp']['proj']" in p or "norm_h" in p for p in paths)


# ------------------------------------------------------ the 4-rank spawn


def _tokens():
    rng = np.random.default_rng(17)
    return [
        torch.from_numpy(rng.integers(0, 512, (tt.BATCH, tt.SEQ)))
        for _ in range(tt.STEPS)
    ]


@functools.cache
def _jax_parts(arch, cname, n=tt.JAX_RUN[1][0]):
    """The JAX package's compressor, its jitted sync over ``n`` vmap'd
    workers and its jitted value-and-grad of ``lm_loss``."""
    jcfg = jax_get_config(arch, smoke=True)
    jcomp = jax_step.make_model_compressor(
        jcfg, JaxCompressorConfig(**tt.COMPRESSORS[cname])
    )

    def sync(g, st):
        out, st2, rec = jcomp.sync(g, st, AxisComm(("data",)))
        return out, st2

    def loss(p, tokens):
        return jax_lm_loss(p, {"tokens": tokens}, jcfg)

    vg = jax.jit(jax.value_and_grad(loss, has_aux=True))
    return jcomp, jax.jit(lambda g, st: simulate_workers(sync, n, g, st)), vg


def jax_step_of_parts(weights, tokens, jcomp_state, run=tt.JAX_RUN):
    """One JAX step of ``run`` composed from its parts: per-worker
    gradients, the sync, SGD."""
    arch, (n, _), cname = run
    jcomp, jsync, vg = _jax_parts(arch, cname, n)
    jparams = jax.tree.map(jnp.asarray, weights)
    rows = np.asarray(tokens).reshape(n, tt.BATCH // n, tt.SEQ)
    outs = [vg(jparams, jnp.asarray(r)) for r in rows]
    grads = jax.tree.map(lambda *g: jnp.stack(g), *[g for _, g in outs])
    synced, _ = jsync(grads, broadcast_state(jcomp_state, n))
    synced = jax.tree.map(lambda x: x[0], synced)
    jopt = jax_opt.sgd(tt.LR)
    params, _ = jopt.update(synced, jopt.init(jparams), jparams)
    host = functools.partial(jax.tree.map, np.asarray)
    return dict(
        grads=host(grads),
        synced=host(synced),
        params=host(params),
        wire_bits=jcomp.wire_bits_per_step(),
    )


@functools.cache
def jax_wire_bits(arch, cname):
    jcfg = jax_get_config(arch, smoke=True)
    jcomp = jax_step.make_model_compressor(
        jcfg, JaxCompressorConfig(**tt.COMPRESSORS[cname])
    )
    return jcomp.wire_bits_per_step()


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """The inputs, the spawn, then the one-process and JAX references while
    the ranks run, and the resume of the ranks' checkpoint."""
    tmp = tmp_path_factory.mktemp("tp_train")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        weights = {arch: zoo_models(arch)[2] for arch in tt.ARCHS}
        tokens = _tokens()
        arch, _, cname = tt.JAX_RUN
        jcomp = _jax_parts(arch, cname)[0]
        jax_comp = jax.tree.map(np.asarray, jcomp.init_state(jax.random.PRNGKey(1)))
        one_ckpt = str(tmp / "one.ckpt")
        one_argv = tt.LAUNCH_ARGS + ["--mesh", "2x1"]
        td.quiet_call(
            launch_train.main,
            one_argv
            + ["--steps", str(tt.CKPT_STEPS), "--ckpt-every", "1"]
            + ["--ckpt-path", one_ckpt],
        )
        inputs = dict(
            weights=weights, tokens=tokens, jax_comp=jax_comp, one_ckpt=one_ckpt
        )
        inputs_path = str(tmp / "inputs.pt")
        torch.save(inputs, inputs_path)
        join = td.spawn(
            inputs_path,
            str(tmp),
            world=tt.WORLD,
            target=tt.run_rank,
            extra=(inputs_path,),
        )
        one = {}
        for arch, (data, _), cname in tt.run_names():
            if (arch, data, cname) not in one:
                one[(arch, data, cname)] = tt.train_run(
                    arch, weights[arch], tokens, cname, (data, 1)
                )
        jax_ref = jax_step_of_parts(weights[tt.JAX_RUN[0]], tokens[0], jax_comp)
        uninterrupted, _ = td.quiet_call(
            launch_train.main, one_argv + ["--steps", str(tt.LAUNCH_STEPS)]
        )
        ranks = join()
        resumed, _ = td.quiet_call(
            launch_train.main,
            one_argv
            + ["--steps", str(tt.LAUNCH_STEPS), "--resume"]
            + ["--ckpt-path", str(tmp / "tp.ckpt")],
        )
        cases = {
            name: td.quiet_call(
                launch_train.main, tt.case_argv(name, ["--mesh", "2x1"])
            )[0]["history"]
            for name in tt.LAUNCH_CASES
        }
    finally:
        torch.set_num_threads(n)
    return ranks, dict(
        one=one,
        jax=jax_ref,
        uninterrupted=uninterrupted["history"],
        resumed=resumed["history"],
        cases=cases,
    )


RUN_IDS = [f"{a}-{m[0]}x{m[1]}-{c}" for a, m, c in tt.run_names()]
RUNS = dict(zip(RUN_IDS, tt.run_names()))


def _one(ref, run):
    arch, (data, _), cname = run
    return ref["one"][(arch, data, cname)]


def _block(x, dim, res):
    """The rank's block of a whole leaf ``x`` split on ``dim`` (None: all)."""
    if dim is None:
        return x
    m, size = res["coords"]["model"], res["sizes"]["model"]
    n = x.shape[dim] // size
    return x.narrow(dim, m * n, n)


def _close(got, want, label, atol_rel, rtol=1e-4):
    g, w = got.detach().float().numpy(), want.detach().float().numpy()
    assert g.shape == w.shape, (label, g.shape, w.shape)
    atol = atol_rel * max(float(np.abs(w).max()), 1e-30)
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=label)


def _lq(run):
    return tt.COMPRESSORS[run[2]]["name"] == "lq_sgd"


def _value_tol(run, steps=1):
    """F32_TOL for the f32 wires; for LQ-SGD :func:`flip_tol` a step."""
    if not _lq(run):
        return F32_TOL
    return steps * flip_tol(tt.COMPRESSORS[run[2]]["bits"], run[1][0])


def check_step0_gradients(ranks, key, one, name):
    """Each rank's step-0 per-worker gradients of run ``key`` against the
    blocks of the one-process run ``one``'s (F32_TOL); returns the largest
    share of a leaf's largest value by leaf path."""
    want = flatten_with_paths(one["recs"][0]["grads"])
    worst = {}
    for res in ranks:
        r = res[key]
        d = r["coords"]["data"]
        got = flatten_with_paths(r["recs"][0]["grads"])
        for (path, g), (_, w), dim in zip(got, want, r["dims"], strict=True):
            block = _block(w[d], dim, r)
            _close(g[0], block, f"{name} rank {res['rank']} {path}", F32_TOL)
            top = max(float(block.abs().max()), 1e-30)
            share = float((g[0] - block).abs().max()) / top
            worst[path] = max(worst.get(path, 0.0), share)
    return worst


@pytest.mark.parametrize("name", RUN_IDS)
def test_step0_gradients_are_the_blocks_of_one_process(tp_run, name):
    """The per-worker gradient of every leaf into the sync (the partial ones
    of replicated leaves summed over the model axis) against the block of
    the one-process worker's."""
    run = RUNS[name]
    ranks, ref = tp_run
    check_step0_gradients(ranks, run, _one(ref, run), name)


def _wire_blocks(run, res, comp, fields=None):
    """For each data-axis gather of one step, in the sync's order (the raw
    leaves LQ-SGD quantizes, then every low-rank leaf's P, then its Q; a
    QSGD leaf's codes, with ``fields`` the ``CompressorConfig``'s):
    (leaf index, the factor's per-worker shape, the dim of it the rank
    holds a block of, or None, and that dim's unflattened sizes with the
    index of the one the model axis cuts: a P's rows are the leaf's dims
    but its last, so a rank's rows of a (cb, V, d) leaf split on V are a
    block of every codebook's)."""
    out = []
    lowrank = [(i, pl) for i, pl in enumerate(comp.plans) if pl.route == "lowrank"]
    name = (fields or tt.COMPRESSORS[run[2]])["name"]
    if name == "qsgd":
        for i, pl in lowrank:
            dim = res["dims"][i]
            rows = None if dim is None else ((pl.shape[dim],), 0)
            out.append((i, pl.shape, dim, rows))
        return out
    if name == "lq_sgd":
        for i, pl in enumerate(comp.plans):
            if pl.route != "lowrank":
                dim = res["dims"][i]
                rows = None if dim is None else ((pl.shape[dim],), 0)
                out.append((i, pl.shape, dim, rows))
    for phase in ("p", "q"):
        for i, pl in lowrank:
            n, m = pl.mat_shape
            lead = (pl.shape[0],) if pl.stacked else ()
            shape = lead + ((n if phase == "p" else m), pl.eff_rank)
            dim = res["dims"][i]
            kind = None if dim is None else (
                "col" if dim == len(pl.shape) - 1 else "row"
            )
            if phase == "p" and kind == "row":
                rows = (pl.shape[len(lead) : -1], dim - len(lead))
                out.append((i, shape, len(shape) - 2, rows))
            elif phase == "q" and kind == "col":
                out.append((i, shape, len(shape) - 2, ((m,), 0)))
            else:
                out.append((i, shape, None, None))
    return out


def _factor_block(w, dim, rows, res):
    """The rank's block of a gathered (N, ...) factor ``w`` whose per-worker
    ``dim`` flattens the sizes ``rows[0]``, of which the model axis cuts
    the one at ``rows[1]`` (:func:`_wire_blocks`)."""
    sizes, cut = rows
    shape = w.shape[: dim + 1] + tuple(sizes) + w.shape[dim + 2 :]
    block = _block(w.reshape(shape), dim + 1 + cut, res)
    return block.reshape(w.shape[: dim + 1] + (-1,) + w.shape[dim + 2 :])


def _codes(arr, shape, bits):
    """A gathered (N, wire) array as (N, *shape) values (codes for LQ-SGD)."""
    numel = int(np.prod(shape))
    if bits is not None and bits <= 4:
        arr = unpack_nibbles(arr, 2 * arr.shape[-1])[:, :numel]
    return arr.reshape((arr.shape[0],) + tuple(shape))


@pytest.mark.parametrize("name", RUN_IDS)
def test_wire_is_the_blocks_of_one_process(tp_run, name):
    """Every data-axis gather of every step has the layout of the block of
    the one-process gather its split cuts; at step 0, whose inputs are the
    same up to rounding, LQ-SGD codes are within one step, at most
    MAX_FLIPS of them moved (a factor on a bin edge), and f32 factors
    within F32_TOL. The later steps' factors come from parameters that
    already carry a flip's move, so they are held through the synced
    gradients (:func:`_value_tol`)."""
    run = RUNS[name]
    ranks, ref = tp_run
    check_wire(ranks, run, _one(ref, run), run, name)


def check_wire(ranks, key, one, run, name, cfg=None, fields=None, max_step=1):
    """:func:`test_wire_is_the_blocks_of_one_process`'s checks of the ranks'
    run ``key`` (``run``: its (arch, mesh, compressor); ``cfg``: its config,
    smoke by default; ``fields``: its ``CompressorConfig``'s, by default
    the compressor's) against the one-process run ``one``; a moved code
    moves at most ``max_step`` steps."""
    arch, _, cname = run
    cfg = cfg if cfg is not None else get_config(arch, smoke=True)
    fields = fields if fields is not None else tt.COMPRESSORS[cname]
    comp = make_model_compressor(cfg, CompressorConfig(**fields))
    coded = fields["name"] in ("lq_sgd", "qsgd")
    bits = fields.get("bits", 8) if coded else None
    one = one["gathered"]
    for res in ranks:
        r = res[key]
        layout = _wire_blocks(run, r, comp, fields)
        assert len(r["gathered"]) == len(one) == len(layout) * tt.STEPS, name
        flips = 0
        for j, (got, want) in enumerate(zip(r["gathered"], one)):
            _, shape, dim, rows = layout[j % len(layout)]
            w = _codes(want, shape, bits)
            bshape = list(shape)
            if dim is not None:
                bshape[dim] //= r["sizes"]["model"]
                w = _factor_block(w, dim, rows, r)
            g = _codes(got, bshape, bits)
            label = f"{name} rank {res['rank']} gather {j}"
            if j >= len(layout):
                continue  # later steps: held through the synced values
            if bits is None:
                _close(g, w, label, F32_TOL)
                continue
            diff = (g.int() - w.int()).abs()
            assert int(diff.max()) <= max_step, label
            flips += int((diff > 0).sum())
        assert flips <= MAX_FLIPS, f"{name}: {flips} code flips at step 0"


@pytest.mark.parametrize("name", RUN_IDS)
def test_synced_state_and_parameters_close_to_one_process(tp_run, name):
    run = RUNS[name]
    ranks, ref = tp_run
    check_synced(ranks, run, _one(ref, run), run, name)


def check_synced(ranks, key, one, run, name):
    """Every step's synced gradients, the final parameters and compressor
    state of the ranks' run ``key`` against the blocks of the one-process
    run ``one``'s (:func:`_value_tol`), and the losses."""
    for res in ranks:
        r = res[key]
        for s in range(tt.STEPS):
            got = flatten_with_paths(r["recs"][s]["synced"])
            want = flatten_with_paths(one["recs"][s]["synced"])
            tol = _value_tol(run, s + 1)
            for (path, g), (_, w), dim in zip(got, want, r["dims"], strict=True):
                _close(g, _block(w, dim, r), f"{name} step {s} synced {path}", tol)
        tol = _value_tol(run, tt.STEPS)
        got, want = flatten_with_paths(r["params"]), flatten_with_paths(one["params"])
        for (path, g), (_, w), dim in zip(got, want, r["dims"], strict=True):
            _close(g, _block(w, dim, r), f"{name} params {path}", tol)
        d = r["coords"]["data"]
        for leaf, g in r["err"].items():
            dim = r["dims"][int(leaf)]
            w = one["err"][leaf][d : d + 1]
            _close(g, _block(w, None if dim is None else dim + 1, r), leaf, tol)
        for leaf, g in r["q"].items():  # whole on every rank
            _close(g[0], one["q"][leaf][0], f"{name} q {leaf}", tol)
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", RUN_IDS)
def test_replicated_leaves_are_bit_identical_across_ranks(tp_run, name):
    """A leaf the model axis does not split is the same bits on all four
    ranks (every data row and model rank); a split one on the ranks of one
    model coordinate."""
    check_replicated(tp_run[0], RUNS[name], name)


def check_replicated(ranks, run, name):
    by_m = {}
    for res in ranks:
        by_m.setdefault(res[run]["coords"]["model"], []).append(res[run])
    first = tree_leaves(ranks[0][run]["params"])
    for res in ranks[1:]:
        for i, (a, b) in enumerate(zip(first, tree_leaves(res[run]["params"]))):
            if res[run]["dims"][i] is None:
                assert torch.equal(a, b), (name, i)
    for group in by_m.values():
        for res in group[1:]:
            for a, b in zip(tree_leaves(group[0]["params"]), tree_leaves(res["params"])):
                assert torch.equal(a, b), name


@pytest.mark.parametrize("name", RUN_IDS)
def test_wire_bits_and_collectives_are_the_plans(tp_run, name):
    """Every step: the accounted bits are the JAX package's global figure
    (whatever the mesh), the data-axis collectives the one-process count;
    the physical bits of a data row's model ranks sum to the accounting
    plus (M - 1) x the bits replicated over the model axis."""
    run = RUNS[name]
    ranks, ref = tp_run
    check_bits(ranks, run, _one(ref, run), run)


def check_bits(ranks, key, one, run):
    arch, (data, model), cname = run
    want_bits = jax_wire_bits(arch, cname)
    rows = {}
    for res in ranks:
        r = res[key]
        assert r["wire_bits"] == one["wire_bits"] == want_bits
        for s, rec in enumerate(r["recs"]):
            assert rec["bits"] == want_bits == one["recs"][s]["bits"]
            assert rec["colls"] == one["recs"][s]["colls"]
            rows.setdefault((r["coords"]["data"], s), []).append(
                (rec["phys"], r["replicated_bits"])
            )
    for (d, s), got in rows.items():
        assert len(got) == model
        rep = {b for _, b in got}
        assert len(rep) == 1
        assert sum(p for p, _ in got) == want_bits + (model - 1) * rep.pop(), (d, s)
    assert one["recs"][0]["phys"] == want_bits  # one process ships the accounting


def test_the_model_axis_collectives_by_tag(tp_run):
    """gemma3-1b lq_sgd at 2x2: each layer's split mixer and FFN sum their
    input's gradient once a step, their outputs' all-reduces run in the
    forward and again where the remat recompute reaches them (it stops
    after the last tensor the backward needs), the vocab-parallel loss's
    max and sums run in the forward and its chunk's recompute, the partial
    gradients go in one all-reduce a step, and the power iteration's
    model-axis P and Q sums, Gram-Schmidt norm and Q gather one each a
    step, its scale maxima one a phase with a split factor."""
    run = ("gemma3-1b", (2, 2), "lq_sgd_b8")
    cfg = get_config("gemma3-1b", smoke=True)
    n = len(cfg.layers) * tt.STEPS
    for res in tp_run[0]:
        calls = res[run]["model_calls"]
        assert calls["tp.attn.in.grad"] == calls["tp.mlp.in.grad"] == n
        assert n < calls["tp.attn.wo"] <= 2 * n and n < calls["tp.mlp.down"] <= 2 * n
        assert calls["tp.embed"] == calls["tp.head.in.grad"] == tt.STEPS
        assert calls["tp.loss.max"] == calls["tp.loss.sum"] == 2 * tt.STEPS
        for tag in ("tp.grad.partial", "tp.p", "tp.q", "tp.orth.norm", "tp.q.gather"):
            assert calls[tag] == tt.STEPS, tag
        assert calls["tp.scale"] == 2 * tt.STEPS


def test_one_step_from_the_jax_state_matches_the_jax_step(tp_run):
    """gemma3-1b ``lq_sgd`` b8 at 2x2 from the JAX package's warm-start Q,
    against the JAX step composed from its parts on the whole model: each
    worker's gradients (F32_TOL), the synced gradients and the parameters
    (:func:`flip_tol`), the wire bits."""
    ranks, ref = tp_run
    check_jax_step(ranks, "jax", ref["jax"], tt.JAX_RUN)


def check_jax_step(ranks, key, want, run, tol=None):
    """The ranks' one step of ``run`` (at ``key``) from the JAX package's
    compressor state against :func:`jax_step_of_parts`'s ``want``; ``tol``
    the synced values' (by default :func:`_value_tol`'s)."""
    tol = _value_tol(run) if tol is None else tol
    for res in ranks:
        r = res[key]
        d = r["coords"]["data"]
        for label, got, w, worker in (
            ("grads", r["recs"][0]["grads"], want["grads"], True),
            ("synced", r["recs"][0]["synced"], want["synced"], False),
            ("params", r["params"], want["params"], False),
        ):
            leaves = flatten_with_paths(got)
            wl = jax.tree.leaves(w)
            assert len(leaves) == len(wl)
            for (path, g), x, dim in zip(leaves, wl, r["dims"]):
                x = torch.from_numpy(np.asarray(x, np.float32))
                x = _block(x[d] if worker else x, dim, r)
                g = g[0] if worker else g
                _close(g, x, f"jax {label} {path}", F32_TOL if worker else tol)
        assert r["recs"][0]["bits"] == want["wire_bits"]


def test_launcher_over_ranks_equals_one_process(tp_run):
    """``launch/train.py --mesh 2x2``'s losses against the one-process
    ``--mesh 2x1`` run's; rank 0 alone prints, the mesh and the eager step
    among it."""
    ranks, ref = tp_run
    for res in ranks:
        got = [h["loss"] for h in res["launch"]["history"]]
        want = [h["loss"] for h in ref["uninterrupted"][: tt.CKPT_STEPS]]
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    printed = ranks[0]["launch"]["printed"]
    assert "# mesh: {'data': 2, 'model': 2} over 4 ranks (gloo)" in printed
    assert "# step: eager (graph=False)" in printed
    assert "mesh={'data': 2, 'model': 2}" in printed
    assert all(res["launch"]["printed"] == "" for res in ranks[1:])


def test_checkpoints_resume_across_the_mesh(tp_run):
    """A 2x2 checkpoint (the one-process layout, written by rank (d0, m0))
    resumed in one process, and a one-process checkpoint resumed on 2x2:
    each run's later steps equal the uninterrupted one-process run's."""
    ranks, ref = tp_run
    want = [h["loss"] for h in ref["uninterrupted"][tt.CKPT_STEPS :]]
    got = [h["loss"] for h in ref["resumed"]]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    for res in ranks:
        got = [h["loss"] for h in res["resumed"]["history"]]
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
        assert [h["step"] for h in res["resumed"]["history"]] == [2, 3]
    assert f"# resumed at step {tt.CKPT_STEPS}" in ranks[0]["resumed"]["printed"]


@pytest.mark.parametrize("name", list(tt.LAUNCH_CASES))
def test_launcher_trains_each_config_over_the_mesh(tp_run, name):
    """``launch/train.py --mesh 2x2`` with TopK, QSGD, dlog, a per-leaf
    policy, lazy groups, the server wire at participation 0.5 and 1.0, the
    async runtime and two microbatches: on every rank, the losses of the
    one-process ``--mesh 2x1`` run of the same argv."""
    ranks, ref = tp_run
    want = [h["loss"] for h in ref["cases"][name]]
    assert len(want) == tt.CASE_STEPS
    for res in ranks:
        got = [h["loss"] for h in res["cases"][name]]
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_a_capture_under_gloo_is_refused(tp_run):
    """A step over a gloo model axis cannot be one CUDA graph: its refusal
    names gloo (``graph=True`` raises with it on the card)."""
    for res in tp_run[0]:
        for run in tt.run_names():
            assert "gloo" in res[run]["refusal"], run


def test_tp_train_file_stays_within_its_time(tp_run):
    for res in tp_run[0]:
        assert res["seconds"] < RANKS_S, res["seconds"]


def test_jax_is_not_imported_by_the_tp_train_rank_helper():
    src = open(tt.__file__).read()
    assert "import jax" not in src and "from repro." not in src



@pytest.mark.parametrize(
    "arch",
    ["gemma3-1b", "qwen2-72b", "mixtral-8x7b", "deepseek-v3-671b", "musicgen-medium"],
)
def test_sharded_training_init_is_the_blocks_of_the_one_process_init(arch):
    """At 1x2 each rank's shards of the training tree (stacked scan leaves,
    cut by their specs as each layer is drawn) are the blocks of the
    one-process ``init_train_params``, and the blocks put back together
    are the whole leaf."""
    from repro_torch.launch.mesh import DataMesh
    from repro_torch.train.step import init_train_params
    from repro_torch.weights import init_sharded_params

    cfg = get_config(arch, smoke=True)
    whole = init_train_params(cfg, 1, "cpu")
    specs = train_param_specs(cfg, 2)

    def mesh(m):
        return DataMesh(2, 2, 4, m, 1, torch.device("cpu"), "gloo", 0, m)

    parts = [init_sharded_params(cfg, 1, "cpu", specs, mesh(m)) for m in (0, 1)]
    spec_of = dict(tsharding.spec_tree_leaves(specs))
    split = 0
    for (path, w), (_, a), (_, b) in zip(
        flatten_with_paths(whole), *(flatten_with_paths(p) for p in parts)
    ):
        dim = tsharding.split_dim(spec_of[path])
        if dim is None:
            assert torch.equal(a, w.detach()) and torch.equal(b, w.detach()), path
        else:
            split += 1
            assert torch.equal(torch.cat([a, b], dim), w.detach()), path
    assert split >= 6  # wq, wo, gate, up, down of the scan, the embedding
