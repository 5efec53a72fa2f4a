"""The port's tensor-parallel serving on the CPU, against the JAX package.

* Spec parity, exact: ``launch/sharding.py:param_specs`` against the JAX
  package's for each of the ten architectures (full configs, abstract
  shapes) at model axes of 1, 2, 4, 8 and 16, and its serving-tree form
  against the JAX spec of the stacked leaf each layer unstacks from;
  ``serving/engine.py:cache_specs`` against the JAX package's on
  ``AbstractMesh`` meshes 1x2, 2x2 and 2x4, batch 4 and 1, raw / q8 / q4;
  ``batch_spec`` and ``assert_replicated``.
* ``weights.shard_params`` / ``init_sharded_params``: a rank's shards of
  the seeded init are the blocks of the one-process init.
* ONE spawn of 4 gloo ranks (``_torch_tp.py`` through
  ``_torch_dist.spawn``) serves ``_torch_tp.RUNS`` at meshes 1x4, 2x2 and
  4x1 (gemma3-1b with the sequence over model, over data + model at batch
  1, and data-parallel only; mistral-nemo-12b with the heads over model;
  qwen2-72b's sharded biases; granite-20b's MQA; chameleon-34b's VLM ids),
  f32 smoke configs on the zoo tests' weights (the JAX init moved off its
  values, ``_torch_lm.zoo_models``). Each run against the one-process
  port and the JAX package's unsharded ``build_prefill_step`` /
  ``build_generate_fn`` on the same weights and prompts: greedy tokens
  equal; prefill logits atol / rtol 1e-4 (f32 matmuls split over ranks sum
  in other orders); teacher-forced decode logits (fed the one-process
  tokens) within ``FLIP_LOGITS`` of the largest, as the zoo tests allow for
  a K/V code that flips by one step; cache codes within one step (at most
  8 flips) and scales rtol 1e-4 against the block of the one-process and
  the JAX caches the rank's spec cuts; the ranks' bytes/token shares sum
  to the one-process figure; every row-parallel product and nothing else
  all-reduced. In the same spawn the launcher at ``--mesh 2x2`` against
  one process, the refusals, and a time pin. The other architectures and
  the continuous scheduler over ranks: ``test_torch_tp_zoo.py``.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import _torch_dist as td
import _torch_tp as tt
import jax
import jax.numpy as jnp
import numpy as np
from _torch_lm import jit_o0, zoo_models
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.launch import sharding as jsharding
from repro.models import model as jmodel
from repro.serving import engine as jengine
from repro.serving import kv_cache as jkv
from repro_torch.configs import get_config, list_archs
from repro_torch.core.codec import unpack_nibbles
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import sharding as tsharding
from repro_torch.launch.mesh import PRODUCTION_MESH, DataMesh
from repro_torch.models.model import init_params, stacked_flags
from repro_torch.models.multimodal import vq_tokens_stub
from repro_torch.serving import engine as tengine
from repro_torch.serving import kv_cache as tkv
from repro_torch.weights import (
    init_sharded_params,
    shard_params,
    to_jax_layout,
)

AXIS_SIZES = (1, 2, 4, 8, 16)
CACHE_MESHES = ((1, 2), (2, 2), (2, 4))
CACHE_BATCHES = (4, 1)
CACHE_BITS = (0, 8, 4)
LOGITS_TOL = 1e-4
FLIP_LOGITS = 2e-2
MAX_FLIPS = 8
RANKS_S = 150  # the ranks' work, their imports excluded


# ------------------------------------------------------------ spec parity


@functools.cache
def _jax_abstract(arch):
    cfg = jax_get_config(arch)
    key = jax.random.PRNGKey(0)
    return cfg, jax.eval_shape(lambda k: jmodel.init_params(cfg, k), key)


@functools.cache
def _port_train_tree(arch):
    cfg = get_config(arch)
    train = to_jax_layout(init_params(cfg, None, "meta"), cfg)
    return cfg, train


def _jax_flat(specs):
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P)
    )[0]
    return {jax.tree_util.keystr(kp): tuple(s) for kp, s in flat}


def _port_flat(specs):
    out = {}
    for path, s in tsharding.spec_tree_leaves(specs):
        if isinstance(s, tkv.QuantKV):
            out[path + ".codes"], out[path + ".scale"] = tuple(s.codes), tuple(s.scale)
        else:
            out[path] = tuple(s)
    return out


@pytest.mark.parametrize("size", AXIS_SIZES)
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_jax(arch, size):
    """Every leaf's spec, the training tree's keys and stacked flags."""
    jcfg, abstract = _jax_abstract(arch)
    want = jsharding.param_specs(
        abstract, jmodel.stacked_flags(abstract), axis_size=size, cfg=jcfg
    )
    cfg, train = _port_train_tree(arch)
    got = tsharding.param_specs(train, stacked_flags(train), axis_size=size, cfg=cfg)
    assert _port_flat(got) == _jax_flat(want)
    if size == 2:
        assert any(e == "model" for s in _port_flat(got).values() for e in s)


@pytest.mark.parametrize("arch", ["gemma3-1b", "mistral-nemo-12b", "jamba-v0.1-52b"])
def test_serving_specs_unstack_the_jax_specs(arch):
    """The serving tree's layer i takes the spec of the stacked leaf it
    unstacks from, without the leading None (``params_from_jax``'s order)."""
    jcfg, abstract = _jax_abstract(arch)
    want = jsharding.param_specs(
        abstract, jmodel.stacked_flags(abstract), axis_size=2, cfg=jcfg
    )
    cfg = get_config(arch)
    got = tsharding.serving_param_specs(cfg, 2)
    n_lead, n_pat = len(cfg.lead), len(cfg.pattern)
    assert len(got["layers"]) == len(cfg.layers)
    for i in range(len(cfg.layers)):
        if i < n_lead:
            src = want["lead"][i]
        elif i >= n_lead + n_pat * cfg.repeats:
            src = want["tail"][i - n_lead - n_pat * cfg.repeats]
        else:
            src = jax.tree.map(
                lambda s: P(*tuple(s)[1:]),
                want["scan"][(i - n_lead) % n_pat],
                is_leaf=lambda x: isinstance(x, P),
            )
        assert _port_flat(got["layers"][i]) == _jax_flat(src), i
    assert tuple(got["embed"]) == tuple(want["embed"])


@pytest.mark.parametrize("bits", CACHE_BITS)
@pytest.mark.parametrize("batch", CACHE_BATCHES)
@pytest.mark.parametrize("mesh", CACHE_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_cache_specs_equal_jax(mesh, batch, bits):
    """gemma3-1b's K/V (1 KV head: sequence-split), mistral-nemo-12b's (8:
    head-split at these axes) and mamba2-370m's conv / SSM leaves."""
    amesh = AbstractMesh(mesh, ("data", "model"))
    for arch in ("gemma3-1b", "mistral-nemo-12b", "mamba2-370m"):
        qj = jkv.CacheQuantConfig(bits=bits) if bits else None
        qt = tkv.CacheQuantConfig(bits=bits) if bits else None
        want = jengine.cache_specs(jax_get_config(arch), amesh, batch, qcfg=qj)
        got = tengine.cache_specs(get_config(arch), mesh, batch, qcfg=qt)
        assert _port_flat(got) == _jax_flat(want), arch


@pytest.mark.parametrize("axes", [("data",), ("pod", "data")])
@pytest.mark.parametrize("extra", [1, 2])
def test_batch_spec_equals_jax(axes, extra):
    assert tuple(tsharding.batch_spec(axes, extra)) == tuple(
        jsharding.batch_spec(axes, extra)
    )


def test_assert_replicated_as_jax():
    ok = {"a": P(None), "b": [P(None, None)]}
    jsharding.assert_replicated(ok, "counters")
    tsharding.assert_replicated(
        {"a": tsharding.Spec(None), "b": [tsharding.Spec(None, None)]}, "counters"
    )
    bad_j = {"a": P(None), "b": [P("model", None)]}
    bad_t = {"a": tsharding.Spec(None), "b": [tsharding.Spec("model", None)]}
    with pytest.raises(AssertionError) as ej:
        jsharding.assert_replicated(bad_j, "counters")
    with pytest.raises(AssertionError) as et:
        tsharding.assert_replicated(bad_t, "counters")
    assert "counters['b'][0]" in str(ej.value) and "counters['b'][0]" in str(et.value)


def _mesh(shape, d, m):
    return DataMesh(
        data=shape[0],
        model=shape[1],
        world=shape[0] * shape[1],
        rank=d * shape[1] + m,
        local=1,
        device=torch.device("cpu"),
        backend="gloo",
        data_index=d,
        model_index=m,
    )


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2-72b"])
def test_sharded_init_is_the_blocks_of_the_one_process_init(arch):
    """At 1x2 each rank's shards are the blocks of ``init_params``, and the
    blocks put back together are the whole leaf."""
    cfg = get_config(arch, smoke=True)
    whole = init_params(cfg, 1, "cpu")
    specs = tsharding.serving_param_specs(cfg, 2)
    parts = [
        init_sharded_params(cfg, 1, "cpu", specs, _mesh((1, 2), 0, m)) for m in (0, 1)
    ]
    cut = [shard_params(whole, specs, _mesh((1, 2), 0, m)) for m in (0, 1)]
    flat = [tsharding.spec_tree_leaves(t) for t in (whole, specs, *parts, *cut)]
    split = 0
    for (path, w), (_, s), (_, a), (_, b), (_, ca), (_, cb) in zip(*flat, strict=True):
        assert torch.equal(a, ca) and torch.equal(b, cb), path
        dims = [i for i, e in enumerate(s) if e is not None]
        if dims:
            split += 1
            assert torch.equal(torch.cat([a, b], dims[0]), w), path
        else:
            assert torch.equal(a, w) and torch.equal(b, w), path
    assert split >= 4 * len(cfg.layers) + 1  # wq, wo, gate/up/down..., embed


# ------------------------------------------------------ the 4-rank spawn


def _prompts(name, arch, batch):
    cfg = get_config(arch, smoke=True)
    seed = sorted(tt.RUNS).index(name)
    if cfg.arch_type == "vlm":
        gen = torch.Generator().manual_seed(seed)
        return vq_tokens_stub(gen, batch, tt.PROMPT, cfg)
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, tt.PROMPT)))


@functools.cache
def _jax_steps(arch, bits, batch):
    jcfg = jax_get_config(arch, smoke=True)
    qj = jkv.CacheQuantConfig(bits=bits) if bits else None
    pre = jengine.build_prefill_step(
        jcfg, tt.PROMPT + tt.GEN, cache_dtype=jnp.float32, qcfg=qj
    )
    return jit_o0(pre), jit_o0(jengine.build_generate_fn(jcfg), static_argnums=5)


def _jax_run(arch, bits, prompts):
    pj = zoo_models(arch)[2]
    pre, gen = _jax_steps(arch, bits, prompts.shape[0])
    logits, caches = pre(pj, jnp.asarray(prompts.numpy(), jnp.int32))
    first = jengine.greedy_sample(logits)
    caches, _, _, sampled = gen(
        pj, caches, first, jnp.int32(tt.PROMPT), jax.random.PRNGKey(0), tt.GEN - 1
    )
    leaves = jax.tree.leaves(caches, is_leaf=lambda x: isinstance(x, jkv.QuantKV))
    host = [
        (np.array(x.codes), np.array(x.scale))
        if isinstance(x, jkv.QuantKV)
        else (np.array(x), None)
        for x in leaves
    ]
    tokens = np.concatenate([np.asarray(first), np.asarray(sampled)], axis=1)
    return dict(logits=np.asarray(logits), tokens=tokens, caches=host)


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """The one-process references, the spawn, then the JAX references while
    the ranks run."""
    tmp = tmp_path_factory.mktemp("tp")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        weights = {arch: zoo_models(arch)[2] for arch in tt.ARCHS}
        prompts, one = {}, {}
        for name, (arch, _, bits, batch) in tt.RUNS.items():
            prompts[name] = _prompts(name, arch, batch)
            cfg = get_config(arch, smoke=True)
            params = zoo_models(arch)[3]
            one[name] = tt.serve(cfg, params, prompts[name], bits)
            teacher = one[name]["tokens"][:, 1 : 1 + tt.TEACHER]
            one[name]["teacher"] = teacher
            one[name]["teacher_logits"] = tt.teacher_forced(
                cfg, params, prompts[name], bits, teacher
            )
        inputs = dict(
            weights=weights,
            prompts=prompts,
            teacher={k: v["teacher"] for k, v in one.items()},
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
        jax_ref = {
            name: _jax_run(arch, bits, prompts[name])
            for name, (arch, _, bits, _) in tt.RUNS.items()
        }
        launch, printed = td.quiet_call(launch_serve.main, tt.LAUNCH_ARGS)
        ranks = join()
    finally:
        torch.set_num_threads(n)
    return ranks, dict(one=one, jax=jax_ref, launch=launch, launch_printed=printed)


RUN_IDS = list(tt.RUNS)


def _codes_close(got, want, label):
    """Codes within one step (the count of flips returned)."""
    diff = (got.int() - want.int()).abs()
    assert int(diff.max()) <= 1, label
    return int((diff > 0).sum())


def _block(x, spec, res):
    return tsharding.cut(x, spec, res["sizes"], res["coords"])


def _cache_leaves_close(res, want_caches, bits, label):
    """A rank's cache shard against the block its spec cuts from a whole
    cache (``[(codes or raw, scale or None)]`` in leaf order)."""
    specs = [s for _, s in tkv.tree_leaves(res["cache_specs"])]
    flips = 0
    for (path, codes, scale), spec, (w_codes, w_scale) in zip(
        res["caches"], specs, want_caches, strict=True
    ):
        w_codes = _block(torch.as_tensor(np.asarray(w_codes)), spec, res)
        assert codes.shape == w_codes.shape, (label, path)
        if scale is None:
            np.testing.assert_allclose(
                codes.numpy(), w_codes.numpy(), rtol=1e-4, atol=1e-5, err_msg=label
            )
            continue
        a, b = codes, w_codes
        if bits <= 4:
            a, b = (unpack_nibbles(c, 2 * c.shape[-1]) for c in (a, b))
        flips += _codes_close(a, b, (label, path))
        w_scale = _block(torch.as_tensor(np.asarray(w_scale)), spec, res)
        np.testing.assert_allclose(
            scale.numpy(), w_scale.numpy(), rtol=1e-4, atol=1e-6, err_msg=label
        )
    assert flips <= MAX_FLIPS, f"{label}: {flips} code flips"


@pytest.mark.parametrize("name", RUN_IDS)
def test_tokens_equal_one_process_and_jax(tp_run, name):
    ranks, ref = tp_run
    for res in ranks:
        got, rows = res[name]["tokens"].numpy(), slice(*res[name]["rows"])
        np.testing.assert_array_equal(got, ref["one"][name]["tokens"][rows].numpy())
        np.testing.assert_array_equal(got, ref["jax"][name]["tokens"][rows])


@pytest.mark.parametrize("name", RUN_IDS)
def test_prefill_logits_close_to_one_process_and_jax(tp_run, name):
    ranks, ref = tp_run
    for res in ranks:
        got, rows = res[name]["logits"].numpy(), slice(*res[name]["rows"])
        one = ref["one"][name]["logits"][rows].numpy()
        for want in (one, ref["jax"][name]["logits"][rows]):
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=LOGITS_TOL, rtol=LOGITS_TOL)


@pytest.mark.parametrize("name", RUN_IDS)
def test_teacher_forced_decode_logits_close_to_one_process(tp_run, name):
    ranks, ref = tp_run
    for res in ranks:
        got, rows = res[name]["teacher_logits"], slice(*res[name]["rows"])
        want = ref["one"][name]["teacher_logits"][rows].numpy()
        atol = FLIP_LOGITS * float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=LOGITS_TOL)
        np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))


@pytest.mark.parametrize("name", RUN_IDS)
def test_cache_shards_are_the_blocks_of_one_process_and_jax(tp_run, name):
    ranks, ref = tp_run
    bits = tt.RUNS[name][2]
    one = [(c, s) for _, c, s in ref["one"][name]["caches"]]
    for res in ranks:
        _cache_leaves_close(res[name], one, bits, f"{name} vs one process")
        jax_caches = ref["jax"][name]["caches"]
        _cache_leaves_close(res[name], jax_caches, bits, f"{name} vs JAX")


@pytest.mark.parametrize("name", RUN_IDS)
def test_bytes_per_token_shares_sum_to_one_process(tp_run, name):
    ranks, ref = tp_run
    for key in ("bytes", "bytes_accounted"):
        total = sum(res[name][key] for res in ranks)
        assert total == pytest.approx(ref["one"][name][key], rel=1e-12), key
    assert ref["one"][name]["bytes"] == ref["one"][name]["bytes_accounted"]


@pytest.mark.parametrize("name", RUN_IDS)
def test_the_row_parallel_products_and_nothing_else_reduce(tp_run, name):
    """Over a model axis of M > 1 every layer's ``wo`` and ``down`` end in
    one all-reduce a forward (both prefills and every decode step), the
    vocab-parallel embedding in one, the head in one gather; the sequence
    split adds one query gather (where ``wq`` splits) and one gather of
    the partials a layer a decode step. At M = 1 nothing is collective."""
    arch, (_, model), _, _ = tt.RUNS[name]
    cfg = get_config(arch, smoke=True)
    forwards = 2 + (tt.GEN - 1) + tt.TEACHER
    decodes = (tt.GEN - 1) + tt.TEACHER
    for res in tp_run[0]:
        calls, seq = res[name]["model_calls"], res[name]["seq_calls"] or {}
        if model == 1:
            assert calls == {} and seq == {}
            continue
        n = len(cfg.layers)
        assert calls["tp.attn.wo"] == calls["tp.mlp.down"] == n * forwards
        assert calls["tp.embed"] == calls["tp.head"] == forwards
        if res[name]["seq_shards"] > 1:
            # over the model group, or every rank where the batch is whole
            merged = calls if res[name]["seq_calls"] is None else seq
            assert merged["tp.attn.decode"] == n * decodes
            assert calls["tp.attn.q"] == n * decodes
        else:
            assert "tp.attn.decode" not in calls and "tp.attn.q" not in calls
            assert seq == {}


def test_launcher_over_ranks_equals_one_process(tp_run):
    ranks, ref = tp_run
    for res in ranks:
        rows = res["launch"]["rows"]
        assert torch.equal(res["launch"]["tokens"], ref["launch"]["tokens"][rows])
    total = sum(res["launch"]["bytes"] for res in ranks)
    assert total == pytest.approx(ref["launch"]["bytes_per_token"], rel=1e-12)


def test_launcher_prints_on_rank_zero_only(tp_run):
    ranks, _ = tp_run
    printed = ranks[0]["launch"]["printed"]
    assert "# mesh: {'data': 2, 'model': 2} over 4 ranks (gloo)" in printed
    assert "# decode: eager (graph=False)" in printed
    assert "collectives:" in printed and "sample token ids:" in printed
    assert all(res["launch"]["printed"] == "" for res in ranks[1:])


REFUSALS = {
    "mesh_1x2": ("ValueError", "takes data x model ranks"),
    "mesh_3x2": ("ValueError", "takes data x model ranks"),
    # training takes a model axis with every compressor; the production
    # mesh takes its 256 ranks, not these 4
    "train": ("ValueError", PRODUCTION_MESH + " (32x8) takes 256 ranks, not 4"),
    "graph_under_gloo": ("ValueError", "gloo"),
}


@pytest.mark.parametrize("what", list(REFUSALS))
def test_refusals_over_ranks(tp_run, what):
    kind, text = REFUSALS[what]
    for res in tp_run[0]:
        got = res["refusals"][what]
        assert got is not None and got.startswith(kind) and text in got, got


def test_tp_file_stays_within_its_time(tp_run):
    for res in tp_run[0]:
        assert res["seconds"] < RANKS_S, res["seconds"]


def test_jax_is_not_imported_by_the_tp_rank_helper():
    src = open(tt.__file__).read()
    assert "import jax" not in src and "from repro." not in src


@pytest.mark.parametrize(
    "arch, mesh, batch, seq_shards, copies, local",
    [
        ("gemma3-1b", (1, 2), 4, 2, 1, (4, 1, 528, 256)),
        ("gemma3-1b", (2, 2), 4, 2, 1, (2, 1, 528, 256)),
        ("gemma3-1b", (2, 2), 1, 4, 1, (1, 1, 264, 256)),
        ("mistral-nemo-12b", (1, 2), 4, 1, 1, (4, 4, 1056, 128)),
        ("mistral-nemo-12b", (2, 2), 1, 1, 2, (1, 4, 1056, 128)),
    ],
)
def test_serve_shard_layout_at_full_width(arch, mesh, batch, seq_shards, copies, local):
    """At the full configs (lead / tail layers beside the stacked scan
    leaves): the K/V layout, the sequence shards, how many ranks hold each
    cache shard, and a rank's zero caches (on the meta device)."""
    cfg = get_config(arch)
    m = _mesh(mesh, mesh[0] - 1, mesh[1] - 1)
    p_specs, c_specs, t_spec = tengine.serve_shardings(cfg, m, batch)
    shard = tengine.ServeShard(m, batch, p_specs, c_specs, t_spec, axis=None)
    assert shard.seq_shards() == seq_shards and shard.copies() == copies
    caches = shard.zero_caches(cfg, 1056, torch.bfloat16, "meta")
    shapes = {tuple(x.shape[-4:]) for path, x in tkv.tree_leaves(caches)}
    assert shapes == {local}
    rows = shard.rows()
    assert rows.stop - rows.start == (batch // mesh[0] if batch >= mesh[0] else batch)


@pytest.mark.parametrize(
    "n_heads, n_kv, first, count",
    [(4, 1, 2, 2), (32, 8, 4, 2), (32, 8, 8, 8), (12, 3, 3, 3), (4, 2, 0, 4)],
    ids=["gemma-m2", "mistral-m16", "mistral-m4", "uneven", "whole"],
)
def test_local_query_heads_read_their_global_kv_heads(n_heads, n_kv, first, count):
    """Local query head i (global head first + i) must read global KV head
    (first + i) // (H / Hkv) under the grouping the kernel applies to what
    ``_kv_of_heads`` returns: i // (count / heads returned)."""
    from repro_torch.models.attention import _kv_of_heads

    k = torch.arange(n_kv, dtype=torch.float32).reshape(1, n_kv, 1, 1)
    kq, vq = _kv_of_heads(k, k + 100, n_heads, first, count)
    group = count // kq.shape[1]
    got = [int(kq[0, i // group]) for i in range(count)]
    assert got == [(first + i) // (n_heads // n_kv) for i in range(count)]
    assert torch.equal(vq, kq + 100)


def test_decode_append_lands_on_the_shard_that_owns_the_position():
    from repro_torch.models.attention import _owned_index

    assert [_owned_index(9, s, 8) for s in (0, 1, 2)] == [None, 1, None]
    idx = torch.tensor([3, 8, 15, 16])
    assert _owned_index(idx, 1, 8).tolist() == [8, 0, 7, 8]  # 8: dropped


def test_spec_normalizes_and_pickles_as_jax_partition_specs():
    import pickle

    s = tsharding.Spec(("data",), None, ("data", "model"))
    assert tuple(s) == tuple(P(("data",), None, ("data", "model")))
    assert pickle.loads(pickle.dumps(s)) == s and isinstance(s, tsharding.Spec)
    sizes, coords = {"data": 2, "model": 4}, {"data": 1, "model": 3}
    assert tsharding.shard_count(("data", "model"), sizes) == 8
    assert tsharding.shard_index(("data", "model"), sizes, coords) == 7
    x = torch.arange(16).reshape(8, 2)
    assert tsharding.cut(x, tsharding.Spec("model", None), sizes, coords).tolist() == [
        [12, 13],
        [14, 15],
    ]


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_init_serving_caches_over_a_shard_are_its_blocks(bits):
    """A rank's zero serving caches (2x2, gemma3-1b smoke: the sequence over
    model) are the blocks of the one-process ones its cache spec cuts,
    codes and scales alike."""
    cfg = get_config("gemma3-1b", smoke=True)
    qcfg = tkv.CacheQuantConfig(bits=bits) if bits else None
    whole = tengine.init_serving_caches(cfg, 4, 32, torch.float32, qcfg, "cpu")
    m = _mesh((2, 2), 1, 1)
    p_specs, c_specs, t_spec = tengine.serve_shardings(cfg, m, 4)
    shard = tengine.ServeShard(m, 4, p_specs, c_specs, t_spec, axis=None)
    got = tengine.init_serving_caches(cfg, 4, 32, torch.float32, qcfg, "cpu", shard)
    specs = [s for _, s in tkv.tree_leaves(c_specs)]
    pairs = zip(tkv.tree_leaves(got), tkv.tree_leaves(whole), specs, strict=True)
    for (path, g), (_, w), spec in pairs:
        parts = [(g.codes, w.codes), (g.scale, w.scale)] if bits else [(g, w)]
        for a, b in parts:
            assert torch.equal(a, tsharding.cut(b, spec, m.sizes, m.coords)), path
        assert (g.codes if bits else g).shape[-2] == 16  # half of 32 positions
