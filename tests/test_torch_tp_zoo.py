"""Tensor-parallel serving of the rest of the zoo and of the continuous
scheduler on the CPU, against the JAX package.

* ONE spawn of 4 gloo ranks (``_torch_tp_zoo.py`` through
  ``_torch_dist.spawn``) serves ``_torch_tp_zoo.RUNS`` at meshes 2x2 and
  1x4: mixtral-8x7b's experts split 2 and 1 a rank (its one table over
  both data rows at 2x2, its K/V sequence over model at 1x4), jamba's
  Mamba-2 heads and conv channels beside MoE and attention,
  deepseek-v3-671b's MLA latent rows over model and, at batch 1, over data
  + model, with its shared expert split, mamba2-370m's state, and
  musicgen-medium's codebooks and conditioning prefix: f32 smoke configs on
  the zoo tests' weights (``_torch_lm.zoo_models``). Each run against the
  one-process port and the JAX package's unsharded ``build_prefill_step``
  / ``build_decode_step`` on the same weights, prompts and prefix: greedy
  tokens equal; prefill logits atol / rtol 1e-4 (f32 products split over
  ranks sum in other orders); teacher-forced decode logits (fed the
  one-process tokens) within ``FLIP_LOGITS`` of the largest, as the zoo
  tests allow for a cache code that flips by one step; cache codes within
  one step (at most 8 flips), scales and raw leaves (the SSM state and
  conv window) rtol 1e-4 against the block of the one-process and the
  JAX caches the rank's spec cuts; the ranks' bytes/token shares sum to
  the one-process figure; the collectives each split makes, a forward or
  a decode step, and no others.
* In the same spawn the continuous scheduler at 2x2 (gemma3-1b, mixtral,
  deepseek: requests through 4 slots) against the JAX
  ``ContinuousScheduler`` and the port's one process; the launcher at
  ``--mesh 2x2``, both schedulers, against one process; the scheduler's
  refusals of Mamba-2, codebooks and ``cond`` over ranks, the JAX
  package's; a time pin.
* ``serve_shard`` at the full configs on the meta device: the experts,
  SSM heads, conv channels and latent positions a rank holds.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import _torch_dist as td
import _torch_tp_zoo as tz
import jax
import jax.numpy as jnp
import numpy as np
from _torch_lm import jit_o0, zoo_models
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
from repro_torch.launch.mesh import DataMesh
from repro_torch.models.multimodal import codec_tokens_stub, conditioning_stub
from repro_torch.serving import engine as tengine
from repro_torch.serving import kv_cache as tkv

LOGITS_TOL = 1e-4
FLIP_LOGITS = 2e-2
MAX_FLIPS = 8  # a rank's cache codes that may move by one step
RANKS_S = 120  # the ranks' work, their imports excluded


def _inputs(name, arch, batch):
    """(prompts, cond) of a run: seeded ids, a codebook grid and the
    conditioning prefix for musicgen."""
    cfg = get_config(arch, smoke=True)
    seed = sorted(tz.RUNS).index(name)
    if cfg.n_codebooks:
        gen = torch.Generator().manual_seed(seed)
        tokens = codec_tokens_stub(gen, batch, tz.PROMPT, cfg)
        return tokens, conditioning_stub(gen, batch, cfg)
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, tz.PROMPT))), None


@functools.cache
def _jax_steps(arch, bits):
    jcfg = jax_get_config(arch, smoke=True)
    qj = jkv.CacheQuantConfig(bits=bits) if bits else None
    max_seq = tz.PROMPT + tz.GEN + jcfg.cond_len
    pre = jengine.build_prefill_step(
        jcfg, max_seq, cache_dtype=jnp.float32, qcfg=qj
    )
    return jit_o0(pre), jit_o0(jengine.build_decode_step(jcfg))


def _jax_host(caches):
    leaves = jax.tree.leaves(caches, is_leaf=lambda x: isinstance(x, jkv.QuantKV))
    return [
        (np.array(x.codes), np.array(x.scale))
        if isinstance(x, jkv.QuantKV)
        else (np.array(x), None)
        for x in leaves
    ]


def _jax_run(arch, bits, prompts, cond):
    """The JAX package's unsharded prefill and GEN - 1 greedy decode steps
    (the JAX launcher's host loop, which also serves codebooks)."""
    jcfg, _, pj, _ = zoo_models(arch)
    pre, dec = _jax_steps(arch, bits)
    args = (jnp.asarray(cond.numpy()),) if cond is not None else ()
    logits, caches = pre(pj, jnp.asarray(prompts.numpy(), jnp.int32), *args)
    out = [jengine.greedy_sample(logits)]
    start = tz.PROMPT + jcfg.cond_len
    for i in range(tz.GEN - 1):
        step, caches = dec(pj, caches, out[-1], jnp.int32(start + i))
        out.append(jengine.greedy_sample(step))
    tokens = np.concatenate([np.asarray(t) for t in out], axis=1)
    return dict(logits=np.asarray(logits), tokens=tokens, caches=_jax_host(caches))


def _cont_prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 512, size=n) for n in tz.CONT_LENS]


def _jax_continuous(arch, bits, prompts):
    from repro.serving.scheduler import ContinuousScheduler as JaxScheduler
    from repro.serving.scheduler import Request as JaxRequest

    jcfg, _, pj, _ = zoo_models(arch)
    qj = jkv.CacheQuantConfig(bits=bits) if bits else None
    sched = JaxScheduler(
        jcfg,
        pj,
        slots=tz.CONT_SLOTS,
        max_seq=tz.CONT_MAX_SEQ,
        cache_dtype=jnp.float32,
        qcfg=qj,
        decode_chunk=tz.CONT_CHUNK,
    )
    reqs = [
        JaxRequest(uid=i, prompt=p.astype(np.int32), max_new=tz.GEN)
        for i, p in enumerate(prompts)
    ]
    return dict(tokens=sched.run(reqs), steps=sched.steps, free=sched.pool.n_free)


def _jax_refusal(arch):
    from repro.serving.scheduler import ContinuousScheduler as JaxScheduler

    jcfg, _, pj, _ = zoo_models(arch)
    with pytest.raises(ValueError) as e:
        JaxScheduler(jcfg, pj, slots=4, max_seq=32)
    return str(e.value)


@pytest.fixture(scope="module")
def zoo_run(tmp_path_factory):
    """The one-process references, the spawn, then the JAX references while
    the ranks run."""
    tmp = tmp_path_factory.mktemp("tp_zoo")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        weights = {arch: zoo_models(arch)[2] for arch in tz.ARCHS}
        prompts, conds, one = {}, {}, {}
        for name, (arch, _, bits, batch) in tz.RUNS.items():
            prompts[name], conds[name] = _inputs(name, arch, batch)
            cfg, params = get_config(arch, smoke=True), zoo_models(arch)[3]
            one[name] = tz.serve(cfg, params, prompts[name], bits, conds[name])
            teacher = one[name]["tokens"][:, 1 : 1 + tz.TEACHER]
            one[name]["teacher"] = teacher
            one[name]["teacher_logits"] = tz.teacher_forced(
                cfg, params, prompts[name], bits, teacher, conds[name]
            )
        cont_prompts = _cont_prompts()
        cont = {
            name: tz.continuous(
                get_config(arch, smoke=True), zoo_models(arch)[3], cont_prompts, bits
            )
            for name, (arch, bits) in tz.CONT.items()
        }
        inputs = dict(
            weights=weights,
            prompts=prompts,
            cond=conds,
            teacher={k: v["teacher"] for k, v in one.items()},
            cont_prompts=cont_prompts,
        )
        inputs_path = str(tmp / "inputs.pt")
        torch.save(inputs, inputs_path)
        join = td.spawn(
            inputs_path,
            str(tmp),
            world=tz.WORLD,
            target=tz.run_rank,
            extra=(inputs_path,),
        )
        jax_ref = {
            name: _jax_run(arch, bits, prompts[name], conds[name])
            for name, (arch, _, bits, _) in tz.RUNS.items()
        }
        jax_cont = {
            name: _jax_continuous(arch, bits, cont_prompts)
            for name, (arch, bits) in tz.CONT.items()
        }
        jax_refused = {arch: _jax_refusal(arch) for arch in tz.CONT_REFUSED}
        launch, _ = td.quiet_call(launch_serve.main, tz.LAUNCH_ARGS)
        launch_cont, _ = td.quiet_call(launch_serve.main, tz.LAUNCH_CONT_ARGS)
        ranks = join()
    finally:
        torch.set_num_threads(n)
    return ranks, dict(
        one=one,
        jax=jax_ref,
        cont=cont,
        jax_cont=jax_cont,
        jax_refused=jax_refused,
        launch=launch,
        launch_cont=launch_cont,
    )


RUN_IDS = list(tz.RUNS)


def _block(x, spec, res):
    return tsharding.cut(x, spec, res["sizes"], res["coords"])


def _cache_pairs(res, want_caches):
    """(path, got, the block of want its spec cuts, is codes) of a rank's
    cache shard against a whole cache (``[(codes or raw, scale or None)]``
    in leaf order)."""
    specs = [s for _, s in tkv.tree_leaves(res["cache_specs"])]
    out = []
    for (path, codes, scale), spec, (w_codes, w_scale) in zip(
        res["caches"], specs, want_caches, strict=True
    ):
        w_codes = _block(torch.as_tensor(np.asarray(w_codes)), spec, res)
        assert codes.shape == w_codes.shape, path
        out.append((path, codes, w_codes, scale is not None))
        if scale is not None:
            w_scale = _block(torch.as_tensor(np.asarray(w_scale)), spec, res)
            out.append((path + ("scale",), scale, w_scale, False))
    return out


def _caches_close(ranks, name, want_caches, bits, label):
    """Every rank's cache shard against the blocks of a whole cache: codes
    within one step, at most MAX_FLIPS a rank moved;
    scales and raw leaves rtol 1e-4 and within 1e-5 of their largest value
    where no code moved, within FLIP_LOGITS of it where one did (a moved
    code moves the later decode steps' inputs, which the later rows,
    scales, SSM states and conv windows carry, as the logits do)."""
    pairs = [_cache_pairs(res[name], want_caches) for res in ranks]
    flips = 0
    for path, got, want, codes in (p for rank in pairs for p in rank):
        if codes:
            a, b = got, want
            if bits <= 4:
                a, b = (unpack_nibbles(c, 2 * c.shape[-1]) for c in (a, b))
            diff = (a.int() - b.int()).abs()
            assert int(diff.max()) <= 1, (label, path)
            flips += int((diff > 0).sum())
    assert flips <= MAX_FLIPS * len(ranks), f"{label}: {flips} code flips"
    share = FLIP_LOGITS if flips else 1e-5
    for path, got, want, codes in (p for rank in pairs for p in rank):
        if not codes:
            w = want.numpy()
            atol = share * max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(
                got.numpy(), w, rtol=1e-4, atol=atol, err_msg=f"{label} {path}"
            )


@pytest.mark.parametrize("name", RUN_IDS)
def test_tokens_equal_one_process_and_jax(zoo_run, name):
    ranks, ref = zoo_run
    for res in ranks:
        got, rows = res[name]["tokens"].numpy(), slice(*res[name]["rows"])
        np.testing.assert_array_equal(got, ref["one"][name]["tokens"][rows].numpy())
        np.testing.assert_array_equal(got, ref["jax"][name]["tokens"][rows])


@pytest.mark.parametrize("name", RUN_IDS)
def test_prefill_logits_close_to_one_process_and_jax(zoo_run, name):
    ranks, ref = zoo_run
    for res in ranks:
        got, rows = res[name]["logits"].numpy(), slice(*res[name]["rows"])
        one = ref["one"][name]["logits"][rows].numpy()
        for want in (one, ref["jax"][name]["logits"][rows][:, -1:]):
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=LOGITS_TOL, rtol=LOGITS_TOL)


@pytest.mark.parametrize("name", RUN_IDS)
def test_teacher_forced_decode_logits_close_to_one_process(zoo_run, name):
    ranks, ref = zoo_run
    for res in ranks:
        got, rows = res[name]["teacher_logits"], slice(*res[name]["rows"])
        want = ref["one"][name]["teacher_logits"][rows].numpy()
        atol = FLIP_LOGITS * float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=LOGITS_TOL)
        np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))


@pytest.mark.parametrize("name", RUN_IDS)
def test_cache_shards_are_the_blocks_of_one_process_and_jax(zoo_run, name):
    """K/V, latent rows, SSM states and conv windows alike."""
    ranks, ref = zoo_run
    bits = tz.RUNS[name][2]
    one = [(c, s) for _, c, s in ref["one"][name]["caches"]]
    _caches_close(ranks, name, one, bits, f"{name} vs one process")
    _caches_close(ranks, name, ref["jax"][name]["caches"], bits, f"{name} vs JAX")


@pytest.mark.parametrize("name", RUN_IDS)
def test_bytes_per_token_shares_sum_to_one_process(zoo_run, name):
    ranks, ref = zoo_run
    for key in ("bytes", "bytes_accounted"):
        total = sum(res[name][key] for res in ranks)
        assert total == pytest.approx(ref["one"][name][key], rel=1e-12), key


def _counts(cfg):
    """The layers of each kind: (attention, MLA, Mamba-2, MoE FFN, dense
    FFN)."""
    kinds = [s.kind for s in cfg.layers]
    mla = kinds.count("attn") if cfg.use_mla else 0
    moe = sum(s.moe for s in cfg.layers)
    dense = sum(not s.moe for s in cfg.layers) if cfg.d_ff else 0
    return kinds.count("attn") - mla, mla, kinds.count("mamba"), moe, dense


@pytest.mark.parametrize("name", RUN_IDS)
def test_each_split_makes_its_collectives_and_no_others(zoo_run, name):
    """A forward (both prefills and every decode step) over a model axis:
    an MoE layer's one all-reduce of its routed and shared partials
    (``tp.moe.out``) and, where the rows split over data, one gather of
    the routing over the data axis (``tp.moe.route``); a Mamba-2 layer's
    gather of its heads' outputs (``tp.ssm.y``) and, a decode step, of the
    conv window (``tp.ssm.conv``); an MLA layer's gathers of the
    down-projections' columns and ``wo``'s all-reduce, and, a decode
    step, the absorbed queries' gather and the merge of the sequence
    shards' partials; the vocab-parallel embedding and head."""
    arch, (data, model), _, batch = tz.RUNS[name]
    cfg = get_config(arch, smoke=True)
    n_attn, n_mla, n_mamba, n_moe, n_dense = _counts(cfg)
    forwards = 2 + (tz.GEN - 1) + tz.TEACHER
    decodes = (tz.GEN - 1) + tz.TEACHER
    for res in zoo_run[0]:
        calls, r = res[name]["model_calls"], res[name]
        seq = calls if r["seq_calls"] is None else r["seq_calls"]
        want = {"tp.embed": forwards, "tp.head": forwards}
        if n_dense:
            want["tp.mlp.down"] = n_dense * forwards
        if n_attn:
            want["tp.attn.wo"] = n_attn * forwards
            if r["seq_shards"] > 1:
                want["tp.attn.q"] = n_attn * decodes
        if n_mla:
            for tag in ("tp.mla.wo", "tp.mla.q_a", "tp.mla.kv_a"):
                want[tag] = n_mla * forwards
            want["tp.mla.q"] = n_mla * decodes
        if n_mamba:
            want["tp.ssm.y"] = n_mamba * forwards
            want["tp.ssm.conv"] = n_mamba * decodes
        if n_moe:
            want["tp.moe.out"] = n_moe * forwards
        got = {k: v for k, v in calls.items() if not k.startswith("tp.attn.decode")}
        got = {k: v for k, v in got.items() if k != "tp.mla.decode"}
        assert got == want, name
        if n_mla:
            assert seq["tp.mla.decode"] == n_mla * decodes
        if n_attn and r["seq_shards"] > 1:
            assert seq["tp.attn.decode"] == n_attn * decodes
        rows_split = data > 1 and batch >= data
        want_data = {"tp.moe.route": n_moe * forwards} if rows_split and n_moe else {}
        assert r["data_calls"] == want_data, name


@pytest.mark.parametrize(
    "name, experts, wq_b_cols",
    [
        ("mixtral_2x2_q8", 2, None),
        ("mixtral_1x4_q8", 1, None),
        ("jamba_1x4_q4", 1, None),
        ("deepseek_2x2_q8", 2, 2 * 48),
        ("deepseek_1x4_q8", 1, 48),
    ],
)
def test_a_rank_holds_its_experts_and_heads(zoo_run, name, experts, wq_b_cols):
    for res in zoo_run[0]:
        layout = res[name]["layout"]
        assert layout["experts"] == experts
        assert layout.get("wq_b_cols") == wq_b_cols


CONT_IDS = list(tz.CONT)


@pytest.mark.parametrize("name", CONT_IDS)
def test_continuous_scheduler_over_ranks_equals_one_process_and_jax(zoo_run, name):
    """Every request's greedy tokens on every rank (gathered from the data
    row that made them), the chunks run and the pages left."""
    ranks, ref = zoo_run
    one, want = ref["cont"][name], ref["jax_cont"][name]
    assert one["tokens"] == want["tokens"]
    assert (one["steps"], one["free"]) == (want["steps"], want["free"])
    for res in ranks:
        got = res[name]
        assert got["tokens"] == want["tokens"]
        assert (got["steps"], got["free"]) == (want["steps"], want["free"])


@pytest.mark.parametrize("name", CONT_IDS)
def test_continuous_bytes_shares_sum_and_the_grid_splits_over_data(zoo_run, name):
    ranks, ref = zoo_run
    total = sum(res[name]["bytes"] for res in ranks)
    assert total == pytest.approx(ref["cont"][name]["bytes"], rel=1e-12)
    half = tz.CONT_SLOTS // 2
    for res in ranks:
        d = res["rank"] // 2
        assert res[name]["rows"] == slice(d * half, (d + 1) * half)
    moe = name == "mixtral_cont" or name == "deepseek_cont"
    assert bool(ranks[0][name]["data_calls"]) == moe


def test_launcher_over_ranks_equals_one_process(zoo_run):
    ranks, ref = zoo_run
    for res in ranks:
        rows = res["launch"]["rows"]
        assert torch.equal(res["launch"]["tokens"], ref["launch"]["tokens"][rows])
    total = sum(res["launch"]["bytes"] for res in ranks)
    assert total == pytest.approx(ref["launch"]["bytes_per_token"], rel=1e-12)
    assert "# mesh: {'data': 2, 'model': 2}" in ranks[0]["launch"]["printed"]


def test_continuous_launcher_over_ranks_equals_one_process(zoo_run):
    ranks, ref = zoo_run
    for res in ranks:
        assert res["launch_cont"]["tokens"] == ref["launch_cont"]["tokens"]
    total = sum(res["launch_cont"]["bytes"] for res in ranks)
    assert total == pytest.approx(ref["launch_cont"]["bytes_per_token"], rel=1e-12)
    printed = ranks[0]["launch_cont"]["printed"]
    assert "continuous: 6 requests x 5 tokens through 4 slots" in printed
    assert "(this rank's share)" in printed and "collectives:" in printed
    assert all(res["launch_cont"]["printed"] == "" for res in ranks[1:])


@pytest.mark.parametrize("arch", tz.CONT_REFUSED)
def test_continuous_scheduler_over_ranks_refuses_as_jax(zoo_run, arch):
    """Mamba-2 stacks, codebooks and the conditioning prefix: the JAX
    package's ValueError, on every rank."""
    ranks, ref = zoo_run
    for res in ranks:
        assert res["cont_refusals"][arch] == f"ValueError: {ref['jax_refused'][arch]}"


def test_tp_zoo_file_stays_within_its_time(zoo_run):
    for res in zoo_run[0]:
        assert res["seconds"] < RANKS_S, res["seconds"]


def test_jax_is_not_imported_by_the_tp_zoo_rank_helper():
    src = open(tz.__file__).read()
    assert "import jax" not in src and "from repro." not in src


# ------------------------------------------------- layouts at full width


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


def _full_shard(arch, mesh, batch):
    cfg = get_config(arch)
    m = _mesh(mesh, mesh[0] - 1, mesh[1] - 1)
    p_specs, c_specs, t_spec = tengine.serve_shardings(cfg, m, batch)
    return cfg, tengine.ServeShard(m, batch, p_specs, c_specs, t_spec, axis=None)


@pytest.mark.parametrize(
    "arch, mesh, batch, seq_shards, leaves",
    [
        # 4 of 8 experts; the attention layer's K/V over 4 of 8 KV heads,
        # the SSM state over 64 of 128 heads, the conv window over 4112 of
        # 8224 channels
        (
            "jamba-v0.1-52b",
            (1, 2),
            4,
            1,
            {"k": (4, 4, 1056, 128), "ssm": (4, 64, 64, 16), "conv": (4, 3, 4112)},
        ),
        # 16 of 32 heads and 1152 of 2304 channels, 2 rows a data rank
        ("mamba2-370m", (2, 2), 4, 1, {"ssm": (2, 16, 64, 128), "conv": (2, 3, 1152)}),
        # the latent rows over model (528 of 1056 positions), over data +
        # model at batch 1 (264)
        ("deepseek-v3-671b", (1, 2), 4, 2, {"ckv": (4, 528, 512), "krope": (4, 528, 64)}),
        ("deepseek-v3-671b", (2, 2), 1, 4, {"ckv": (1, 264, 512), "krope": (1, 264, 64)}),
        # 12 of 24 KV heads
        ("musicgen-medium", (1, 2), 4, 1, {"k": (4, 12, 1056, 64)}),
        ("mixtral-8x7b", (1, 2), 4, 1, {"k": (4, 4, 1056, 128)}),
    ],
)
def test_serve_shard_layout_at_full_width(arch, mesh, batch, seq_shards, leaves):
    """A rank's zero caches at the full configs (on the meta device): each
    leaf kind's shape, the sequence shards."""
    cfg, shard = _full_shard(arch, mesh, batch)
    assert shard.seq_shards() == seq_shards
    caches = shard.zero_caches(cfg, 1056, torch.bfloat16, "meta")
    got = {}
    for path, x in tkv.tree_leaves(caches):
        shape = tuple(x.shape[1:] if path[0] == "scan" else x.shape)
        assert got.setdefault(path[-1], shape) == shape, path
    assert {k: got[k] for k in leaves} == leaves
    if "ssm" in got:  # the SSM state in f32, whatever the cache dtype
        ssm = [x for p, x in tkv.tree_leaves(caches) if p[-1] == "ssm"]
        assert {x.dtype for x in ssm} == {torch.float32}


@pytest.mark.parametrize(
    "arch, experts",
    [
        ("mixtral-8x7b", 4),
        ("jamba-v0.1-52b", 8),
        ("deepseek-v3-671b", 128),
    ],
)
def test_expert_stacks_split_at_full_width(arch, experts):
    """At a model axis of 2 a rank holds E / 2 experts of every MoE layer
    (the JAX rule), and 64 of deepseek's 128 heads' columns."""
    cfg = get_config(arch)
    specs = tsharding.serving_param_specs(cfg, 2)
    m = _mesh((1, 2), 0, 1)
    from repro_torch.models.model import init_params

    abstract = init_params(cfg, None, "meta")
    for p, s in zip(abstract["layers"], specs["layers"], strict=True):
        if "w_gate" in p.get("ffn", {}):
            for k in ("w_gate", "w_up", "w_down"):
                blk = tsharding.cut(p["ffn"][k], s["ffn"][k], m.sizes, m.coords)
                assert blk.shape[0] == experts, k
        if "wq_b" in p["mixer"]:
            blk = tsharding.cut(
                p["mixer"]["wq_b"], s["mixer"]["wq_b"], m.sizes, m.coords
            )
            assert blk.shape[1] == 64 * (cfg.qk_nope_dim + cfg.qk_rope_dim)


@pytest.mark.parametrize("arch", list_archs())
def test_every_architecture_takes_a_serving_shard(arch):
    """No architecture is refused a (data, model) mesh for serving: a
    rank's shard of the full config at 2x2 builds, and its caches cut."""
    cfg, shard = _full_shard(arch, (2, 2), 4)
    caches = shard.zero_caches(cfg, 1056, torch.bfloat16, "meta")
    assert len(list(tkv.tree_leaves(caches))) >= 1


def test_jax_rules_split_mla_wkv_a_by_its_kv_rule():
    """A fault of the JAX package's rules, pinned: ``wkv_a`` (MLA's fused
    latent down-projection) meets ``"wk" in path`` before its own rule
    (replicate), and the K/V rule's head test passes with no KV heads (0
    divides the axis), so the JAX package splits its columns; the port
    keeps the JAX specs and gathers the columns before the norm
    (``models/mla.py:_latents``)."""
    jcfg = jax_get_config("deepseek-v3-671b")
    abstract = jax.eval_shape(
        lambda k: jmodel.init_params(jcfg, k), jax.random.PRNGKey(0)
    )
    specs = jsharding.param_specs(
        abstract, jmodel.stacked_flags(abstract), axis_size=2, cfg=jcfg
    )
    assert tuple(specs["lead"][0]["mixer"]["wkv_a"]) == tuple(P(None, "model"))
    got = tsharding.serving_param_specs(get_config("deepseek-v3-671b"), 2)
    assert tuple(got["layers"][0]["mixer"]["wkv_a"]) == (None, "model")
