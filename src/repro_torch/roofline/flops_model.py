"""The analytic per-device FLOP model: the port's copy of the JAX package's
``roofline/flops_model.py``, the same arithmetic over the port's configs.

The JAX dry run replaces XLA's scanned ``cost_analysis`` FLOPs (a while
body counted once) with this model. The port counts its FLOPs from the ops
it runs (``roofline/fake_trace.py``) and keeps this model beside the count
(``launch/dryrun.py``): matmul-exact, aware of which tensors the sharding
rules split (head-misaligned attention is replicated over the model axis
and charged in full).

Conventions: forward matmul = 2·M·N·K; train = forward x (1 forward + 2
backward + 1 remat recompute) = 4x forward with full remat; causal
attention charges S/2 average context; a sliding window charges
min(S/2, W). ``attn_ctx="dense"`` charges instead the context the plain
attention computes: its masked products span every one of the S keys (a
decode step's, the whole cache), window or not.
"""

from __future__ import annotations

from repro_torch.configs.base import InputShape, LayerSpec, ModelConfig

__all__ = ["per_device_flops", "analytic_flops_report"]


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def _attn_layer_flops(
    cfg: ModelConfig, spec: LayerSpec, s_ctx: float, tokens: float, msize: int
) -> float:
    """Forward FLOPs for one attention layer over ``tokens`` tokens with
    average attended context ``s_ctx`` (per device, sharding-aware)."""
    d = cfg.d_model
    if cfg.use_mla:
        h = cfg.n_heads
        rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
        nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        qk = nope + rope
        shard = msize if _div(h, msize) else 1
        proj = (
            2 * d * rq
            + 2 * rq * h * qk / shard  # q path
            + 2 * d * (rkv + rope)  # kv down (replicated)
            + 2 * rkv * h * (nope + vd) / shard  # kv up
            + 2 * h * vd * d / shard  # o
        )
        # v is zero-padded to the qk dim inside the shared attention op
        attn = 2 * s_ctx * h * qk * 2 / shard
        return tokens * (proj + attn)
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q_shard = msize if _div(h, msize) else 1
    kv_shard = msize if _div(hkv, msize) and _div(h, msize) else 1
    proj = (
        2 * d * h * hd / q_shard
        + 2 * 2 * d * hkv * hd / kv_shard
        + 2 * h * hd * d / q_shard
    )
    attn = 2 * s_ctx * h * hd * 2 / q_shard  # QK^T + PV, by Q heads
    return tokens * (proj + attn)


def _mamba_layer_flops(cfg: ModelConfig, tokens: float, msize: int) -> float:
    """The Mamba-2 layer is replicated over ``model`` in the FLOP model."""
    d = cfg.d_model
    di = cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    p = cfg.ssm_head_dim
    q = cfg.ssm_chunk
    proj = 2 * d * (2 * di + 2 * g * n + h) + 2 * di * d
    conv = 2 * cfg.ssm_conv * (di + 2 * g * n)
    ssd = 2 * h * (q * n + q * p + 2 * p * n)
    return tokens * (proj + conv + ssd)


def _ffn_flops(cfg: ModelConfig, spec: LayerSpec, tokens: float, msize: int) -> float:
    d = cfg.d_model
    if spec.moe:
        fe, k, e = cfg.d_ff_expert, cfg.experts_per_token, cfg.n_experts
        shard = msize if (_div(e, msize) or _div(fe, msize)) else 1
        flops = 6 * d * fe * k * cfg.capacity_factor / shard
        flops += 2 * d * e  # router (replicated)
        if cfg.n_shared_experts:
            shard_s = msize if _div(fe * cfg.n_shared_experts, msize) else 1
            flops += 6 * d * fe * cfg.n_shared_experts / shard_s
        return tokens * flops
    if cfg.d_ff <= 0:
        return 0.0
    shard = msize if _div(cfg.d_ff, msize) else 1
    return tokens * 6 * d * cfg.d_ff / shard


def per_device_flops(
    cfg: ModelConfig,
    shape: InputShape,
    *,
    ndp: int,
    msize: int,
    remat: bool = True,
    attn_ctx: str = "causal",
) -> float:
    """Per-device FLOPs of one step. ``attn_ctx``: ``"causal"`` is the JAX
    package's model, ``"dense"`` charges every attention layer the S keys
    its plain products span (see the module doc)."""
    if attn_ctx not in ("causal", "dense"):
        raise ValueError(f"attn_ctx {attn_ctx!r}: 'causal' or 'dense'")
    dense = attn_ctx == "dense"
    if shape.mode == "decode":
        tokens_dev = shape.global_batch / (ndp if shape.global_batch >= ndp else 1)
        s_ctx = float(shape.seq_len)
        factor = 1.0
    else:
        tokens_dev = shape.global_batch * shape.seq_len / ndp
        s_ctx = float(shape.seq_len) if dense else shape.seq_len / 2.0
        if shape.mode == "train":
            factor = 4.0 if remat else 3.0
        else:
            factor = 1.0

    total = 0.0
    for spec in cfg.layers:
        ctx = s_ctx
        if spec.kind == "attn" and spec.window is not None and not dense:
            ctx = min(s_ctx, float(spec.window))
        if spec.kind == "attn":
            total += _attn_layer_flops(cfg, spec, ctx, tokens_dev, msize)
        else:
            total += _mamba_layer_flops(cfg, tokens_dev, msize)
        total += _ffn_flops(cfg, spec, tokens_dev, msize)
    # LM head (vocab-parallel)
    v_shard = msize if _div(cfg.vocab_size, msize) else 1
    head = 2 * cfg.d_model * cfg.vocab_size / v_shard
    if cfg.n_codebooks:
        head *= cfg.n_codebooks
    total += tokens_dev * head
    # MTP auxiliary head: one extra layer + proj + head over the same tokens
    if cfg.mtp and shape.mode == "train":
        total += _attn_layer_flops(cfg, LayerSpec("attn"), s_ctx, tokens_dev, msize)
        total += _ffn_flops(cfg, LayerSpec("attn"), tokens_dev, msize)
        total += tokens_dev * (2 * 2 * cfg.d_model * cfg.d_model + head)
    # the compressor's power iteration (~3 matmul passes at rank r) is not
    # charged, as in the JAX model
    return total * factor


def analytic_flops_report(
    cfg: ModelConfig, shape: InputShape, *, ndp: int, msize: int, remat: bool = True
) -> dict:
    f = per_device_flops(cfg, shape, ndp=ndp, msize=msize, remat=remat)
    return {
        "analytic_flops_per_device": f,
        "analytic_flops_global": f * ndp * msize,
    }
