"""Serving launcher: quantized KV cache, fixed batch or continuous batching.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch gemma3-1b --batch 4 --prompt-len 1024 --gen 32 --cache-bits 8

``--scheduler fixed`` runs a batched prefill and then a decode loop (all
requests the same length); ``continuous`` runs the paged admit/decode/retire
loop (per-request lengths, slot reuse). ``--cache-bits 4|8`` stores the KV
cache as log-quant codes + per-row scales; 0 keeps the raw
``--cache-dtype``. Runs on the card unless ``--device cpu`` is given;
weights come from a seeded init. :func:`run_fixed` and
:func:`run_continuous` are the two paths as functions, for callers that
bring their own weights and prompts.
"""

from __future__ import annotations

import argparse
import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import DTYPES, resolve_device
from repro_torch.models.model import init_params
from repro_torch.serving.engine import (
    build_generate_fn,
    build_prefill_step,
    greedy_sample,
)
from repro_torch.serving.kv_cache import (
    CacheQuantConfig,
    cache_bytes_per_token,
    cache_bytes_per_token_accounting,
    tree_is_quantized,
)
from repro_torch.serving.scheduler import ContinuousScheduler, Request

__all__ = ["run_fixed", "run_continuous", "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_fixed(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    *,
    gen: int,
    qcfg: CacheQuantConfig | None = None,
    cache_dtype: torch.dtype = torch.bfloat16,
    temperature: float = 0.0,
) -> dict[str, Any]:
    """Batched prefill of ``tokens`` (B, L), then ``gen - 1`` decode steps.

    Returns the prefill's last-position logits, the caches, the ``gen``
    tokens of each row, bytes/token (measured and accounted) and the host
    seconds of prefill and of decode, each ending in a device sync."""
    device = tokens.device
    b, prompt_len = tokens.shape
    max_seq = prompt_len + gen
    prefill = build_prefill_step(cfg, max_seq, cache_dtype=cache_dtype, qcfg=qcfg)
    generate = build_generate_fn(cfg, temperature=temperature)
    t0 = time.perf_counter()
    logits, caches = prefill(params, tokens)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    first = greedy_sample(logits)
    sample_gen = torch.Generator(device=device).manual_seed(2)
    t0 = time.perf_counter()
    caches, _, _, sampled = generate(
        params, caches, first, prompt_len, sample_gen, gen - 1
    )
    toks = torch.cat([first, sampled], dim=1)
    _sync(device)
    t_decode = time.perf_counter() - t0
    return {
        "logits": logits,
        "caches": caches,
        "tokens": toks,
        "bytes_per_token": cache_bytes_per_token(caches, b, max_seq),
        "bytes_per_token_accounted": cache_bytes_per_token_accounting(
            caches, b, max_seq
        ),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
    }


def run_continuous(
    cfg: ModelConfig,
    params: dict,
    prompts: list[np.ndarray],
    *,
    gen: int,
    slots: int,
    qcfg: CacheQuantConfig | None = None,
    cache_dtype: torch.dtype = torch.bfloat16,
    temperature: float = 0.0,
) -> dict[str, Any]:
    """Every prompt as a request of ``gen`` new tokens through ``slots``
    decode slots of the continuous scheduler, on the device of ``params``.
    Returns each request's tokens, the scheduler, bytes/token (measured and
    accounted) and host seconds."""
    device = params["embed"].device
    max_seq = max(len(p) for p in prompts) + gen
    sched = ContinuousScheduler(
        cfg,
        params,
        slots=slots,
        max_seq=max_seq,
        cache_dtype=cache_dtype,
        qcfg=qcfg,
        temperature=temperature,
        device=device,
    )
    reqs = [Request(uid=i, prompt=p, max_new=gen) for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    done = sched.run(reqs)
    _sync(device)
    return {
        "tokens": done,
        "scheduler": sched,
        "bytes_per_token": cache_bytes_per_token(sched.caches, slots, max_seq),
        "bytes_per_token_accounted": cache_bytes_per_token_accounting(
            sched.caches, slots, max_seq
        ),
        "seconds": time.perf_counter() - t0,
    }


def main(argv: list[str] | None = None) -> dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument(
        "--batch",
        type=int,
        default=4,
        help="decode slots (fixed: batch; continuous: grid size)",
    )
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument(
        "--requests",
        type=int,
        default=None,
        help="continuous only: total requests (default 2x batch)",
    )
    ap.add_argument("--cache-dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument(
        "--cache-bits",
        type=int,
        default=0,
        choices=(0, 4, 8),
        help="log-quant the KV cache (0 = raw --cache-dtype)",
    )
    ap.add_argument("--scheduler", default="fixed", choices=("fixed", "continuous"))
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    cache_dtype = DTYPES[args.cache_dtype]
    qcfg = CacheQuantConfig(bits=args.cache_bits) if args.cache_bits else None
    params = init_params(cfg, 1, device)

    if args.scheduler == "continuous":
        n_req = args.requests or 2 * args.batch
        rng = np.random.default_rng(0)
        prompts = [
            rng.integers(0, cfg.vocab_size, size=args.prompt_len) for _ in range(n_req)
        ]
        out = run_continuous(
            cfg,
            params,
            prompts,
            gen=args.gen,
            slots=args.batch,
            qcfg=qcfg,
            cache_dtype=cache_dtype,
            temperature=args.temperature,
        )
        dt = out["seconds"]
        total = sum(len(v) for v in out["tokens"].values())
        print(
            f"continuous: {n_req} requests x {args.gen} tokens through "
            f"{args.batch} slots in {dt:.2f}s ({total / max(dt, 1e-9):.1f} tok/s, "
            f"{out['scheduler'].steps} chunks) on {device}"
        )
        print(
            f"cache: quantized={tree_is_quantized(out['scheduler'].caches)} "
            f"{out['bytes_per_token']:.1f} bytes/token"
        )
        print("sample token ids:", out["tokens"][0][:16])
        return out

    tok_gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len), generator=tok_gen
    ).to(device)
    out = run_fixed(
        cfg,
        params,
        tokens,
        gen=args.gen,
        qcfg=qcfg,
        cache_dtype=cache_dtype,
        temperature=args.temperature,
    )
    print(
        f"prefill {tuple(tokens.shape)} in {out['prefill_s']:.3f}s (cache quantized="
        f"{tree_is_quantized(out['caches'])}, {out['bytes_per_token']:.1f} "
        f"bytes/token) on {device}"
    )
    dt = out["decode_s"]
    print(
        f"decoded {args.gen} tokens/seq x {args.batch} seqs in {dt:.3f}s "
        f"({args.gen * args.batch / max(dt, 1e-9):.1f} tok/s)"
    )
    print("sample token ids:", out["tokens"][0, :16].tolist())
    return out


if __name__ == "__main__":
    main()
