"""Stand-ins for every model input of a dry-run shape: the port's
counterpart of the JAX package's ``launch/inputs.py``.

:func:`input_specs` gives tensors of the JAX package's shapes and dtypes
on the ``meta`` device by default (no allocation; inside a
``FakeTensorMode`` on any device): tokens (B, S), or (B, S, cb) with
codebooks, and a conditioning prefix ``cond`` (B, L, d) for a model that
has one, for train and prefill; one new token (B, 1[, cb]) and the cache
position ``index`` for decode. Tokens are int32, as in the JAX package:
the port's embedding lookup and its synthetic data (``data/synthetic.py:
lm_batch``) take int32 ids as they are. ``index`` is the JAX step's 0-dim
int32 position; the port's decode step takes it broadcast to the rows as
the (B,) int64 positions its graphed decode reads (``launch/dryrun.py``
does so). Stub frontends appear as the token or embedding tensors they
produce. :func:`make_concrete_batch` gives the same structure with values.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.common import DTYPES

__all__ = ["input_specs", "make_concrete_batch"]


def input_specs(
    cfg: ModelConfig, shape: InputShape, device: torch.device | str = "meta"
) -> dict[str, torch.Tensor]:
    """Uninitialised tensors of every input of ``shape``'s step (on
    ``meta``: shapes and dtypes only)."""
    b = shape.global_batch
    i32 = torch.int32
    if shape.mode in ("train", "prefill"):
        s = shape.seq_len
        tok_shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks else (b, s)
        specs = {"tokens": torch.empty(tok_shape, dtype=i32, device=device)}
        if cfg.cond_len:
            specs["cond"] = torch.empty(
                (b, cfg.cond_len, cfg.d_model),
                dtype=DTYPES[cfg.dtype],
                device=device,
            )
        return specs
    # decode: ONE new token against a seq_len-deep cache
    tok_shape = (b, 1, cfg.n_codebooks) if cfg.n_codebooks else (b, 1)
    return {
        "tokens": torch.empty(tok_shape, dtype=i32, device=device),
        "index": torch.empty((), dtype=i32, device=device),
    }


def make_concrete_batch(
    cfg: ModelConfig,
    shape: InputShape,
    generator: torch.Generator | None = None,
    device: torch.device | str = "cpu",
) -> dict[str, torch.Tensor]:
    """The structure of :func:`input_specs` with values (tests, examples):
    tokens uniform in the vocabulary from ``generator`` (seed 0 by
    default), ``index`` 0, the rest zeros."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    out = {}
    for k, spec in input_specs(cfg, shape).items():
        if k == "tokens":
            t = torch.randint(
                0, cfg.vocab_size, spec.shape, generator=gen, dtype=spec.dtype
            )
        else:
            t = torch.zeros(spec.shape, dtype=spec.dtype)
        out[k] = t.to(device)
    return out
