"""How far mamba2-370m's prefill logits move against reference mode when the
SSD chunk term changes in its last bits, on one GPU.

    python tools/mamba_logit_sensitivity.py [source.cu]

Builds mamba2-370m at full width and depth (seeded bf16 weights, as
``chip_smoke.py`` does) and runs the (g1) prefill, 4 x 1024 tokens, in
reference mode. Then, each against that reference, it runs the prefill
with the intra-chunk term taken from (1) the ``ssd_chunk`` kernel, or the
kernel compiled from ``source.cu`` (a version of ``csrc/ssd_chunk.cu`` with
its C interface, such as ``tools/ssd_chunk_3xtf32.cu``), recording each
layer's kernel-vs-plain error on the model's own inputs; and (2) the plain
version times (1 + eps * noise) for eps 1e-7, 1e-6 and 1e-5 (seeded normal
noise). Prints the logits' max |diff| / max |logit| for each, the bound
``chip_smoke.py`` holds the kernel path to (LOGITS_REL_TOL), and one JSON
line.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (puts src/ on the path; the run's constants)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.ssd_chunk import head_slab  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serving.engine import build_prefill_step  # noqa: E402
from ssd_chunk_variants import build_sources, run  # noqa: E402  (this directory)

EPS = (1e-7, 1e-6, 1e-5)


def _compiled(source):
    """``ssd_chunk(x, a_cum, bm, cm)`` from ``source``, built into
    ``build/variants/``, at the slab the port's wrapper would pick."""
    name = Path(source).stem
    fn = build_sources({name: Path(source).read_text()})[name]
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def ssd_chunk(x, a_cum, bm, cm):
        b, h, nc, q, _ = x.shape
        slab = head_slab(b, h, bm.shape[1], nc, q, sms)
        return run(fn, x, a_cum, bm, cm, slab)

    return ssd_chunk


def _plain(x, a_cum, bm, cm):
    rep = x.shape[1] // bm.shape[1]
    return ref.ssd_chunk_ref(
        x, a_cum, bm.repeat_interleave(rep, 1), cm.repeat_interleave(rep, 1)
    )


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("mamba_logit_sensitivity: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    source = argv[0] if argv else None
    kernel = _compiled(source) if source else ops.ssd_chunk
    cfg = get_config(chip_smoke.SSM_ARCH)
    params = init_params(cfg, 1, "cuda")
    batch, prompt = chip_smoke.SSM_RUNS["g1"]
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, prompt)))
    prefill = build_prefill_step(cfg, prompt + chip_smoke.SSM_GEN)
    tokens = tokens.cuda()
    with ops.reference_mode():
        want, _ = prefill(params, tokens)
    top = float(want.float().abs().max())

    def rel(got):
        return float((got.float() - want.float()).abs().max()) / top

    layer_err = []

    def checked(x, a_cum, bm, cm):
        got = kernel(x, a_cum, bm, cm)
        plain = _plain(x, a_cum, bm, cm)
        layer_err.append(float((got - plain).abs().max() / plain.abs().max()))
        return got

    result = {
        "card": torch.cuda.get_device_name(0),
        "kernel": source or "src/repro_torch/csrc/ssd_chunk.cu",
        "bound": chip_smoke.LOGITS_REL_TOL,
    }
    original = ssm.ops.ssd_chunk
    try:
        ssm.ops.ssd_chunk = checked
        result["kernel_logits_rel"] = rel(prefill(params, tokens)[0])
        result["kernel_layer_rel_err_max"] = max(layer_err)
        for eps in EPS:
            gen = torch.Generator(device="cuda").manual_seed(7)

            def perturbed(x, a_cum, bm, cm, eps=eps, gen=gen):
                y = _plain(x, a_cum, bm, cm)
                noise = torch.randn(y.shape, generator=gen, device=y.device)
                return y * (1 + eps * noise)

            ssm.ops.ssd_chunk = perturbed
            with ops.reference_mode():
                result[f"plain_perturbed_{eps:g}_logits_rel"] = rel(
                    prefill(params, tokens)[0]
                )
    finally:
        ssm.ops.ssd_chunk = original
    for key, value in result.items():
        print(f"  {key}: {value}")
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
