"""The port stands alone and never hides the device.

* No module of ``src/repro_torch`` nor ``chip_smoke.py`` imports JAX or the
  JAX package (an AST scan), and importing every module of the port leaves
  ``jax`` out of ``sys.modules`` (a fresh interpreter).
* A CUDA tensor handed to a kernel wrapper is never computed by the plain
  version: without CUDA the wrapper raises. Only ``reference_mode`` routes
  it to the plain version, explicitly.
* Asking for the card where there is none raises; so does a kernel build
  without ``nvcc``; ``chip_smoke.py`` exits non-zero and prints no result.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, ops
from repro_torch.kernels import ref as tref

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
_ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_or_the_jax_package(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], env=_ENV, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, to drive the
    dispatch of a CPU-only build down the kernel path."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


def _fake(t):
    return t.as_subclass(_FakeCuda)


@pytest.fixture
def plain_forbidden(monkeypatch):
    """Every plain version raises if called."""

    def boom(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    for name in tref.__all__:
        monkeypatch.setattr(tref, name, boom)


@pytest.mark.parametrize(
    "call",
    [
        lambda: ops.log_quantize(_fake(torch.randn(64)), 1.0, bits=8),
        lambda: ops.log_quantize_pack(_fake(torch.randn(64)), 1.0, bits=4),
        lambda: ops.log_dequantize_rows(
            _fake(torch.zeros(4, 16, dtype=torch.int8)), _fake(torch.ones(4, 1)), bits=8
        ),
        lambda: ops.flash_attention(*[_fake(torch.randn(1, 2, 8, 32))] * 3),
        lambda: ops.log_dequantize(_fake(torch.randn(4608, 1)), bits=8),
        lambda: ops.pack_nibbles(_fake(torch.zeros(64, dtype=torch.int8))),
        lambda: ops.ssd_chunk(
            _fake(torch.randn(1, 2, 1, 16, 8)),
            _fake(torch.zeros(1, 2, 1, 16)),
            *[_fake(torch.randn(1, 1, 1, 16, 4))] * 2,
        ),
    ],
    ids=[
        "log_quantize",
        "log_quantize_pack",
        "log_dequantize_rows",
        "flash_attention",
        "log_dequantize",
        "pack_nibbles",
        "ssd_chunk",
    ],
)
def test_cuda_tensor_never_takes_the_plain_version(plain_forbidden, call):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_reference_mode_routes_cuda_tensors_to_plain_explicitly(monkeypatch):
    seen = []
    monkeypatch.setattr(tref, "log_quantize_ref", lambda *a: seen.append(a) or "plain")
    x = torch.randn(64)
    with ops.reference_mode():
        assert ops.log_quantize(_fake(x), 1.0, bits=8) == "plain"
    assert len(seen) == 1
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ops.log_quantize(_fake(x), 1.0, bits=8)  # the mode ended with the block


def test_other_devices_have_no_path():
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.log_quantize(torch.empty(8, device="meta"), 1.0)


def test_asking_for_the_card_without_cuda_raises():
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import init_params

    cfg = get_config("gemma3-1b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg, 0)  # device defaults to "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "gemma3-1b", "--smoke"])


def test_row_dequant_module_imports_without_nvcc_or_jax(tmp_path):
    """The CUDA row dequant's wrapper module imports, and ops with it, where
    there is no nvcc: nothing is built before the first CUDA launch."""
    code = (
        "import sys\n"
        "from repro_torch.kernels import build, ops\n"
        "from repro_torch.kernels import log_dequant_rows as m\n"
        "assert ops.KERNELS['log_dequantize_rows'] is m.log_dequantize_rows_cuda\n"
        "assert m.log_dequantize_rows_cuda.launches == 0 and not build._loaded\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(_ENV, CUDA_HOME=str(tmp_path), PATH=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-c", code],
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_row_dequant_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels.log_dequant_rows import log_dequantize_rows_cuda

    codes, scales = torch.zeros(4, 16, dtype=torch.int8), torch.ones(4, 1)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        log_dequantize_rows_cuda(codes, scales, bits=8)
    assert log_dequantize_rows_cuda.launches == 0


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all(["flash_attention"])


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "script_alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
