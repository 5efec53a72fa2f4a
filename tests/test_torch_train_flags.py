"""The training entry point runs its steps in f32, as the reference does.

``train_one`` (which ``python -m repro_torch.launch.train_resnet`` calls)
turns TF32 off for cuDNN's convolutions and cuBLAS's matmuls while its
steps run, and puts both flags back as the caller had them, also when a
step raises. The flags are plain Python state, so the CPU shows it: a
step's ``on_step`` hook reads them. (What TF32 would do to the gradients
shows on the card only: ``tests/test_torch_cuda.py``.)
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.compressors import CompressorConfig
from repro_torch.launch import train_resnet
from repro_torch.train.data_parallel import train_one

cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul


@pytest.fixture
def set_flags():
    """Set both TF32 flags for a test, and restore them after it."""
    was = cudnn.allow_tf32, matmul.allow_tf32

    def set_to(conv, mm):
        cudnn.allow_tf32, matmul.allow_tf32 = conv, mm

    yield set_to
    cudnn.allow_tf32, matmul.allow_tf32 = was


def _flags():
    return cudnn.allow_tf32, matmul.allow_tf32


def _train(on_step, model="cnn", steps=2):
    return train_one(
        CompressorConfig(name="lq_sgd", rank=1, bits=8),
        model=model,
        n_workers=2,
        batch=2,
        hw=8,
        steps=steps,
        device="cpu",
        on_step=on_step,
    )


@pytest.mark.parametrize("before", [(True, True), (True, False), (False, True)])
def test_train_one_steps_with_tf32_off_and_restores_the_flags(set_flags, before):
    set_flags(*before)
    seen = []
    _train(lambda step, res: seen.append(_flags()))
    assert seen == [(False, False)] * 2
    assert _flags() == before


@pytest.mark.parametrize("before", [(True, True), (False, False)])
def test_train_one_restores_the_flags_when_a_step_raises(set_flags, before):
    set_flags(*before)

    def fail(step, res):
        assert _flags() == (False, False)
        raise KeyError("stop")

    with pytest.raises(KeyError, match="stop"):
        _train(fail)
    assert _flags() == before


def test_train_resnet_launcher_steps_with_tf32_off(set_flags, monkeypatch):
    """The launcher's own steps (ResNet-18, through its per-step printout)
    run with both flags off after the caller turned them on."""
    set_flags(True, True)
    seen = []
    real_print = print

    def spy(*args, **kwargs):
        seen.append(_flags())
        real_print(*args, **kwargs)

    monkeypatch.setattr("builtins.print", spy)
    argv = ["--device", "cpu", "--hw", "8", "--batch", "2", "--workers", "2"]
    train_resnet.main(argv + ["--steps", "1"])
    # one line a step from inside train_one, then the summary after it
    assert seen == [(False, False), (True, True)]
    assert _flags() == (True, True)
