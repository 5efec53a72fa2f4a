"""PyTorch/CUDA port of the serving path, for one NVIDIA H100.

The package mirrors ``src/repro`` module for module. Plain tensor code is
PyTorch; each Pallas TPU kernel on the path is a kernel written by hand for
Hopper (Triton under ``kernels/log_quant.py``, CUDA C++ under ``csrc/``).
Entry points run on ``torch.device("cuda")`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper takes its plain version.
"""

__all__: list[str] = []
