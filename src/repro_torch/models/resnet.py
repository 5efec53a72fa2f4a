"""ResNet-18 (He et al., CVPR 2016), the paper's experimental model.

CIFAR variant (3x3 stem, no maxpool), the JAX package's
``repro/models/resnet.py`` op for op:

* parameters keep the JAX names and layouts: a tree ``{"stem": {"conv",
  "bn"}, "stage0".."stage3": [block, block], "fc": {"w", "b"}}`` with conv
  kernels in HWIO (kh, kw, cin, cout), so a compressor matricizes them to
  (kh*kw*cin, cout) exactly as the reference does (an OIHW weight would swap
  the roles of P and Q);
* images are NHWC at the entry, as in JAX; inside, activations are NCHW for
  ``conv2d``;
* "SAME" padding as XLA computes it: a stride-2 3x3 conv over an even size
  pads 0 before and 1 after (``padding=1`` would pad 1/1 and shift every
  window), a stride-2 1x1 projection pads nothing;
* BatchNorm from the batch's own statistics (biased variance,
  ``rsqrt(var + 1e-5)``, no running state), as in a training step.

:class:`ResNet18` holds the tree as ``nn.Parameter`` s whose module names
are the JAX path (``stage0.0.bn1.bias``); :func:`resnet18_forward` is the
forward over any such tree, which is what per-worker gradients use.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.tree import Tree, tree_leaves
from repro_torch.models.common import resolve_device

__all__ = [
    "ResNet18",
    "init_resnet18",
    "resnet18_forward",
    "resnet18_param_count",
    "conv_same",
    "module_from_tree",
    "tree_from_module",
]

_STAGES = ((64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2))


def init_resnet18(
    n_classes: int = 10, in_ch: int = 3, *, seed: int = 0, device="cuda"
) -> dict[str, Any]:
    """A seeded init in the JAX package's distribution (He-normal convs,
    unit BN, fc ~ N(0, 1/512)), from the port's own generator."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def conv(kh, kw, cin, cout):
        w = torch.randn((kh, kw, cin, cout), generator=gen, device=dev)
        return w * math.sqrt(2.0 / (kh * kw * cin))

    def bn(c):
        return {"scale": torch.ones(c, device=dev), "bias": torch.zeros(c, device=dev)}

    p: dict[str, Any] = {"stem": {"conv": conv(3, 3, in_ch, 64), "bn": bn(64)}}
    cin = 64
    for si, (cout, blocks, stride) in enumerate(_STAGES):
        stage = []
        for bi in range(blocks):
            s = stride if bi == 0 else 1
            blk = {
                "conv1": conv(3, 3, cin, cout),
                "bn1": bn(cout),
                "conv2": conv(3, 3, cout, cout),
                "bn2": bn(cout),
            }
            if s != 1 or cin != cout:
                blk["proj"] = conv(1, 1, cin, cout)
                blk["bn_proj"] = bn(cout)
            stage.append(blk)
            cin = cout
        p[f"stage{si}"] = stage
    w = torch.randn((512, n_classes), generator=gen, device=dev) / math.sqrt(512.0)
    p["fc"] = {"w": w, "b": torch.zeros(n_classes, device=dev)}
    return p


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME": out = ceil(size / stride), the total pad split with the
    odd one after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, w_hwio: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NCHW activations, an HWIO kernel, "SAME" padding as JAX computes it."""
    kh, kw = w_hwio.shape[:2]
    top, bottom = _same_pads(x.shape[2], kh, stride)
    left, right = _same_pads(x.shape[3], kw, stride)
    w = w_hwio.permute(3, 2, 0, 1)  # OIHW view for conv2d; the grad stays HWIO
    if top == bottom and left == right:
        return F.conv2d(x, w, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


def _bn(x: torch.Tensor, p: dict[str, torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(0, 2, 3), keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * p["scale"].reshape(1, -1, 1, 1) + p["bias"].reshape(1, -1, 1, 1)


def _block(x: torch.Tensor, blk: dict[str, Any], stride: int) -> torch.Tensor:
    h = F.relu(_bn(conv_same(x, blk["conv1"], stride), blk["bn1"]))
    h = _bn(conv_same(h, blk["conv2"]), blk["bn2"])
    if "proj" in blk:
        x = _bn(conv_same(x, blk["proj"], stride), blk["bn_proj"])
    return F.relu(x + h)


def resnet18_forward(p: Tree, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) -> logits (B, n_classes)."""
    h = x.permute(0, 3, 1, 2)
    h = F.relu(_bn(conv_same(h, p["stem"]["conv"]), p["stem"]["bn"]))
    for si, (_, blocks, stride) in enumerate(_STAGES):
        for bi in range(blocks):
            h = _block(h, p[f"stage{si}"][bi], stride if bi == 0 else 1)
    h = h.mean(dim=(2, 3))
    return h @ p["fc"]["w"] + p["fc"]["b"]


def resnet18_param_count(p: Tree) -> int:
    return sum(int(t.numel()) for t in tree_leaves(p))


def module_from_tree(tree: Tree) -> nn.Module:
    """Nested dicts/lists of tensors -> modules whose parameter names are the
    tree's keys (dict -> ``nn.Module``, list -> ``nn.ModuleList``)."""
    if isinstance(tree, (list, tuple)):
        return nn.ModuleList([module_from_tree(v) for v in tree])
    m = nn.Module()
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            m.register_parameter(k, nn.Parameter(v))
        else:
            m.add_module(k, module_from_tree(v))
    return m


def tree_from_module(m: nn.Module) -> Tree:
    """The inverse of :func:`module_from_tree`, holding the Parameters."""
    if isinstance(m, nn.ModuleList):
        return [tree_from_module(c) for c in m]
    out: dict[str, Any] = dict(m.named_parameters(recurse=False))
    for k, c in m.named_children():
        out[k] = tree_from_module(c)
    return out


class ResNet18(nn.Module):
    """ResNet-18 whose parameters carry the JAX names and HWIO layout."""

    def __init__(self, params: Tree):
        super().__init__()
        for k, v in params.items():
            self.add_module(k, module_from_tree(v))

    def tree(self) -> Tree:
        """The parameters as the JAX-layout tree (the same Parameter objects)."""
        return {k: tree_from_module(c) for k, c in self.named_children()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return resnet18_forward(self.tree(), x)
