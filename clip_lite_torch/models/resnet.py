"""ResNet image towers with torchvision-v1.5 semantics.

The counterpart of the JAX package's ``models/resnet.py``: 7x7/s2 stem,
3x3/s2 max-pool with pad 1, four stages of BasicBlock (18/34) or
Bottleneck (50/101/152) with the stride on the 3x3 conv, symmetric
k//2 padding, kaiming-normal fan-out conv init, BN ones/zeros, and an
fp32 global average pool.  The JAX tower computes its stem in an exact
space-to-depth form; here it is the plain conv.  Module names follow the
JAX parameter tree (``stem``, ``layer1_0``, ``block1``, ``shortcut``) so
the weight bridge maps paths one to one.

Input is NHWC, as in the JAX package; it is permuted once to NCHW, which
leaves it in PyTorch's channels_last memory layout.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from clip_lite_torch.ops.layers import BatchNorm


class Conv2d(nn.Conv2d):
    """Bias-free conv with symmetric k//2 padding, computing in
    ``compute_dtype`` with fp32 weights."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding=kernel_size // 2, bias=False)
        self.compute_dtype = compute_dtype

    def init_weights(self, generator: torch.Generator) -> None:
        # kaiming_normal(mode=fan_out, relu): std = sqrt(2 / fan_out).
        fan_out = self.out_channels * self.kernel_size[0] * self.kernel_size[1]
        nn.init.normal_(self.weight.data, 0.0, (2.0 / fan_out) ** 0.5,
                        generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), None)


class ConvBN(nn.Module):
    """Conv(bias=False) + BatchNorm, the repeated ResNet cell."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel_size, stride,
                           compute_dtype)
        self.bn = BatchNorm(out_channels, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity/projection shortcut (resnet18/34)."""

    expansion = 1

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 downsample: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.block1 = ConvBN(in_channels, features, 3, stride, compute_dtype)
        self.block2 = ConvBN(features, features, 3, 1, compute_dtype)
        self.shortcut = (ConvBN(in_channels, features, 1, stride, compute_dtype)
                         if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.block2(F.relu(self.block1(x)))
        residual = x if self.shortcut is None else self.shortcut(x)
        return F.relu(y + residual.to(y.dtype))


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1(x4) bottleneck (resnet50/101/152)."""

    expansion = 4

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 downsample: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        out = features * self.expansion
        self.block1 = ConvBN(in_channels, features, 1, 1, compute_dtype)
        self.block2 = ConvBN(features, features, 3, stride, compute_dtype)
        self.block3 = ConvBN(features, out, 1, 1, compute_dtype)
        self.shortcut = (ConvBN(in_channels, out, 1, stride, compute_dtype)
                         if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.block1(x))
        y = F.relu(self.block2(y))
        y = self.block3(y)
        residual = x if self.shortcut is None else self.shortcut(x)
        return F.relu(y + residual.to(y.dtype))


class ResNet(nn.Module):
    """torchvision-style ResNet returning pooled (B, feature_size) fp32
    features (the classifier is chopped)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls=Bottleneck,
                 width: int = 64, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stem = ConvBN(3, width, 7, 2, compute_dtype)
        self.block_names = []
        in_channels = width
        for stage, num_blocks in enumerate(stage_sizes):
            features = width * 2 ** stage
            for blk in range(num_blocks):
                stride = 2 if stage > 0 and blk == 0 else 1
                needs_proj = blk == 0 and (stage > 0 or block_cls.expansion != 1)
                name = f"layer{stage + 1}_{blk}"
                self.add_module(name, block_cls(
                    in_channels, features, stride, needs_proj, compute_dtype))
                self.block_names.append(name)
                in_channels = features * block_cls.expansion
        self.feature_size = in_channels

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, H, W, 3) NHWC."""
        x = images.permute(0, 3, 1, 2)
        x = F.relu(self.stem(x))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x.float().mean(dim=(2, 3))


def resnet18(**kw) -> ResNet:
    return ResNet([2, 2, 2, 2], BasicBlock, **kw)


def resnet34(**kw) -> ResNet:
    return ResNet([3, 4, 6, 3], BasicBlock, **kw)


def resnet50(**kw) -> ResNet:
    return ResNet([3, 4, 6, 3], Bottleneck, **kw)


def resnet101(**kw) -> ResNet:
    return ResNet([3, 4, 23, 3], Bottleneck, **kw)


def resnet152(**kw) -> ResNet:
    return ResNet([3, 8, 36, 3], Bottleneck, **kw)


RESNETS = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
}
