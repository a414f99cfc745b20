"""The model zoo: CIFAR-scale backbones and the distillation heads, the
counterpart of the JAX package's ``models/zoo.py`` (the CRD-style
collection: CIFAR ResNets, ResNetV2, WideResNet, CIFAR VGG-BN,
MobileNetV2-0.5x, ShuffleNetV1/V2, classifier heads and the
distillation regressors).

As in the JAX package every module takes and gives NHWC maps (images,
``return_features``' per-stage maps, the regressors' inputs and outputs),
and the flattening modules read (h, w, c) order, so bridged weights need
no permutation; inside, convolutions run NCHW.  Module names follow the
JAX parameter tree.  The cells follow the JAX ones to the letter:

* ``padding`` is torch's symmetric k//2, not XLA's SAME (which pads a
  stride-2 conv (0, 1));
* grouped and depthwise convs are ``groups`` (flax's
  ``feature_group_count``);
* ShuffleNetV1's 3x3/2 average pool pads by 1 and counts the padded
  zeros, as flax's ``avg_pool`` does (``count_include_pad``);
* :func:`channel_shuffle` gives the NHWC function's channel order.

Conv weights are initialised kaiming normal over fan-out (flax's
``variance_scaling(2, "fan_out", "normal")``), WideResNet's and the
ConvBN cells' alike; BatchNorm follows flax
(:class:`~clip_lite_torch.ops.layers.BatchNorm`) and stays per rank: the
zoo towers take no sync BatchNorm, as the JAX registry drops their
``bn_axis_name``.

The heads and regressors whose input width flax infers take it as
``in_features``/``in_channels`` here.  :data:`model_dict` is the JAX
registry's; :func:`zoo_backbones` gives its backbones as ``zoo::<name>``
feature extractors (``num_classes=None``) for
``models/image_encoder.py``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from clip_lite_torch.models.vgg import Conv2d, resize_linear
from clip_lite_torch.ops.layers import (
    BatchNorm,
    Linear,
    StepRNG,
    dropout,
    l2_normalize,
)

F32 = torch.float32


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class ConvBN(nn.Module):
    """Conv (no bias, symmetric k//2 padding) + BatchNorm + optional ReLU,
    on NCHW maps."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, use_relu: bool = True,
                 compute_dtype: torch.dtype = F32):
        super().__init__()
        self.conv = Conv2d(in_channels, features, kernel, stride, kernel // 2,
                           groups, bias=False, init="fan_out",
                           compute_dtype=compute_dtype)
        self.bn = BatchNorm(features, compute_dtype=compute_dtype)
        self.use_relu = use_relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x) if self.use_relu else x


def _pool_head(model: nn.Module, x: torch.Tensor, feats: List[torch.Tensor],
               return_features: bool):
    """fp32 global mean, then the classifier ``fc`` where there is one."""
    x = x.float().mean(dim=(2, 3))
    feats.append(x)
    logits = model.fc(x) if model.fc is not None else x
    return (feats, logits) if return_features else logits


def _fc(in_features: int, num_classes: Optional[int]) -> Optional[Linear]:
    return Linear(in_features, num_classes) if num_classes else None


# ---------------------------------------------------------------------------
# CIFAR ResNet: depth = 6n+2, 3 stages.
# ---------------------------------------------------------------------------

class CifarBasicBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 compute_dtype: torch.dtype = F32):
        super().__init__()
        self.c1 = ConvBN(in_channels, features, stride=stride,
                         compute_dtype=compute_dtype)
        self.c2 = ConvBN(features, features, use_relu=False,
                         compute_dtype=compute_dtype)
        self.shortcut = (ConvBN(in_channels, features, 1, stride,
                                use_relu=False, compute_dtype=compute_dtype)
                         if in_channels != features or stride != 1 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.c2(self.c1(x))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return F.relu(y + x)


class CifarResNet(nn.Module):
    def __init__(self, depth: int, filters: Sequence[int] = (16, 16, 32, 64),
                 num_classes: Optional[int] = 100,
                 compute_dtype: torch.dtype = F32):
        super().__init__()
        if (depth - 2) % 6:
            raise ValueError("CIFAR ResNet depth must be 6n+2")
        n = (depth - 2) // 6
        self.stem = ConvBN(3, filters[0], compute_dtype=compute_dtype)
        self.stages: List[List[str]] = []
        in_channels = filters[0]
        for stage in range(3):
            names = []
            for blk in range(n):
                stride = 2 if stage > 0 and blk == 0 else 1
                name = f"layer{stage + 1}_{blk}"
                self.add_module(name, CifarBasicBlock(
                    in_channels, filters[stage + 1], stride, compute_dtype))
                names.append(name)
                in_channels = filters[stage + 1]
            self.stages.append(names)
        self.feature_size = filters[3]
        self.fc = _fc(filters[3], num_classes)

    def forward(self, images: torch.Tensor, return_features: bool = False):
        x = self.stem(_nchw(images))
        feats = [_nhwc(x)]
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            feats.append(_nhwc(x))
        return _pool_head(self, x, feats, return_features)


# ---------------------------------------------------------------------------
# ResNetV2: ImageNet bottlenecks with a 3x3 CIFAR stem.
# ---------------------------------------------------------------------------

class V2Bottleneck(nn.Module):
    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 compute_dtype: torch.dtype = F32):
        super().__init__()
        out = features * 4
        self.c1 = ConvBN(in_channels, features, 1, compute_dtype=compute_dtype)
        self.c2 = ConvBN(features, features, 3, stride,
                         compute_dtype=compute_dtype)
        self.c3 = ConvBN(features, out, 1, use_relu=False,
                         compute_dtype=compute_dtype)
        self.shortcut = (ConvBN(in_channels, out, 1, stride, use_relu=False,
                                compute_dtype=compute_dtype)
                         if in_channels != out or stride != 1 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.c3(self.c2(self.c1(x)))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return F.relu(y + x)


class ResNetV2(nn.Module):
    def __init__(self, stage_sizes: Sequence[int],
                 num_classes: Optional[int] = 100,
                 compute_dtype: torch.dtype = F32):
        super().__init__()
        self.stem = ConvBN(3, 64, compute_dtype=compute_dtype)
        self.stages: List[List[str]] = []
        in_channels = 64
        for stage, blocks in enumerate(stage_sizes):
            names = []
            for blk in range(blocks):
                stride = 2 if stage > 0 and blk == 0 else 1
                name = f"layer{stage + 1}_{blk}"
                self.add_module(name, V2Bottleneck(
                    in_channels, 64 * 2 ** stage, stride, compute_dtype))
                names.append(name)
                in_channels = 64 * 2 ** stage * 4
            self.stages.append(names)
        self.feature_size = 512 * 4
        self.fc = _fc(in_channels, num_classes)

    forward = CifarResNet.forward


# ---------------------------------------------------------------------------
# Wide ResNet: depth = 6n+4, pre-activation.
# ---------------------------------------------------------------------------

class WRNBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 compute_dtype: torch.dtype = F32):
        super().__init__()
        dt = compute_dtype
        self.compute_dtype = dt
        self.bn1 = BatchNorm(in_channels)
        self.conv1 = Conv2d(in_channels, features, 3, stride, 1, bias=False,
                            init="fan_out", compute_dtype=dt)
        self.bn2 = BatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, 1, 1, bias=False,
                            init="fan_out", compute_dtype=dt)
        self.shortcut = (Conv2d(in_channels, features, 1, stride, 0,
                                bias=False, init="fan_out", compute_dtype=dt)
                         if in_channels != features or stride != 1 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(x.float())).to(self.compute_dtype)
        y = self.conv1(h)
        y = F.relu(self.bn2(y.float())).to(self.compute_dtype)
        y = self.conv2(y)
        if self.shortcut is not None:
            x = self.shortcut(h)  # from the pre-activated input, as JAX's
        return y + x


class WideResNet(nn.Module):
    def __init__(self, depth: int, widen: int,
                 num_classes: Optional[int] = 100,
                 compute_dtype: torch.dtype = F32):
        super().__init__()
        if (depth - 4) % 6:
            raise ValueError("WRN depth must be 6n+4")
        n = (depth - 4) // 6
        widths = [16, 16 * widen, 32 * widen, 64 * widen]
        self.stem = Conv2d(3, widths[0], 3, 1, 1, bias=False, init="fan_out",
                           compute_dtype=compute_dtype)
        self.stages: List[List[str]] = []
        in_channels = widths[0]
        for stage in range(3):
            names = []
            for blk in range(n):
                stride = 2 if stage > 0 and blk == 0 else 1
                name = f"layer{stage + 1}_{blk}"
                self.add_module(name, WRNBlock(in_channels, widths[stage + 1],
                                               stride, compute_dtype))
                names.append(name)
                in_channels = widths[stage + 1]
            self.stages.append(names)
        self.final_bn = BatchNorm(in_channels)
        self.feature_size = 64 * widen
        self.fc = _fc(in_channels, num_classes)

    def forward(self, images: torch.Tensor, return_features: bool = False):
        x = self.stem(_nchw(images))
        feats = [_nhwc(x)]
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            feats.append(_nhwc(x))
        x = F.relu(self.final_bn(x.float()))
        return _pool_head(self, x, feats, return_features)


# ---------------------------------------------------------------------------
# CIFAR VGG-BN (vgg8..19): conv stages and one FC head.
# ---------------------------------------------------------------------------

_ZOO_VGG_CFGS = {
    8: [64, "M", 128, "M", 256, "M", 512, "M", 512, "M"],
    11: [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    13: [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
         512, 512, "M"],
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
         512, 512, 512, "M"],
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


class CifarVGG(nn.Module):
    def __init__(self, depth: int, num_classes: Optional[int] = 100,
                 compute_dtype: torch.dtype = F32):
        super().__init__()
        self.cfg = _ZOO_VGG_CFGS[depth]
        in_channels, ci = 3, 0
        for v in self.cfg:
            if v != "M":
                self.add_module(f"conv{ci}", ConvBN(in_channels, v,
                                                    compute_dtype=compute_dtype))
                in_channels, ci = v, ci + 1
        self.feature_size = 512
        self.fc = _fc(in_channels, num_classes)

    def forward(self, images: torch.Tensor, return_features: bool = False):
        x = _nchw(images)
        feats: List[torch.Tensor] = []
        ci = 0
        for v in self.cfg:
            if v == "M":
                if x.shape[2] > 1:  # JAX's x.shape[1], the height
                    x = F.max_pool2d(x, 2, 2)
                feats.append(_nhwc(x))
            else:
                x = getattr(self, f"conv{ci}")(x)
                ci += 1
        return _pool_head(self, x, feats, return_features)


# ---------------------------------------------------------------------------
# MobileNetV2 (width 0.5, "mobile_half"): inverted residuals.
# ---------------------------------------------------------------------------

class InvertedResidual(nn.Module):
    def __init__(self, in_channels: int, features: int, stride: int,
                 expand: int, compute_dtype: torch.dtype = F32):
        super().__init__()
        hidden = in_channels * expand
        dt = compute_dtype
        self.expand = (ConvBN(in_channels, hidden, 1, compute_dtype=dt)
                       if expand != 1 else None)
        self.depthwise = ConvBN(hidden, hidden, 3, stride, groups=hidden,
                                compute_dtype=dt)
        self.project = ConvBN(hidden, features, 1, use_relu=False,
                              compute_dtype=dt)
        self.residual = stride == 1 and in_channels == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.expand(x) if self.expand is not None else x
        y = self.project(self.depthwise(y))
        return y + x if self.residual else y


class MobileNetV2(nn.Module):
    # (expansion, out_channels, num_blocks, stride): the standard table.
    SETTINGS = [(1, 16, 1, 1), (6, 24, 2, 1), (6, 32, 3, 2), (6, 64, 4, 2),
                (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]

    def __init__(self, width_mult: float = 0.5,
                 num_classes: Optional[int] = 100,
                 compute_dtype: torch.dtype = F32):
        super().__init__()
        w = lambda c: max(8, int(c * width_mult))  # noqa: E731
        dt = compute_dtype
        self.feature_size = max(1280, int(1280 * width_mult))
        self.stem = ConvBN(3, w(32), compute_dtype=dt)
        self.stages: List[List[str]] = []
        in_channels, bi = w(32), 0
        for t, c, n, s in self.SETTINGS:
            names = []
            for i in range(n):
                name = f"block{bi}"
                self.add_module(name, InvertedResidual(
                    in_channels, w(c), s if i == 0 else 1, t if bi else 1, dt))
                names.append(name)
                in_channels, bi = w(c), bi + 1
            self.stages.append(names)
        self.head = ConvBN(in_channels, self.feature_size, 1, compute_dtype=dt)
        self.fc = _fc(self.feature_size, num_classes)

    def forward(self, images: torch.Tensor, return_features: bool = False):
        x = self.stem(_nchw(images))
        feats = [_nhwc(x)]
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            feats.append(_nhwc(x))
        return _pool_head(self, self.head(x), feats, return_features)


# ---------------------------------------------------------------------------
# ShuffleNet V1 / V2.
# ---------------------------------------------------------------------------

def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """The JAX function's channel order on an NCHW map: channel
    ``i * (c // groups) + j`` goes to ``j * groups + i``."""
    b, c, h, w = x.shape
    return x.reshape(b, groups, c // groups, h, w).transpose(1, 2).reshape(
        b, c, h, w)


class ShuffleV1Block(nn.Module):
    def __init__(self, in_channels: int, features: int, stride: int,
                 groups: int, first: bool = False,
                 compute_dtype: torch.dtype = F32):
        super().__init__()
        dt = compute_dtype
        mid = features // 4
        self.groups = groups
        self.down = stride == 2
        out = features - in_channels if self.down else features
        self.gconv1 = ConvBN(in_channels, mid, 1, groups=1 if first else groups,
                             compute_dtype=dt)
        self.depthwise = ConvBN(mid, mid, 3, stride, groups=mid,
                                use_relu=False, compute_dtype=dt)
        self.gconv2 = ConvBN(mid, out, 1, groups=groups, use_relu=False,
                             compute_dtype=dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = channel_shuffle(self.gconv1(x), self.groups)
        y = self.gconv2(self.depthwise(y))
        if self.down:
            x = F.avg_pool2d(x, 3, 2, 1, count_include_pad=True)
            return F.relu(torch.cat([x.to(y.dtype), y], dim=1))
        return F.relu(x.to(y.dtype) + y)


class ShuffleNetV1(nn.Module):
    out_channels = {1: (144, 288, 576), 2: (200, 400, 800),
                    3: (240, 480, 960), 4: (272, 544, 1088),
                    8: (384, 768, 1536)}
    stage_blocks = (4, 8, 4)

    def __init__(self, groups: int = 2, num_classes: Optional[int] = 100,
                 compute_dtype: torch.dtype = F32):
        super().__init__()
        widths = self.out_channels[groups]
        self.stem = ConvBN(3, 24, 1, compute_dtype=compute_dtype)
        self.stages: List[List[str]] = []
        in_channels = 24
        for stage, (width, blocks) in enumerate(zip(widths, self.stage_blocks)):
            names = []
            for blk in range(blocks):
                name = f"stage{stage}_{blk}"
                self.add_module(name, ShuffleV1Block(
                    in_channels, width, 2 if blk == 0 else 1, groups,
                    first=stage == 0 and blk == 0,
                    compute_dtype=compute_dtype))
                names.append(name)
                in_channels = width
            self.stages.append(names)
        self.feature_size = widths[2]
        self.fc = _fc(widths[2], num_classes)

    forward = CifarResNet.forward


class ShuffleV2Block(nn.Module):
    def __init__(self, in_channels: int, features: int, down: bool = False,
                 compute_dtype: torch.dtype = F32):
        super().__init__()
        dt = compute_dtype
        self.down = down
        half = features // 2
        right = in_channels if down else in_channels - in_channels // 2
        self.r1 = ConvBN(right, half, 1, compute_dtype=dt)
        self.rdw = ConvBN(half, half, 3, 2 if down else 1, groups=half,
                          use_relu=False, compute_dtype=dt)
        self.r2 = ConvBN(half, half, 1, compute_dtype=dt)
        if down:
            self.ldw = ConvBN(in_channels, in_channels, 3, 2,
                              groups=in_channels, use_relu=False,
                              compute_dtype=dt)
            self.l2 = ConvBN(in_channels, half, 1, compute_dtype=dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.down:
            left, right = x, x
        else:
            c = x.shape[1] // 2
            left, right = x[:, :c], x[:, c:]
        r = self.r2(self.rdw(self.r1(right)))
        left = self.l2(self.ldw(left)) if self.down else left.to(r.dtype)
        return channel_shuffle(torch.cat([left, r], dim=1), 2)


class ShuffleNetV2(nn.Module):
    configs = {0.5: (48, 96, 192, 1024), 1.0: (116, 232, 464, 1024),
               1.5: (176, 352, 704, 1024), 2.0: (224, 488, 976, 2048)}
    stage_blocks = (3, 7, 3)

    def __init__(self, size: float = 1.0, num_classes: Optional[int] = 100,
                 compute_dtype: torch.dtype = F32):
        super().__init__()
        c1, c2, c3, head = self.configs[size]
        dt = compute_dtype
        self.stem = ConvBN(3, 24, compute_dtype=dt)
        self.stages: List[List[str]] = []
        in_channels = 24
        for stage, (width, blocks) in enumerate(zip((c1, c2, c3),
                                                    self.stage_blocks)):
            names = [f"stage{stage}_down"]
            self.add_module(names[0], ShuffleV2Block(in_channels, width, True, dt))
            for blk in range(blocks):
                names.append(f"stage{stage}_{blk}")
                self.add_module(names[-1], ShuffleV2Block(width, width,
                                                          compute_dtype=dt))
            self.stages.append(names)
            in_channels = width
        self.head = ConvBN(in_channels, head, 1, compute_dtype=dt)
        self.feature_size = head
        self.fc = _fc(head, num_classes)

    forward = MobileNetV2.forward


# ---------------------------------------------------------------------------
# Classifier heads and distillation regressors (NHWC maps in and out).
# ---------------------------------------------------------------------------

class LinearClassifierHead(nn.Module):
    def __init__(self, in_features: int, num_classes: int = 100):
        super().__init__()
        self.fc = Linear(in_features, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x)


class NonLinearClassifierHead(nn.Module):
    """fc1 (``hidden``), ReLU, dropout 0.1 in training (from ``rng``),
    fc2."""

    def __init__(self, in_features: int, num_classes: int = 100,
                 hidden: int = 200):
        super().__init__()
        self.fc1 = Linear(in_features, hidden)
        self.fc2 = Linear(hidden, num_classes)

    def forward(self, x: torch.Tensor,
                rng: Optional[StepRNG] = None) -> torch.Tensor:
        x = dropout(F.relu(self.fc1(x)), 0.1 if self.training else 0.0, rng)
        return self.fc2(x)


class Conv4(nn.Module):
    """The 4-conv probe network: 64-wide ConvBN cells, stride 2 after the
    first; with ``max_pool`` (Conv4MP) stride 1 and a 2x2 max pool after
    every cell."""

    def __init__(self, num_classes: int = 100, in_channels: int = 3,
                 max_pool: bool = False):
        super().__init__()
        self.max_pool = max_pool
        for i in range(4):
            self.add_module(f"conv{i}", ConvBN(
                in_channels if i == 0 else 64, 64,
                stride=2 if i and not max_pool else 1))
        self.fc = Linear(64, num_classes)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = _nchw(images)
        for i in range(4):
            x = getattr(self, f"conv{i}")(x)
            if self.max_pool:
                x = F.max_pool2d(x, 2, 2)
        return self.fc(x.float().mean(dim=(2, 3)))


def Conv4MP(num_classes: int = 100, in_channels: int = 3) -> Conv4:
    return Conv4(num_classes, in_channels, max_pool=True)


def flatten_features(x: torch.Tensor) -> torch.Tensor:
    """(B, ...) -> (B, -1); an NHWC map flattens in (h, w, c) order."""
    return x.reshape(x.shape[0], -1)


class Embed(nn.Module):
    """Linear embed of the flattened input, L2-normalised."""

    def __init__(self, in_features: int, dim_out: int = 128):
        super().__init__()
        self.linear = Linear(in_features, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return l2_normalize(self.linear(flatten_features(x)))


class LinearEmbed(Embed):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(flatten_features(x))


class MLPEmbed(nn.Module):
    def __init__(self, in_features: int, dim_out: int = 128):
        super().__init__()
        self.fc1 = Linear(in_features, 2 * dim_out)
        self.fc2 = Linear(2 * dim_out, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.fc1(flatten_features(x)))
        return l2_normalize(self.fc2(x))


class Regress(Embed):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.linear(flatten_features(x)))


class ConvReg(nn.Module):
    """A 3x3 ConvBN regressor from a student map to a teacher's width."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_relu: bool = True):
        super().__init__()
        self.reg = ConvBN(in_channels, out_channels, use_relu=use_relu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nhwc(self.reg(_nchw(x)))


def _chain(module: nn.Module, prefix: str, in_channels: int,
           widths: Sequence[int]) -> None:
    for i, f in enumerate(widths):
        module.add_module(f"{prefix}{i}", ConvBN(in_channels, f))
        in_channels = f


def _run(module: nn.Module, prefix: str, n: int,
         x: torch.Tensor) -> torch.Tensor:
    for i in range(n):
        x = getattr(module, f"{prefix}{i}")(x)
    return x


class Paraphraser(nn.Module):
    """Factor transfer's teacher-side autoencoder: three ConvBN cells to
    ``max(8, round(c * k))`` channels (the factors), three back to c.
    Returns (factors, reconstruction)."""

    def __init__(self, in_channels: int, k: float = 0.5):
        super().__init__()
        c = in_channels
        mid = max(8, int(round(c * k)))
        _chain(self, "enc", c, [c, mid, mid])
        _chain(self, "dec", mid, [mid, c, c])

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        factors = _run(self, "enc", 3, _nchw(x))
        return _nhwc(factors), _nhwc(_run(self, "dec", 3, factors))


class Translator(nn.Module):
    """Factor transfer's student-side encoder to the teacher's factors."""

    def __init__(self, in_channels: int, k: float = 0.5,
                 out_channels: int = 64):
        super().__init__()
        mid = max(8, int(round(out_channels * k)))
        _chain(self, "t", in_channels, [out_channels, mid, mid])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nhwc(_run(self, "t", 3, _nchw(x)))


class Connector(nn.Module):
    """A 1x1 ConvBN adapter (no ReLU) between stages."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conn = ConvBN(in_channels, out_channels, 1, use_relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nhwc(self.conn(_nchw(x)))


class PoolEmbed(nn.Module):
    """The map resized to ``pool_size`` square as ``jax.image.resize``
    linear does (antialiased when it shrinks), then embedded and
    L2-normalised."""

    def __init__(self, in_channels: int, dim_out: int = 128,
                 pool_size: int = 4):
        super().__init__()
        self.pool_size = pool_size
        self.linear = Linear(pool_size * pool_size * in_channels, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.pool_size
        x = _nhwc(resize_linear(_nchw(x), (s, s)))
        return l2_normalize(self.linear(flatten_features(x)))


# ---------------------------------------------------------------------------
# Registry.
# ---------------------------------------------------------------------------

def _cifar_resnet(depth, filters=(16, 16, 32, 64)):
    return lambda **kw: CifarResNet(depth, filters, **kw)


model_dict: dict = {
    "resnet8": _cifar_resnet(8),
    "resnet14": _cifar_resnet(14),
    "resnet20": _cifar_resnet(20),
    "resnet32": _cifar_resnet(32),
    "resnet44": _cifar_resnet(44),
    "resnet56": _cifar_resnet(56),
    "resnet110": _cifar_resnet(110),
    "resnet8x4": _cifar_resnet(8, (32, 64, 128, 256)),
    "resnet32x4": _cifar_resnet(32, (32, 64, 128, 256)),
    "ResNet50": lambda **kw: ResNetV2([3, 4, 6, 3], **kw),
    "wrn_16_1": lambda **kw: WideResNet(16, 1, **kw),
    "wrn_16_2": lambda **kw: WideResNet(16, 2, **kw),
    "wrn_40_1": lambda **kw: WideResNet(40, 1, **kw),
    "wrn_40_2": lambda **kw: WideResNet(40, 2, **kw),
    "vgg8": lambda **kw: CifarVGG(8, **kw),
    "vgg11": lambda **kw: CifarVGG(11, **kw),
    "vgg13": lambda **kw: CifarVGG(13, **kw),
    "vgg16": lambda **kw: CifarVGG(16, **kw),
    "vgg19": lambda **kw: CifarVGG(19, **kw),
    "MobileNetV2": lambda **kw: MobileNetV2(0.5, **kw),
    "ShuffleV1": lambda **kw: ShuffleNetV1(**kw),
    "ShuffleV2": lambda **kw: ShuffleNetV2(**kw),
    "LinearClassifier": LinearClassifierHead,
    "NonLinearClassifier": NonLinearClassifierHead,
    "Conv4": Conv4,
    "Conv4MP": Conv4MP,
}

_HEADS = ("LinearClassifier", "NonLinearClassifier", "Conv4", "Conv4MP")
BACKBONE_CLASSES = (CifarResNet, ResNetV2, WideResNet, CifarVGG, MobileNetV2,
                    ShuffleNetV1, ShuffleNetV2)


def zoo_backbones() -> dict:
    """The zoo's backbones as ``zoo::<name>`` visual towers: feature
    extractors (``num_classes=None``) taking ``compute_dtype``."""
    def make(ctor):
        def build(compute_dtype: torch.dtype = F32, **kw):
            return ctor(num_classes=None, compute_dtype=compute_dtype, **kw)
        return build

    return {f"zoo::{name}": make(ctor) for name, ctor in model_dict.items()
            if name not in _HEADS}
