"""VGG image towers (torchvision's layout), the counterpart of the JAX
package's ``models/vgg.py``.

VGG11/13/16/19, each with and without BatchNorm after every conv.  As in
the JAX package (and the reference, whose ``fc = Identity`` assignment
misses VGG's ``classifier``), the tower keeps its classifier MLP
(fc1 4096, ReLU, dropout 0.5, fc2 4096, ReLU, dropout 0.5, fc3) and emits
``num_classes`` (1000) features.  Dropout draws from the step's
:class:`~clip_lite_torch.ops.layers.StepRNG`.

The 3x3 convs carry a bias, initialised as flax's ``nn.Conv``: LeCun
normal (truncated) weights and zero biases.  After the last pool the map
is brought to 7x7 as ``jax.image.resize(..., "linear")`` does
(:func:`resize_linear`; the identity at 224 px), and ``fc1`` reads it
flattened in NHWC order, (h, w, c), as the JAX tower does, so a bridged
``fc1`` needs no permutation.  Module names follow the JAX parameter
tree (``conv{i}``, ``bn{i}``, ``fc1``-``fc3``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from clip_lite_torch.ops.layers import BatchNorm, Linear, StepRNG, dropout

_CFGS = {
    "vgg11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "vgg13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
              512, 512, "M"],
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
              "M", 512, 512, 512, "M"],
    "vgg19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}

# flax's lecun_normal draws N(0, 1) truncated to [-2, 2] and scales it so
# that the variance is 1 / fan_in: the std of that truncation is 0.8796.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """flax's ``lecun_normal`` (variance_scaling 1, fan_in, truncated
    normal) in place."""
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


class Conv2d(nn.Conv2d):
    """flax ``nn.Conv``'s counterpart: explicit symmetric ``padding``,
    ``groups`` (``feature_group_count``), an optional bias; computes in
    ``compute_dtype`` with fp32 parameters.  ``init`` ``lecun`` is flax's
    default initialiser, ``fan_out`` the model zoo's kaiming normal
    (variance_scaling 2, fan_out, normal)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 bias: bool = True, init: str = "lecun",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding=padding, groups=groups, bias=bias)
        self.init = init
        self.compute_dtype = compute_dtype

    def init_weights(self, generator: torch.Generator) -> None:
        kh, kw = self.kernel_size
        if self.init == "fan_out":
            # flax's fan_out of an HWIO kernel: kh * kw * out channels.
            fan_out = kh * kw * self.out_channels
            nn.init.normal_(self.weight.data, 0.0, (2.0 / fan_out) ** 0.5,
                            generator=generator)
        else:
            lecun_normal_(self.weight.data,
                          kh * kw * self.in_channels // self.groups, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias.data)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


def resize_linear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, ..., method="linear")`` of an NCHW map, in
    float32: half-pixel centres, and when a side shrinks the triangle
    kernel widened by the scale (antialiasing), which is what
    ``F.interpolate(..., antialias=True)`` computes.  The two agree within
    1e-6 (``tests/test_torch_vgg.py``)."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x.float()
    return F.interpolate(x.float(), size=size, mode="bilinear",
                         align_corners=False, antialias=True)


class VGG(nn.Module):
    """(B, H, W, 3) NHWC images -> (B, feature_size) fp32."""

    def __init__(self, cfg: Sequence[Union[int, str]], batch_norm: bool = False,
                 num_classes: Optional[int] = 1000, dropout_rate: float = 0.5,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = list(cfg)
        self.batch_norm = batch_norm
        self.dropout_rate = dropout_rate
        self.compute_dtype = compute_dtype
        in_channels = 3
        for i, v in enumerate(v for v in self.cfg if v != "M"):
            self.add_module(f"conv{i}", Conv2d(in_channels, v, 3, padding=1,
                                               compute_dtype=compute_dtype))
            if batch_norm:
                self.add_module(f"bn{i}", BatchNorm(v, compute_dtype=compute_dtype))
            in_channels = v
        self.fc1 = Linear(7 * 7 * in_channels, 4096, compute_dtype=compute_dtype)
        self.fc2 = Linear(4096, 4096, compute_dtype=compute_dtype)
        self.fc3 = Linear(4096, num_classes) if num_classes else None
        self.feature_size = num_classes if num_classes else 4096

    def forward(self, images: torch.Tensor,
                rng: Optional[StepRNG] = None) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)
        i = 0
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = getattr(self, f"conv{i}")(x)
            if self.batch_norm:
                x = getattr(self, f"bn{i}")(x)
            x = F.relu(x)
            i += 1
        x = resize_linear(x, (7, 7)).to(x.dtype)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (h, w, c), as JAX
        rate = self.dropout_rate if self.training else 0.0
        x = dropout(F.relu(self.fc1(x)), rate, rng)
        x = dropout(F.relu(self.fc2(x)), rate, rng)
        if self.fc3 is not None:
            x = self.fc3(x.float())
        return x.float()


def _make(name: str, bn: bool):
    def ctor(compute_dtype: torch.dtype = torch.float32, **kw) -> VGG:
        return VGG(_CFGS[name], batch_norm=bn, compute_dtype=compute_dtype, **kw)
    return ctor


VGGS = {name: _make(name, False) for name in _CFGS}
VGGS.update({f"{name}_bn": _make(name, True) for name in _CFGS})
