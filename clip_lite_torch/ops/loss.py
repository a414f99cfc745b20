"""The JSD InfoMax loss's modules, as far as inference needs them.

The counterpart of the JAX package's ``ops/loss.py``.  The projection
heads (``MILinearBlock``) live inside the loss, because every downstream
eval projects through ``loss.global_d.{img_block, text_block}``.  This
slice carries the modules and their parameters (so a JAX parameter tree
maps onto them whole) and the projection API.  The objective itself, with
its priors and negatives, lands with the training slice (ROADMAP Queue 1,
``ops/loss.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from clip_lite_torch.ops.layers import BatchNorm, LayerNorm, Linear


def shortcut_init(t: torch.Tensor, generator: torch.Generator) -> None:
    """Noisy identity: U(-0.01, 0.01) with the leading diagonal exactly 1."""
    nn.init.uniform_(t, -0.01, 0.01, generator=generator)
    n = min(t.shape)
    t[torch.arange(n), torch.arange(n)] = 1.0


class MILinearBlock(nn.Module):
    """Projection head: Linear-BN-ReLU-Linear plus a noisy-identity
    shortcut, LayerNorm on the sum."""

    def __init__(self, feature_sz: int, units: int = 2048, bln: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = compute_dtype
        self.nonlinear_fc1 = Linear(feature_sz, units, bias=False,
                                    compute_dtype=dt)
        self.nonlinear_bn = BatchNorm(units, compute_dtype=dt)
        self.nonlinear_fc2 = Linear(units, units, compute_dtype=dt)
        self.shortcut = Linear(feature_sz, units, compute_dtype=dt,
                               weight_init=shortcut_init)
        self.block_ln = LayerNorm(units, compute_dtype=dt) if bln else None

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.nonlinear_bn(self.nonlinear_fc1(feat)))
        f = self.nonlinear_fc2(h) + self.shortcut(feat)
        return f if self.block_ln is None else self.block_ln(f)


class PriorDiscriminator(nn.Module):
    """3-layer MLP -> sigmoid, the prior-matching critic."""

    def __init__(self, in_dim: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.l0 = Linear(in_dim, 1000, compute_dtype=compute_dtype)
        self.l1 = Linear(1000, 200, compute_dtype=compute_dtype)
        self.l2 = Linear(200, 1, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.l1(F.relu(self.l0(x))))
        return torch.sigmoid(self.l2(h).float())


class GlobalDiscriminatorDot(nn.Module):
    """Encode-and-dot critic's parameters: one projection head per
    modality and the learnable temperature log(1/0.07)."""

    def __init__(self, image_dim: int, text_dim: int, units: int = 2048,
                 bln: bool = True, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_block = MILinearBlock(image_dim, units, bln, compute_dtype)
        self.text_block = MILinearBlock(text_dim, units, bln, compute_dtype)
        self.temperature = nn.Parameter(torch.empty(()))

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.constant_(self.temperature.data, math.log(1.0 / 0.07))

    def project_image(self, features: torch.Tensor) -> torch.Tensor:
        return self.img_block(features)

    def project_text(self, features: torch.Tensor) -> torch.Tensor:
        return self.text_block(features)


class JSDInfoMaxLoss(nn.Module):
    """Holds the critics of the JSD InfoMax objective (``dot`` critic,
    optional image and text priors) and exposes the projection API."""

    def __init__(self, image_dim: int, text_dim: int, critic_type: str = "dot",
                 image_prior: bool = True, text_prior: bool = False,
                 visual_self_supervised: bool = False,
                 textual_self_supervised: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if critic_type != "dot" or visual_self_supervised \
                or textual_self_supervised:
            raise NotImplementedError(
                f"critic {critic_type!r} with self-supervised terms "
                f"({visual_self_supervised}, {textual_self_supervised}) is not "
                "ported yet (ROADMAP Queue 1, the rest of the model matrix)")
        self.global_d = GlobalDiscriminatorDot(image_dim, text_dim,
                                               compute_dtype=compute_dtype)
        self.prior_d = (PriorDiscriminator(image_dim, compute_dtype)
                        if image_prior else None)
        self.text_prior_d = (PriorDiscriminator(text_dim, compute_dtype)
                             if text_prior else None)

    def project_image(self, features: torch.Tensor) -> torch.Tensor:
        return self.global_d.project_image(features)

    def project_text(self, features: torch.Tensor) -> torch.Tensor:
        return self.global_d.project_text(features)
