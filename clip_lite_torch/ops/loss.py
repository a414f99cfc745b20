"""The JSD InfoMax loss and its critics.

The counterpart of the JAX package's ``ops/loss.py``.  The projection
heads (``MILinearBlock``) live inside the loss, because every downstream
eval projects through ``loss.global_d.{img_block, text_block}``.  The
objective is ported whole: the normal and the cluster mode (hard
negatives), the four critic types (``dot``, ``concat``, ``condot``,
``dotcon``), both priors and the visual and textual self-supervised
terms.  All critic math (normalize, softplus, log) runs in float32
whatever the compute type of the projections.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from clip_lite_torch.ops.layers import (
    BatchNorm,
    LayerNorm,
    Linear,
    StepRNG,
    l2_normalize,
)
from clip_lite_torch.parallel.collectives import roll_shifted_left


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


class GlobalDiscriminator(nn.Module):
    """Concat-MLP critic: T(x, y) = MLP([x; y]), 512-512-1, in float32 out
    (``ops/loss.py:93-105`` of the JAX package)."""

    def __init__(self, dim1: int, dim2: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.l0 = Linear(dim1 + dim2, 512, compute_dtype=compute_dtype)
        self.l1 = Linear(512, 512, compute_dtype=compute_dtype)
        self.l2 = Linear(512, 1, compute_dtype=compute_dtype)

    def forward(self, features1: torch.Tensor,
                features2: torch.Tensor) -> torch.Tensor:
        x = torch.cat([features1, features2], dim=1)
        h = F.relu(self.l1(F.relu(self.l0(x))))
        return self.l2(h).float()[:, 0]


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

    def forward(self, features1: torch.Tensor,
                features2: torch.Tensor) -> torch.Tensor:
        """Paired critic T(x, y): both projected, L2-normalized, dotted
        row by row and scaled by exp(temperature), in float32.  The heads'
        BatchNorm follows the module's training mode."""
        f1 = l2_normalize(self.img_block(features1))
        f2 = l2_normalize(self.text_block(features2))
        return (f1 * f2).sum(-1) * torch.exp(self.temperature)

    def project_image(self, features: torch.Tensor) -> torch.Tensor:
        return self.img_block(features)

    def project_text(self, features: torch.Tensor) -> torch.Tensor:
        return self.text_block(features)


def _jsd_pair_terms(critic: nn.Module, pos1: torch.Tensor, pos2: torch.Tensor,
                    neg2: torch.Tensor) -> torch.Tensor:
    """Em - Ej with Ej = -softplus(-T(x, y)).mean() and
    Em = softplus(T(x, y')).mean().  Two critic calls, as in the JAX
    package (``ops/loss.py:149-154``): in training each moves the heads'
    BatchNorm running statistics once."""
    ej = -F.softplus(-critic(pos1, pos2)).mean()
    em = F.softplus(critic(pos1, neg2)).mean()
    return em - ej


# The critics of each critic type: (global_d, visual_d and textual_d),
# ``ops/loss.py:183-208`` of the JAX package.
CRITICS = {"dot": ("dot", "dot"), "concat": ("concat", "concat"),
           "condot": ("concat", "dot"), "dotcon": ("dot", "concat")}


def _critic(kind: str, dim1: int, dim2: int,
            compute_dtype: torch.dtype) -> nn.Module:
    if kind == "dot":
        return GlobalDiscriminatorDot(dim1, dim2, compute_dtype=compute_dtype)
    return GlobalDiscriminator(dim1, dim2, compute_dtype=compute_dtype)


class JSDInfoMaxLoss(nn.Module):
    """JSD InfoMax objective, in the normal or the cluster mode, with
    optional image and text priors and self-supervised terms:

        total = (1 - prior_weight) * (cross_modal + visual + textual)
              + prior_weight * prior

    ``critic_type`` picks the cross-modal critic ``global_d`` and the SSL
    critics ``visual_d`` (image against its augmented view) and
    ``textual_d`` (caption against another caption), each a
    :class:`GlobalDiscriminatorDot` or a :class:`GlobalDiscriminator`
    (:data:`CRITICS`).  Negatives pair each item with the next one in the
    batch (:func:`roll_shifted_left`), the augmented features' too; in
    cluster mode the hard negatives' captions join them."""

    def __init__(self, image_dim: int, text_dim: int, critic_type: str = "dot",
                 prior_weight: float = 0.1,
                 image_prior: bool = True, text_prior: bool = False,
                 visual_self_supervised: bool = False,
                 textual_self_supervised: bool = False,
                 negatives: str = "local",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if critic_type not in CRITICS:
            raise ValueError(f"Unknown critic type {critic_type!r}")
        cross, ssl = CRITICS[critic_type]
        dt = compute_dtype
        self.global_d = _critic(cross, image_dim, text_dim, dt)
        self.visual_d = (_critic(ssl, image_dim, image_dim, dt)
                         if visual_self_supervised else None)
        self.textual_d = (_critic(ssl, text_dim, text_dim, dt)
                          if textual_self_supervised else None)
        self.prior_d = (PriorDiscriminator(image_dim, compute_dtype)
                        if image_prior else None)
        self.text_prior_d = (PriorDiscriminator(text_dim, compute_dtype)
                             if text_prior else None)
        self.prior_weight = prior_weight
        self.negatives = negatives

    def forward(self, image_features: torch.Tensor,
                text_features: torch.Tensor,
                neg_image_features: Optional[torch.Tensor] = None,
                neg_text_features: Optional[torch.Tensor] = None,
                aug_image_features: Optional[torch.Tensor] = None,
                aug_text_features: Optional[torch.Tensor] = None,
                prior_noise: Optional[Dict[str, torch.Tensor]] = None,
                rng: Optional[StepRNG] = None) -> Dict[str, torch.Tensor]:
        """The loss components (fp32 scalars), as the JAX package's
        ``JSDInfoMaxLoss.__call__`` returns them.

        ``prior_noise``: optional ``{"image": ..., "text": ...}`` U[0, 1)
        inputs of the prior terms, shaped as the features; by default
        drawn from ``rng``, the step's generator.  ``neg_image_features``
        and ``neg_text_features`` (the hard negatives' features) put the
        cross-modal term in cluster mode (``ops/loss.py:247-263`` of the
        JAX package): its positive part over the pairs and the negatives'
        own pairs, its negative part pairing every image with the
        negatives' captions and the pairs' captions rolled by one.
        ``aug_image_features`` and ``aug_text_features`` (the towers'
        features of the augmented views) add the visual and textual terms.
        """
        if (neg_image_features is None) != (neg_text_features is None):
            raise ValueError("cluster mode needs both neg_image_features and "
                             "neg_text_features")
        zero = image_features.new_zeros((), dtype=torch.float32)
        prior_total = zero
        for key, critic, feats in (("image", self.prior_d, image_features),
                                   ("text", self.text_prior_d, text_features)):
            if critic is None:
                continue
            if prior_noise is not None:
                noise = prior_noise[key].to(feats.device, torch.float32)
            elif rng is not None:
                noise = rng.uniform(feats.shape)
            else:
                raise ValueError("the prior terms need prior_noise or the "
                                 "step's StepRNG")
            term_a = torch.log(critic(noise)).mean()
            term_b = torch.log(1.0 - critic(feats)).mean()
            prior_total = prior_total - (term_a + term_b)

        text_prime = roll_shifted_left(text_features, self.negatives)
        if neg_text_features is None:
            cross_modal = _jsd_pair_terms(self.global_d, image_features,
                                          text_features, text_prime)
        else:
            image_all = torch.cat([image_features, neg_image_features])
            cross_modal = _jsd_pair_terms(
                self.global_d, image_all,
                torch.cat([text_features, neg_text_features]),
                torch.cat([neg_text_features, text_prime]))
        # The SSL terms, in the JAX package's order (``ops/loss.py:265-280``).
        ssl = {}
        for key, critic, feats, aug in (
                ("visual", self.visual_d, image_features, aug_image_features),
                ("textual", self.textual_d, text_features, aug_text_features)):
            if aug is None:
                ssl[key] = zero
                continue
            if critic is None:
                raise ValueError(f"{key} SSL features given to a loss built "
                                 f"without {key}_self_supervised")
            ssl[key] = _jsd_pair_terms(critic, feats, aug,
                                       roll_shifted_left(aug, self.negatives))
        jsd = cross_modal + ssl["visual"] + ssl["textual"]
        total = ((1.0 - self.prior_weight) * jsd
                 + self.prior_weight * prior_total)
        return {"total_loss": total, "cross_modal_loss": cross_modal,
                "visual_loss": ssl["visual"], "textual_loss": ssl["textual"]}

    def _projection(self, side: str, features: torch.Tensor) -> torch.Tensor:
        if not isinstance(self.global_d, GlobalDiscriminatorDot):
            raise TypeError("the concat critic has no projection heads: the "
                            "evals project through a dot global_d")
        return getattr(self.global_d, f"project_{side}")(features)

    def project_image(self, features: torch.Tensor) -> torch.Tensor:
        return self._projection("image", features)

    def project_text(self, features: torch.Tensor) -> torch.Tensor:
        return self._projection("text", features)
