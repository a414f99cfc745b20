"""Image tower wrapper, the counterpart of the JAX package's
``models/image_encoder.py``: a registered backbone by name, classifier
chopped.  ``frozen`` keeps the backbone in eval mode with no gradients.
Only the ResNets are registered yet; VGG and the model zoo are queued in
ROADMAP.md (Queue 1).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from clip_lite_torch.models.resnet import RESNETS

BACKBONES: Dict[str, Any] = dict(RESNETS)


class ImageEncoder(nn.Module):
    """Maps (B, H, W, 3) NHWC images to (B, feature_size) fp32 features."""

    def __init__(self, img_enc_net: str = "resnet50", frozen: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 bn_mode: str = "local", width: int = 64):
        super().__init__()
        if img_enc_net not in BACKBONES:
            raise KeyError(f"Unknown visual backbone {img_enc_net!r}. "
                           f"Choices: {sorted(BACKBONES)}")
        if bn_mode != "local":
            raise NotImplementedError(
                "sync BatchNorm lands with multi-GPU training (ROADMAP "
                "Queue 1, Multi-GPU)")
        self.frozen = frozen
        self.backbone = BACKBONES[img_enc_net](width=width,
                                               compute_dtype=compute_dtype)
        self.feature_size = self.backbone.feature_size
        if frozen:
            self.backbone.requires_grad_(False)

    def train(self, mode: bool = True) -> "ImageEncoder":
        super().train(mode)
        if self.frozen:
            self.backbone.eval()
        return self

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        return self.backbone(image)
