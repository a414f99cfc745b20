"""VLInfoModel: the image tower, the text tower and the JSD loss's
critics, with the encoding and projection API the downstream evals use.
The training forward (the loss dict) lands with the training slice."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from clip_lite_torch.models.image_encoder import ImageEncoder
from clip_lite_torch.models.text_encoder import TextEncoder
from clip_lite_torch.ops.loss import JSDInfoMaxLoss


class VLInfoModel(nn.Module):
    def __init__(self, image_encoder: ImageEncoder, text_encoder: TextEncoder,
                 loss: JSDInfoMaxLoss):
        super().__init__()
        self.image_encoder = image_encoder
        self.text_encoder = text_encoder
        self.loss = loss

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        return self.image_encoder(image)

    def encode_text(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.text_encoder(batch)

    def project_image(self, features: torch.Tensor) -> torch.Tensor:
        return self.loss.project_image(features)

    def project_text(self, features: torch.Tensor) -> torch.Tensor:
        return self.loss.project_text(features)
