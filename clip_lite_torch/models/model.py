"""VLInfoModel: the image tower, the text tower and the JSD loss, with
the training forward (the loss dict, the hard negatives' passes and the
augmented views' passes for the SSL terms included) and the encoding and
projection API the downstream evals use.  The forward opens the ``image_encoder``, ``text_encoder`` and
``loss`` ranges of a step's trace (``utils/trace.py``)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from clip_lite_torch.models.image_encoder import ImageEncoder
from clip_lite_torch.models.text_encoder import TextEncoder
from clip_lite_torch.ops.layers import StepRNG
from clip_lite_torch.ops.loss import JSDInfoMaxLoss
from clip_lite_torch.utils.trace import scope


class VLInfoModel(nn.Module):
    def __init__(self, image_encoder: ImageEncoder, text_encoder: TextEncoder,
                 loss: JSDInfoMaxLoss):
        super().__init__()
        self.image_encoder = image_encoder
        self.text_encoder = text_encoder
        self.loss = loss

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[StepRNG] = None,
                prior_noise: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, Any]:
        """``{"loss", "loss_components"}`` for a batch of ``image``
        (B, H, W, 3) and the text tower's input (``input_ids`` and
        ``attention_mask`` (B, L); ``caption_tokens`` (B, L) in the glove
        mode; ``caption_encodings`` (B, 768) in the sbert mode), the
        components detached (``models/model.py:29-70`` of the JAX
        package).  In the ``train_sbert`` mode only, after the pair, a
        ``neg_image`` goes through the image tower and ``neg_input_ids``/``neg_attention_mask`` through the text
        tower (the cluster curriculum's hard negatives), then an
        ``aug_image`` and ``aug_input_ids``/``aug_attention_mask`` (the SSL
        views), in that order; in training each pass moves the image
        tower's BatchNorm statistics, as flax moves them.
        Norms and dropout follow the module's training mode; ``rng`` is the
        step's draws, ``prior_noise`` an optional replacement for the prior
        terms' noise."""
        with scope("image_encoder"):
            image_features = self.image_encoder(batch["image"], rng=rng)
        with scope("text_encoder"):
            text_features = self.text_encoder(batch, rng=rng)
        neg_image_features = neg_text_features = None
        aug_image_features = aug_text_features = None
        if self.text_encoder.mode != "train_sbert":
            batch = {}  # as in the JAX model, no negatives or views here
        if "neg_input_ids" in batch:
            with scope("image_encoder"):
                neg_image_features = self.image_encoder(batch["neg_image"],
                                                        rng=rng)
            with scope("text_encoder"):
                neg_text_features = self.text_encoder(
                    {"input_ids": batch["neg_input_ids"],
                     "attention_mask": batch["neg_attention_mask"]}, rng=rng)
        if "aug_image" in batch:
            with scope("image_encoder"):
                aug_image_features = self.image_encoder(batch["aug_image"],
                                                        rng=rng)
        if "aug_input_ids" in batch:
            with scope("text_encoder"):
                aug_text_features = self.text_encoder(
                    {"input_ids": batch["aug_input_ids"],
                     "attention_mask": batch["aug_attention_mask"]}, rng=rng)
        with scope("loss"):
            components = self.loss(image_features, text_features,
                                   neg_image_features=neg_image_features,
                                   neg_text_features=neg_text_features,
                                   aug_image_features=aug_image_features,
                                   aug_text_features=aug_text_features,
                                   prior_noise=prior_noise, rng=rng)
        return {"loss": components["total_loss"],
                "loss_components": {k: v.detach()
                                    for k, v in components.items()}}

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        return self.image_encoder(image)

    def encode_text(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.text_encoder(batch)

    def project_image(self, features: torch.Tensor) -> torch.Tensor:
        return self.loss.project_image(features)

    def project_text(self, features: torch.Tensor) -> torch.Tensor:
        return self.loss.project_text(features)
