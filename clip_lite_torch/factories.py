"""Factories: build the port's components from a :class:`Config`, as the
JAX package's ``factories.py`` does for its own."""

from __future__ import annotations

import torch

from clip_lite_torch.config import Config
from clip_lite_torch.ops.layers import DTYPES


def compute_dtype(config: Config) -> torch.dtype:
    """DTYPE under AMP, float32 otherwise."""
    return DTYPES[config.DTYPE] if config.AMP else torch.float32


class VisualBackboneFactory:
    @classmethod
    def from_config(cls, config: Config):
        from clip_lite_torch.models.image_encoder import ImageEncoder

        _C = config
        return ImageEncoder(
            img_enc_net=_C.MODEL.VISUAL.NETWORK_NAME,
            frozen=_C.MODEL.VISUAL.FROZEN,
            compute_dtype=compute_dtype(_C),
            bn_mode=_C.MODEL.VISUAL.BN_MODE,
            width=_C.MODEL.VISUAL.WIDTH,
        )


class TextualHeadFactory:
    @classmethod
    def from_config(cls, config: Config):
        from clip_lite_torch.models.text_encoder import TextEncoder

        _C = config
        return TextEncoder(
            mode=_C.MODEL.TEXTUAL.NAME,
            transform_embedding=_C.MODEL.TEXTUAL.TRANSFORM,
            model_name=_C.MODEL.TEXTUAL.NETWORK_NAME,
            num_hidden_layers=_C.MODEL.TEXTUAL.NUM_HIDDEN_LAYERS,
            vocab_size=_C.MODEL.TEXTUAL.VOCAB_SIZE,
            compute_dtype=compute_dtype(_C),
            fused_attention=_C.MODEL.TEXTUAL.FUSED_ATTENTION,
            transformer_dropout=_C.MODEL.TEXTUAL.DROPOUT,
            hidden_size=_C.MODEL.TEXTUAL.HIDDEN_SIZE,
        )


class LossFactory:
    @classmethod
    def from_config(cls, config: Config, image_dim: int, text_dim: int):
        """``image_dim``/``text_dim`` are the towers' feature sizes; the
        heads' input widths follow them, whatever FEATURE_SIZE says."""
        from clip_lite_torch.ops.loss import JSDInfoMaxLoss

        _C = config
        if _C.MODEL.LOSS.NAME != "jsd":
            raise KeyError(f"Unknown loss {_C.MODEL.LOSS.NAME!r}")
        return JSDInfoMaxLoss(
            image_dim=image_dim,
            text_dim=text_dim,
            critic_type=_C.MODEL.LOSS.TYPE,
            image_prior=_C.MODEL.LOSS.IMAGE_PRIOR,
            text_prior=_C.MODEL.LOSS.TEXT_PRIOR,
            visual_self_supervised=_C.MODEL.VISUAL.SELF_SUPERVISED,
            textual_self_supervised=_C.MODEL.TEXTUAL.SELF_SUPERVISED,
            compute_dtype=compute_dtype(_C),
        )


class PretrainingModelFactory:
    @classmethod
    def from_config(cls, config: Config):
        from clip_lite_torch.models.model import VLInfoModel

        image = VisualBackboneFactory.from_config(config)
        text = TextualHeadFactory.from_config(config)
        return VLInfoModel(
            image_encoder=image,
            text_encoder=text,
            loss=LossFactory.from_config(config, image.feature_size,
                                         text.feature_size),
        )


class TokenizerFactory:
    @classmethod
    def from_config(cls, config: Config):
        from clip_lite_torch.data.tokenizers import get_hf_tokenizer

        _C = config
        if _C.MODEL.TEXTUAL.NAME == "glove":
            raise NotImplementedError(
                "the GloVe tokenizer lands with the glove text mode (ROADMAP "
                "Queue 1, the rest of the model matrix)")
        return get_hf_tokenizer(_C.MODEL.TEXTUAL.NETWORK_NAME,
                                max_length=_C.DATA.MAX_CAPTION_LENGTH,
                                vocab_size=_C.MODEL.TEXTUAL.VOCAB_SIZE)
