"""Factories: build the port's components from a :class:`Config`, as the
JAX package's ``factories.py`` does for its own."""

from __future__ import annotations

import ast

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
            txt_enc_dim=_C.MODEL.TEXTUAL.FEATURE_SIZE,
            model_name=_C.MODEL.TEXTUAL.NETWORK_NAME,
            num_hidden_layers=_C.MODEL.TEXTUAL.NUM_HIDDEN_LAYERS,
            vocab_size=_C.MODEL.TEXTUAL.VOCAB_SIZE,
            compute_dtype=compute_dtype(_C),
            fused_attention=_C.MODEL.TEXTUAL.FUSED_ATTENTION,
            transformer_dropout=_C.MODEL.TEXTUAL.DROPOUT,
            hidden_size=_C.MODEL.TEXTUAL.HIDDEN_SIZE,
            train_embeddings=_C.MODEL.TEXTUAL.TRAIN_EMBEDDINGS,
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
            prior_weight=_C.MODEL.LOSS.PRIOR_WEIGHT,
            image_prior=_C.MODEL.LOSS.IMAGE_PRIOR,
            text_prior=_C.MODEL.LOSS.TEXT_PRIOR,
            visual_self_supervised=_C.MODEL.VISUAL.SELF_SUPERVISED,
            textual_self_supervised=_C.MODEL.TEXTUAL.SELF_SUPERVISED,
            negatives=_C.MODEL.LOSS.NEGATIVES,
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


class OptimizerFactory:
    """The fused update over ``model``'s parameters
    (:mod:`clip_lite_torch.optim.fused`), or under ``PARALLEL.ZERO1`` over
    more than one rank its sharded form (:mod:`clip_lite_torch.parallel.
    zero1`).  ``OPTIM.FUSED`` false selects
    the JAX package's optax chain, which computes the same update
    (``tests/test_optim.py::test_fused_matches_chain``); the port has the
    fused form only."""

    @classmethod
    def from_config(cls, config: Config, model):
        from clip_lite_torch.optim.fused import FusedOptimizer
        from clip_lite_torch.parallel.collectives import world_size
        from clip_lite_torch.parallel.zero1 import Zero1Optimizer

        # ZeRO-1 over more than one rank; on one the replicated update, as
        # the JAX CLI chooses (its train.py:164-167).
        cls_ = Zero1Optimizer if config.PARALLEL.ZERO1 and world_size() > 1 \
            else FusedOptimizer
        return cls_(model, config, LRSchedulerFactory.from_config(config))


class LRSchedulerFactory:
    """The warmup + decay multiplier schedule of ``OPTIM.LR_DECAY_NAME``."""

    @classmethod
    def from_config(cls, config: Config):
        from clip_lite_torch.optim.schedules import SCHEDULES

        _C = config
        kwargs = dict(total_steps=_C.OPTIM.NUM_ITERATIONS,
                      warmup_steps=_C.OPTIM.WARMUP_STEPS)
        name = _C.OPTIM.LR_DECAY_NAME
        if name == "multistep":
            kwargs.update(gamma=_C.OPTIM.LR_GAMMA,
                          milestones=list(_C.OPTIM.LR_STEPS))
        if name == "cosine":
            kwargs.update(min_mult=_C.OPTIM.MIN_LR_MULT)
        if name not in SCHEDULES:
            raise KeyError(f"Unknown LR schedule {name!r}")
        return SCHEDULES[name](**kwargs)


class TokenizerFactory:
    @classmethod
    def from_config(cls, config: Config):
        from clip_lite_torch.data.tokenizers import (
            GloveTokenizer,
            get_hf_tokenizer,
        )

        _C = config
        if _C.MODEL.TEXTUAL.NAME == "glove":
            return GloveTokenizer(_C.MODEL.TEXTUAL.WORD_DICT_PATH)
        return get_hf_tokenizer(_C.MODEL.TEXTUAL.NETWORK_NAME,
                                max_length=_C.DATA.MAX_CAPTION_LENGTH,
                                vocab_size=_C.MODEL.TEXTUAL.VOCAB_SIZE)


class ImageTransformsFactory:
    """Host image transforms by name, with the ``name::{'kw': v}`` syntax
    for inline keyword arguments (a Python literal)."""

    @classmethod
    def create(cls, name: str, *args, **kwargs):
        from clip_lite_torch.data.transforms import TRANSFORM_PRODUCTS

        _kwargs = {}
        if "::" in name:
            name, raw = name.split("::")
            _kwargs = ast.literal_eval(raw)
        _kwargs.update(kwargs)
        if name not in TRANSFORM_PRODUCTS:
            raise KeyError(f"ImageTransformsFactory cannot create {name!r}. "
                           f"Choices: {sorted(TRANSFORM_PRODUCTS)}")
        return TRANSFORM_PRODUCTS[name](*args, **_kwargs)


def _build_transform_pipeline(config: Config, split: str):
    """DATA.IMAGE_TRANSFORM_TRAIN (or _VAL) as one Compose; the resizes
    and crops take DATA.IMAGE_CROP_SIZE."""
    from clip_lite_torch.data.transforms import Compose

    _C = config
    names = (_C.DATA.IMAGE_TRANSFORM_TRAIN if split == "train"
             else _C.DATA.IMAGE_TRANSFORM_VAL)
    tlist = []
    for name in names:
        base = name.split("::")[0]
        if "resize" in base or "crop" in base:
            tlist.append(ImageTransformsFactory.create(
                name, _C.DATA.IMAGE_CROP_SIZE))
        else:
            tlist.append(ImageTransformsFactory.create(name))
    return Compose(tlist)


class PretrainingDatasetFactory:
    """The pretraining dataset of MODEL.NAME: ``captions`` (CLRec records;
    with DATA.NATIVE_PIPELINE its batches are decoded on ``device``),
    ``random``, or ``json`` (DATA.JSON_FILES_TRAIN or _VAL, the val split
    at half its entries, as in the JAX package), in the text mode
    DATA.NAME; the glove mode's word dictionary is
    MODEL.TEXTUAL.WORD_DICT_PATH."""

    @classmethod
    def from_config(cls, config: Config, split: str = "train",
                    device="cuda"):
        from clip_lite_torch.data import datasets

        _C = config
        products = {"captions": datasets.CocoCaptionsDataset,
                    "random": datasets.RandomDataset,
                    "json": datasets.JsonDataset}
        name = _C.MODEL.NAME
        if name not in products:
            raise KeyError(f"Unknown pretraining dataset {name!r}")
        kwargs = dict(
            data_root=_C.DATA.ROOT,
            split=split,
            mode=_C.DATA.NAME,
            tokenizer_name=_C.MODEL.TEXTUAL.NETWORK_NAME,
            vocab_size=_C.MODEL.TEXTUAL.VOCAB_SIZE,
            seq_buckets=list(_C.DATA.SEQ_BUCKETS),
            use_single_caption=_C.DATA.USE_SINGLE_CAPTION,
            visual_self_supervised=_C.MODEL.VISUAL.SELF_SUPERVISED,
            textual_self_supervised=_C.MODEL.TEXTUAL.SELF_SUPERVISED,
            percentage=_C.DATA.USE_PERCENTAGE,
            max_caption_length=_C.DATA.MAX_CAPTION_LENGTH,
            image_transform=_build_transform_pipeline(_C, split),
            # The JAX factory drops this, so that its glove items are all
            # <unk> (ROADMAP Queue 3).
            word_dict_path=_C.MODEL.TEXTUAL.WORD_DICT_PATH,
        )
        if name == "captions":
            kwargs["native_pipeline"] = _C.DATA.NATIVE_PIPELINE
            kwargs["crop_size"] = _C.DATA.IMAGE_CROP_SIZE
            kwargs["device"] = device
        if name == "json":
            json_files = list(_C.DATA.JSON_FILES_TRAIN if split == "train"
                              else _C.DATA.JSON_FILES_VAL)
            if split == "val":
                kwargs["percentage"] = 50.0
            return products[name](json_files, **kwargs)
        return products[name](**kwargs)


class NegativeSamplingDatasetFactory:
    """The clustered hard-negative dataset of DATA.NEGATIVE_SAMPLING
    ``clusters``: DATA.CLUSTER_PATH's cluster maps over DATA.ROOT's CLRec
    split, negatives' images under DATA.COCO_ROOT, the number of clusters
    scheduled from DATA.NEGATIVE_SAMPLING_START_ITERATION to
    OPTIM.NUM_ITERATIONS.  As in the JAX package it takes no
    DATA.SEQ_BUCKETS: its captions keep DATA.MAX_CAPTION_LENGTH."""

    @classmethod
    def from_config(cls, config: Config, split: str = "train"):
        from clip_lite_torch.data import datasets

        _C = config
        if _C.DATA.NEGATIVE_SAMPLING != "clusters":
            raise KeyError(
                f"Unknown negative sampling {_C.DATA.NEGATIVE_SAMPLING!r}")
        return datasets.CocoCaptionsClusteredDataset(
            data_root=_C.DATA.ROOT,
            split=split,
            mode=_C.DATA.NAME,
            tokenizer_name=_C.MODEL.TEXTUAL.NETWORK_NAME,
            vocab_size=_C.MODEL.TEXTUAL.VOCAB_SIZE,
            total_iters=_C.OPTIM.NUM_ITERATIONS,
            negative_sampling_start_iter=(
                _C.DATA.NEGATIVE_SAMPLING_START_ITERATION),
            cluster_path=_C.DATA.CLUSTER_PATH,
            use_single_caption=_C.DATA.USE_SINGLE_CAPTION,
            coco_root=_C.DATA.COCO_ROOT,
            max_caption_length=_C.DATA.MAX_CAPTION_LENGTH,
            image_transform=_build_transform_pipeline(_C, split),
        )


class DownstreamDatasetFactory:
    """The downstream eval dataset of DATA.ROOT, keyed on its trailing
    directory name (``VOC2007``, ``imagenet``, ``imagenet2012``,
    ``inaturalist``, ``coco``, ``flickr30k``, ``coco_gender``), with
    DATA.IMAGE_TRANSFORM_TRAIN for a split whose name holds ``train``
    (VOC's ``trainval`` too) and _VAL otherwise."""

    @classmethod
    def products(cls) -> dict:
        from clip_lite_torch.data import datasets

        return {
            "VOC2007": datasets.VOC07ClassificationDataset,
            "imagenet": datasets.ImageNetDataset,
            "imagenet2012": datasets.ImageNetDataset,
            "inaturalist": datasets.INaturalist2018Dataset,
            "coco": datasets.ReEvalDataset,
            "flickr30k": datasets.FlickrReEvalDataset,
            "coco_gender": datasets.CocoObjectGender,
        }

    @classmethod
    def from_config(cls, config: Config, split: str = "train"):
        import os

        _C = config
        key = os.path.basename(os.path.normpath(_C.DATA.ROOT))
        products = cls.products()
        if key not in products:
            raise KeyError(
                f"DownstreamDatasetFactory: no dataset registered for path "
                f"{_C.DATA.ROOT!r} (key {key!r}). Choices: {sorted(products)}")
        kwargs = dict(
            data_root=_C.DATA.ROOT, split=split,
            image_transform=_build_transform_pipeline(
                _C, "train" if "train" in split else "val"))
        if key == "flickr30k":
            kwargs["ann_file"] = os.path.join(_C.DATA.ROOT,
                                              "data/flickr30k_test.json")
        return products[key](**kwargs)
