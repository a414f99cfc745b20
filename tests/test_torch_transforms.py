"""The port's host transforms (clip_lite_torch/data/transforms.py) against
the JAX package's (clip_lite_tpu/data/transforms.py), which use OpenCV:
every entry of ``TRANSFORM_PRODUCTS``, ``DEFAULT_IMAGE_TRANSFORM`` and the
configs' pipelines, given the same generator state, give JAX's image
within one grey level (normalized: 1 / (255 * 0.224)), the same caption,
and leave the generator in JAX's state, so that later draws stay in step.
Also ``pre_caption`` and ``NormalizeCaption`` on unicode and punctuation.
"""

import glob
import os

import numpy as np
import pytest

from clip_lite_tpu.config import Config as JConfig
from clip_lite_tpu.data import transforms as JT
from clip_lite_tpu.factories import _build_transform_pipeline as j_build
from clip_lite_torch.config import Config
from clip_lite_torch.data import transforms as T
from clip_lite_torch.factories import ImageTransformsFactory
from clip_lite_torch.factories import _build_transform_pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP = 32
SEEDS = range(12)  # enough that every p < 1 transform both acts and not
CAPTION = "A man on the left, a dog at right; bright-left light"
# One grey level, after Normalize at its smallest std.
LEVEL = 1.0 / (255 * min(T.IMAGENET_COLOR_STD)) * (1 + 1e-6)


def _image(seed, h=48, w=64):
    return np.random.default_rng(100 + seed).integers(0, 256, (h, w, 3),
                                                      dtype=np.uint8)


def _same(ours, theirs, ours_rng, theirs_rng):
    assert ours.keys() == theirs.keys()
    assert ours.get("caption") == theirs.get("caption")
    a, b = np.asarray(ours["image"]), np.asarray(theirs["image"])
    assert a.shape == b.shape and a.dtype == b.dtype
    tol = LEVEL if a.dtype == np.float32 else 1
    assert np.abs(a.astype(np.float64) - b.astype(np.float64)).max() <= tol
    assert ours_rng.bit_generator.state == theirs_rng.bit_generator.state


def _run(transform, jax_transform, seed, image):
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    sample = {"image": image, "caption": CAPTION}
    return (transform(dict(sample), rng), jax_transform(dict(sample), jrng),
            rng, jrng)


@pytest.mark.parametrize("name", sorted(JT.TRANSFORM_PRODUCTS))
def test_each_product_matches_jax(name):
    assert sorted(T.TRANSFORM_PRODUCTS) == sorted(JT.TRANSFORM_PRODUCTS)
    args = (CROP,) if "resize" in name or "crop" in name else ()
    acted = set()
    for seed in SEEDS:
        for shape in ((48, 64), (64, 48), (20, 27)):
            image = _image(seed, *shape)
            ours, theirs, rng, jrng = _run(T.TRANSFORM_PRODUCTS[name](*args),
                                           JT.TRANSFORM_PRODUCTS[name](*args),
                                           seed, image)
            _same(ours, theirs, rng, jrng)
            acted.add(ours["image"] is not image)
    assert acted == {True} or (acted == {True, False}
                               and T.TRANSFORM_PRODUCTS[name](*args).p < 1)


@pytest.mark.parametrize("spec", ["random_resized_crop::{'scale': (0.5, 1.0)}",
                                  "color_jitter::{'hue': 0, 'p': 1.0}",
                                  "horizontal_flip::{'p': 1.0}",
                                  "blur::{'p': 1.0}"])
def test_inline_kwargs(spec):
    from clip_lite_tpu.factories import ImageTransformsFactory as JFactory

    args = (CROP,) if "crop" in spec else ()
    for seed in SEEDS:
        _same(*_run(ImageTransformsFactory.create(spec, *args),
                    JFactory.create(spec, *args), seed, _image(seed)))


def test_unknown_transform_raises():
    with pytest.raises(KeyError, match="cannot create"):
        ImageTransformsFactory.create("solarize")


def test_default_image_transform_matches_jax():
    for seed in range(3):
        rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
        image = _image(seed, 300, 260)
        ours = T.DEFAULT_IMAGE_TRANSFORM(image=image, rng=rng)
        theirs = JT.DEFAULT_IMAGE_TRANSFORM(image=image, rng=jrng)
        assert ours["image"].shape == (224, 224, 3)
        _same(ours, theirs, rng, jrng)


@pytest.mark.parametrize("path", sorted(
    glob.glob(os.path.join(ROOT, "configs", "*.yaml"))),
    ids=os.path.basename)
@pytest.mark.parametrize("split", ["train", "val"])
def test_config_pipelines_match_jax(path, split):
    overrides = ["DATA.IMAGE_CROP_SIZE", CROP]
    ours = _build_transform_pipeline(Config(path, overrides), split)
    theirs = j_build(JConfig(path, overrides), split)
    for seed in range(4):
        rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
        image = _image(seed, 60, 45)
        _same(ours(image=image, caption=CAPTION, rng=rng),
              theirs(image=image, caption=CAPTION, rng=jrng), rng, jrng)


CAPTIONS = [
    "A Man's dog -- running!!  on the beach...",
    "Café crème / naïve résumé; señor's piñata",
    "two <person> riding: a bus (red) #1 ~ near \"home\"",
    "\tTabs\nand newlines\n",
    "ＦＵＬＬ width ｌｅｔｔｅｒｓ and ligature ﬁ",
    "Ångström Øre ß ǅ",
    "one two three four five six seven eight nine ten eleven twelve",
    "",
    "left right lefty righteous",
]


@pytest.mark.parametrize("max_words", [30, 5])
def test_pre_caption_and_normalize_caption_match_jax(max_words):
    rng = np.random.default_rng(0)
    for c in CAPTIONS:
        assert T.pre_caption(c, max_words) == JT.pre_caption(c, max_words)
        ours = T.NormalizeCaption(max_words)({"caption": c}, rng)
        assert ours == JT.NormalizeCaption(max_words)({"caption": c}, rng)


def test_tokenize_and_truncate_caption_match_jax():
    class Words:
        """A tokenizer with the GloVe tokenizer's interface."""

        def encode(self, text):
            return [len(w) for w in text.split()]

        def token_to_id(self, token):
            return {"<start>": 1, "<eos>": 2}[token]

    rng = np.random.default_rng(0)
    for c in CAPTIONS:
        sample = {"caption": c}
        ours = T.TokenizeCaption(Words())(sample, rng)
        assert ours == JT.TokenizeCaption(Words())(sample, rng)
        assert T.TruncateCaptionTokens(4)(ours, rng) == \
            JT.TruncateCaptionTokens(4)(ours, rng)
