"""Host-side image and caption transforms, the counterpart of the JAX
package's ``data/transforms.py``: square crops, smallest-edge resize,
colour jitter, the caption-aware horizontal flip (left <-> right),
caption cleanup, tokenization and truncation, on numpy arrays.

Each transform draws from the caller's ``np.random.Generator`` in the JAX
package's order, and the image operations are
:mod:`clip_lite_torch.data.imgproc`'s (OpenCV's 8-bit rules, without
OpenCV), so for the same generator state a transform gives the JAX
package's output and leaves the generator in the same state.  Images stay
HWC uint8 until ``Normalize``, which gives float32.  ``BlackoutBox`` and
``BlurBox`` mask the person boxes of the bias analysis's dataset.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Any, Callable, Dict, Sequence

import numpy as np

from clip_lite_torch.data import imgproc

IMAGENET_COLOR_MEAN = (0.485, 0.456, 0.406)
IMAGENET_COLOR_STD = (0.229, 0.224, 0.225)


class Transform:
    """Base: a transform maps a sample dict (``image``/``caption`` keys)
    to a new dict, drawing from an explicit generator; with probability
    ``p`` (one draw when ``p < 1``) it applies."""

    p: float = 1.0

    def __call__(self, sample: Dict[str, Any],
                 rng: np.random.Generator) -> Dict[str, Any]:
        if self.p >= 1.0 or rng.random() < self.p:
            return self.apply(sample, rng)
        return sample

    def apply(self, sample, rng):
        raise NotImplementedError


class Compose:
    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)

    def __call__(self, rng: np.random.Generator = None, **sample):
        if rng is None:
            rng = np.random.default_rng()
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


# ---------------------------------------------------------------------------
# Caption transforms
# ---------------------------------------------------------------------------

def pre_caption(caption: str, max_words: int = 30) -> str:
    """Lowercase, strip punctuation, split hyphens and slashes, collapse
    spaces, keep the first ``max_words`` words."""
    caption = re.sub(r"([,.'!?\"()*#:;~])", "", caption.lower())
    caption = caption.replace("-", " ").replace("/", " ").replace(
        "<person>", "person")
    caption = re.sub(r"\s{2,}", " ", caption).rstrip("\n").strip(" ")
    words = caption.split(" ")
    if len(words) > max_words:
        caption = " ".join(words[:max_words])
    return caption


class NormalizeCaption(Transform):
    """``pre_caption``, then NFKD with the combining marks (accents)
    dropped."""

    def __init__(self, max_caption_length: int = 30):
        self.max_caption_length = max_caption_length

    def apply(self, sample, rng):
        caption = pre_caption(sample["caption"], self.max_caption_length)
        caption = unicodedata.normalize("NFKD", caption.lower())
        caption = "".join(c for c in caption if not unicodedata.combining(c))
        return {**sample, "caption": caption}


class TokenizeCaption(Transform):
    """str -> List[int] between <start> and <eos>."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer

    def apply(self, sample, rng):
        ids = self.tokenizer.encode(sample["caption"])
        ids.insert(0, self.tokenizer.token_to_id("<start>"))
        ids.append(self.tokenizer.token_to_id("<eos>"))
        return {**sample, "caption": ids}


class TruncateCaptionTokens(Transform):
    def __init__(self, max_caption_length: int = 30):
        self.max_caption_length = max_caption_length

    def apply(self, sample, rng):
        return {**sample, "caption": sample["caption"][: self.max_caption_length]}


# ---------------------------------------------------------------------------
# Image transforms
# ---------------------------------------------------------------------------

class HorizontalFlip(Transform):
    """Flip the image; swap 'left' and 'right' in a str caption."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def apply(self, sample, rng):
        out = dict(sample)
        out["image"] = np.ascontiguousarray(sample["image"][:, ::-1])
        if "caption" in sample and isinstance(sample["caption"], str):
            out["caption"] = (sample["caption"]
                              .replace("left", "[TMP]")
                              .replace("right", "left")
                              .replace("[TMP]", "right"))
        return out


class RandomResizedSquareCrop(Transform):
    """A crop of random area and aspect (up to 10 tries, then the centre
    square), resized to ``size`` x ``size``."""

    def __init__(self, size: int, scale=(0.2, 1.0), ratio=(0.75, 4 / 3),
                 p: float = 1.0):
        self.size = size
        self.scale = scale
        self.ratio = ratio
        self.p = p

    def apply(self, sample, rng):
        img = sample["image"]
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = rng.uniform(*self.scale) * area
            log_ratio = (np.log(self.ratio[0]), np.log(self.ratio[1]))
            aspect = np.exp(rng.uniform(*log_ratio))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                x0 = rng.integers(0, w - cw + 1)
                y0 = rng.integers(0, h - ch + 1)
                crop = img[y0:y0 + ch, x0:x0 + cw]
                return {**sample, "image": imgproc.resize_linear(
                    crop, self.size, self.size)}
        s = min(h, w)
        y0, x0 = (h - s) // 2, (w - s) // 2
        crop = img[y0:y0 + s, x0:x0 + s]
        return {**sample,
                "image": imgproc.resize_linear(crop, self.size, self.size)}


class CenterSquareCrop(Transform):
    """The centre ``size`` square, after an upscale if an edge is
    shorter."""

    def __init__(self, size: int, p: float = 1.0):
        self.size = size
        self.p = p

    def apply(self, sample, rng):
        img = sample["image"]
        h, w = img.shape[:2]
        s = self.size
        if h < s or w < s:
            scale = s / min(h, w)
            img = imgproc.resize_linear(img, max(s, int(round(w * scale))),
                                        max(s, int(round(h * scale))))
            h, w = img.shape[:2]
        y0, x0 = (h - s) // 2, (w - s) // 2
        return {**sample, "image": img[y0:y0 + s, x0:x0 + s]}


class SmallestMaxSize(Transform):
    """Resize so that the shorter edge is ``size``."""

    def __init__(self, size: int = 256, p: float = 1.0):
        self.size = size
        self.p = p

    def apply(self, sample, rng):
        img = sample["image"]
        h, w = img.shape[:2]
        scale = self.size / min(h, w)
        return {**sample, "image": imgproc.resize_linear(
            img, int(round(w * scale)), int(round(h * scale)))}


class SquareResize(Transform):
    def __init__(self, size: int, p: float = 1.0):
        self.size = size
        self.p = p

    def apply(self, sample, rng):
        return {**sample, "image": imgproc.resize_linear(
            sample["image"], self.size, self.size)}


class ColorJitter(Transform):
    """Brightness, contrast and saturation as float32 factors, then the
    hue shifted in 8-bit HSV; a factor of 0 draws nothing."""

    def __init__(self, brightness=0.4, contrast=0.4, saturation=0.4,
                 hue=0.1, p: float = 0.8):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.p = p

    def apply(self, sample, rng):
        img = sample["image"].astype(np.float32)
        if self.brightness:
            img = img * rng.uniform(1 - self.brightness, 1 + self.brightness)
        if self.contrast:
            mean = img.mean()
            img = (img - mean) * rng.uniform(
                1 - self.contrast, 1 + self.contrast) + mean
        if self.saturation:
            gray = img @ np.asarray([0.299, 0.587, 0.114], np.float32)
            f = rng.uniform(1 - self.saturation, 1 + self.saturation)
            img = img * f + gray[..., None] * (1 - f)
        img = np.clip(img, 0, 255).astype(np.uint8)
        if self.hue:
            hsv = imgproc.rgb_to_hsv(img)
            shift = rng.uniform(-self.hue, self.hue) * 180
            hsv[..., 0] = (hsv[..., 0].astype(np.int32) + int(shift)) % 180
            img = imgproc.hsv_to_rgb(hsv)
        return {**sample, "image": img}


class ToGray(Transform):
    def __init__(self, p: float = 0.2):
        self.p = p

    def apply(self, sample, rng):
        g = imgproc.rgb_to_gray(sample["image"])
        return {**sample, "image": np.repeat(g[..., None], 3, axis=-1)}


class GaussianBlur(Transform):
    def __init__(self, p: float = 0.5, ksize: int = 5):
        self.p = p
        self.ksize = ksize

    def apply(self, sample, rng):
        sigma = rng.uniform(0.1, 2.0)
        return {**sample, "image": imgproc.gaussian_blur(
            sample["image"], self.ksize, sigma)}


class Normalize(Transform):
    """uint8 [0, 255] HWC -> float32, normalized by the ImageNet
    statistics."""

    def __init__(self, mean=IMAGENET_COLOR_MEAN, std=IMAGENET_COLOR_STD,
                 p: float = 1.0):
        self.mean = np.asarray(mean, np.float32) * 255.0
        self.std = np.asarray(std, np.float32) * 255.0
        self.p = p

    def apply(self, sample, rng):
        img = sample["image"].astype(np.float32)
        return {**sample, "image": (img - self.mean) / self.std}


class BlackoutBox(Transform):
    """Zero every ``[x0, y0, x1, y1]`` box of ``sample["boxes"]``."""

    def apply(self, sample, rng):
        img = sample["image"].copy()
        for (x0, y0, x1, y1) in sample.get("boxes", []):
            img[int(y0):int(y1), int(x0):int(x1)] = 0
        return {**sample, "image": img}


class BlurBox(Transform):
    """Blur every box of ``sample["boxes"]`` with a 31-tap Gaussian of
    sigma 15, the box alone: its border reflects about the box's own edge
    pixels (OpenCV's rule for an array view), however narrow the box."""

    def apply(self, sample, rng):
        img = sample["image"].copy()
        for (x0, y0, x1, y1) in sample.get("boxes", []):
            region = img[int(y0):int(y1), int(x0):int(x1)]
            if region.size:
                img[int(y0):int(y1), int(x0):int(x1)] = imgproc.gaussian_blur(
                    region, 31, 15)
        return {**sample, "image": img}


# The names ImageTransformsFactory creates (the JAX package's registry).
TRANSFORM_PRODUCTS: Dict[str, Callable] = {
    "random_resized_crop": lambda size, **kw: RandomResizedSquareCrop(
        size, scale=kw.pop("scale", (0.2, 1.0)),
        ratio=kw.pop("ratio", (0.75, 4 / 3)), p=kw.pop("p", 1.0)),
    "center_crop": lambda size, **kw: CenterSquareCrop(size, **kw),
    "smallest_resize": lambda size=256, **kw: SmallestMaxSize(size, **kw),
    "global_resize": lambda size, **kw: SquareResize(size, **kw),
    "color_jitter": lambda **kw: ColorJitter(
        brightness=kw.pop("brightness", 0.4), contrast=kw.pop("contrast", 0.4),
        saturation=kw.pop("saturation", 0.4), hue=kw.pop("hue", 0.1),
        p=kw.pop("p", 0.8)),
    "color_jitter8": lambda **kw: ColorJitter(
        brightness=0.8, contrast=0.8, saturation=0.8, hue=0.1,
        p=kw.pop("p", 0.8)),
    "random_gray": lambda **kw: ToGray(p=kw.pop("p", 0.2)),
    "horizontal_flip": lambda **kw: HorizontalFlip(p=kw.pop("p", 0.5)),
    "blur": lambda **kw: GaussianBlur(p=kw.pop("p", 0.5)),
    "normalize": lambda **kw: Normalize(**kw),
}

DEFAULT_IMAGE_TRANSFORM = Compose([
    SmallestMaxSize(256),
    CenterSquareCrop(224),
    Normalize(),
])

__all__ = ["BlackoutBox", "BlurBox", "CenterSquareCrop", "ColorJitter",
           "Compose", "DEFAULT_IMAGE_TRANSFORM", "GaussianBlur", "HorizontalFlip",
           "IMAGENET_COLOR_MEAN", "IMAGENET_COLOR_STD", "Normalize",
           "NormalizeCaption", "RandomResizedSquareCrop", "SmallestMaxSize",
           "SquareResize", "TRANSFORM_PRODUCTS", "ToGray", "TokenizeCaption",
           "Transform", "TruncateCaptionTokens", "pre_caption"]
