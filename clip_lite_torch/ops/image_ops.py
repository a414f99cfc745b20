"""On-device image preprocessing: uint8 batches in, normalized tensors out,
the counterpart of the JAX package's ``ops/image_ops.py:31-145``.

The host ships uint8 crops and the step finishes augmentation on the
card: per-image random horizontal flip, colour jitter (brightness,
contrast, saturation, and hue by an exact HSV round trip, applied with
p = 0.8), then the ImageNet normalize.  On the card all three are one pass
of K3 (:func:`~clip_lite_torch.ops.normalize.augment_normalize_u8`), as
XLA fuses them into one in the JAX step; the functions below are its plain
twin, which CPU tensors take.  The twin divides by 255 and by 6 as a
product with the fp32 reciprocal, which is what eager PyTorch computes on
the card for a division by a Python scalar, so that the CPU and the card
round alike.

Every random draw of a batch lives in one :class:`AugDraws` (one entry
per image), drawn from the step's :class:`StepRNG` or passed in by the
caller (the parity tests pass the JAX package's draws).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from clip_lite_torch.ops.layers import StepRNG
from clip_lite_torch.ops.normalize import (
    augment_normalize_u8,
    normalize_reference,
    normalize_u8,
)

GRAY_WEIGHTS = (0.299, 0.587, 0.114)
# The JAX package's jitter defaults (image_ops.py:99-102).
BRIGHTNESS = CONTRAST = SATURATION = 0.4
HUE = 0.1
JITTER_P = 0.8
INV_255 = 1.0 / 255.0  # torch rounds a Python scalar factor to fp32
INV_6 = 1.0 / 6.0


@dataclass
class AugDraws:
    """One batch's augmentation draws, each of shape (B,): ``flip`` and
    ``apply`` (colour jitter on) are bool, the rest float32 factors."""

    flip: torch.Tensor
    apply: torch.Tensor
    brightness: torch.Tensor
    contrast: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor

    @classmethod
    def sample(cls, rng: StepRNG, batch: int) -> "AugDraws":
        """The laws of ``image_ops.py:46, 93, 109-121, 131`` of the JAX
        package at its defaults: flip ~ Bernoulli(0.5), apply ~
        Bernoulli(JITTER_P), the three factors ~ U[1 - f, 1 + f), the hue
        shift ~ U[-HUE, HUE)."""
        u = rng.augment_uniform((6, batch))

        def between(row, lo, hi):
            return lo + u[row] * (hi - lo)

        return cls(flip=u[0] < 0.5, apply=u[1] < JITTER_P,
                   brightness=between(2, 1 - BRIGHTNESS, 1 + BRIGHTNESS),
                   contrast=between(3, 1 - CONTRAST, 1 + CONTRAST),
                   saturation=between(4, 1 - SATURATION, 1 + SATURATION),
                   hue=between(5, -HUE, HUE))


def _per_image(x: torch.Tensor, ndim: int = 4) -> torch.Tensor:
    return x.view(-1, *([1] * (ndim - 1)))


def random_flip(images: torch.Tensor, flips: torch.Tensor) -> torch.Tensor:
    """Flip image i horizontally where ``flips[i]``."""
    return torch.where(_per_image(flips), images.flip(2), images)


def _rgb_to_hsv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """(..., 3) RGB in [0, 1] -> (h, s, v) each (...), h in [0, 1)."""
    r, g, b = x.unbind(-1)
    maxc = x.amax(-1)
    minc = x.amin(-1)
    v = maxc
    c = maxc - minc
    s = torch.where(maxc > 0, c / torch.clamp(maxc, min=1e-12), 0.0)
    safe_c = torch.clamp(c, min=1e-12)
    rc = (maxc - r) / safe_c
    gc = (maxc - g) / safe_c
    bc = (maxc - b) / safe_c
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(c > 0, torch.remainder(h * INV_6, 1.0), 0.0)
    return h, s, v


def _hsv_to_rgb(h: torch.Tensor, s: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)

    def sel(a0, a1, a2, a3, a4, a5):
        out = a5
        for k, a in ((4, a4), (3, a3), (2, a2), (1, a1), (0, a0)):
            out = torch.where(i == k, a, out)
        return out

    return torch.stack([sel(v, q, p, p, t, v),
                        sel(t, v, v, q, p, p),
                        sel(p, p, t, v, v, q)], dim=-1)


def random_hue(images: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Rotate image i's hue by ``shift[i]`` (a fraction of the colour
    wheel) through an exact HSV round trip; [0, 255] float in and out."""
    h, s, v = _rgb_to_hsv(images.float() * INV_255)
    rgb = _hsv_to_rgb(torch.remainder(h + _per_image(shift, 3), 1.0), s, v)
    return torch.clamp(rgb * 255.0, 0.0, 255.0)


def random_color_jitter(images: torch.Tensor, draws: AugDraws,
                        mean: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-image brightness, contrast, saturation and hue jitter in
    [0, 255] space, kept where ``draws.apply``; float32 out.  ``mean``
    (B,), where given, is each image's contrast mean (the mean of the
    brightened image), which is otherwise computed here."""
    x = images.float()
    x = x * _per_image(draws.brightness)
    fc = _per_image(draws.contrast)
    mean = (x.mean(dim=(1, 2, 3), keepdim=True) if mean is None
            else _per_image(mean))
    x = (x - mean) * fc + mean
    fs = _per_image(draws.saturation)
    wr, wg, wb = GRAY_WEIGHTS  # Python scalars: no host-to-device copy
    gray = x[..., 0:1] * wr + x[..., 1:2] * wg + x[..., 2:3] * wb
    x = x * fs + gray * (1 - fs)
    x = torch.clamp(x, 0.0, 255.0)
    x = random_hue(x, draws.hue)
    return torch.where(_per_image(draws.apply), x, images.float())


def augment_reference(images_u8: torch.Tensor, draws: AugDraws,
                      flip: bool = True, color_jitter: bool = True,
                      mean: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain twin of K3's fused pass: :func:`random_flip` (if
    ``flip``), :func:`random_color_jitter` (if ``color_jitter``), then
    the normalize, each a separate tensor operation; float32 out."""
    if flip:
        images_u8 = random_flip(images_u8, draws.flip)
    if color_jitter:
        images_u8 = random_color_jitter(images_u8, draws, mean)
    return normalize_reference(images_u8)


def device_preprocess(images_u8: torch.Tensor,
                      draws: Optional[AugDraws] = None, flip: bool = True,
                      color_jitter: bool = False) -> torch.Tensor:
    """The on-device tail of the augmentation pipeline: flip and colour
    jitter (when ``draws`` is given and each is on), then the normalize
    into float32.  On the card, with draws, one launch of K3's fused pass
    (:func:`augment_normalize_u8`); without, the standalone normalize
    (:func:`normalize_u8`); CPU tensors take their plain twins.  The JAX
    package's ``use_pallas`` knob and its ``normalize_images`` dispatcher
    have no counterpart (ROADMAP Queue 3)."""
    if draws is None:
        return normalize_u8(images_u8)
    return augment_normalize_u8(images_u8, draws, flip, color_jitter)


__all__ = ["AugDraws", "random_flip", "random_hue", "random_color_jitter",
           "augment_reference", "device_preprocess"]
