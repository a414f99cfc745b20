"""The port's stand-ins for OpenCV (clip_lite_torch/data/imgproc.py) held
against OpenCV itself, over hypothesis-drawn shapes (1-97 px, up- and
downscale, odd sizes) and seeded uint8 images.

Bar: max |difference| <= 1 grey level.  Each test also asks that at least
99% of the values be exactly OpenCV's; against OpenCV 5.0 (x86-64)
every stand-in measured 100% exact, at these shapes and at the data
path's (480 x 640 crops to 224, 480 -> 256 tiles)."""

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from clip_lite_torch.data import imgproc

SIDE = st.integers(1, 97)
SEED = st.integers(0, 2 ** 32 - 1)
EXAMPLES = settings(max_examples=60, deadline=None)


def _image(seed, h, w, channels=3):
    shape = (h, w, channels) if channels else (h, w)
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _check(ours, theirs):
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype == np.uint8
    diff = np.abs(ours.astype(np.int64) - theirs.astype(np.int64))
    assert diff.max(initial=0) <= 1
    assert (diff == 0).mean() >= 0.99


@EXAMPLES
@given(h=SIDE, w=SIDE, height=SIDE, width=SIDE, seed=SEED)
def test_resize_linear(h, w, height, width, seed):
    img = _image(seed, h, w)
    _check(imgproc.resize_linear(img, width, height),
           cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR))


@EXAMPLES
@given(h=SIDE, w=SIDE, height=SIDE, width=SIDE, seed=SEED)
def test_resize_area(h, w, height, width, seed):
    img = _image(seed, h, w)
    _check(imgproc.resize_area(img, width, height),
           cv2.resize(img, (width, height), interpolation=cv2.INTER_AREA))


@EXAMPLES
@given(side=SIDE, size=SIDE, seed=SEED)
def test_resize_area_square(side, size, seed):
    """The device cache's tiles: a square to a square."""
    img = _image(seed, side, side)
    _check(imgproc.resize_area(img, size, size),
           cv2.resize(img, (size, size), interpolation=cv2.INTER_AREA))


@pytest.mark.parametrize("src,dst", [((48, 64), (24, 32)), ((63, 45), (21, 15)),
                                     ((40, 40), (80, 80)), ((97, 1), (3, 1))])
@pytest.mark.parametrize("interpolation", ["linear", "area"])
def test_resize_integer_factors(src, dst, interpolation):
    img = _image(1, *src)
    flag = {"linear": cv2.INTER_LINEAR, "area": cv2.INTER_AREA}[interpolation]
    ours = getattr(imgproc, f"resize_{interpolation}")(img, dst[1], dst[0])
    _check(ours, cv2.resize(img, (dst[1], dst[0]), interpolation=flag))


def test_resize_single_channel():
    img = _image(2, 17, 23, channels=0)
    _check(imgproc.resize_linear(img, 9, 31),
           cv2.resize(img, (9, 31), interpolation=cv2.INTER_LINEAR))


@EXAMPLES
@given(h=SIDE, w=SIDE, seed=SEED)
def test_rgb_to_hsv(h, w, seed):
    img = _image(seed, h, w)
    _check(imgproc.rgb_to_hsv(img), cv2.cvtColor(img, cv2.COLOR_RGB2HSV))


@EXAMPLES
@given(h=SIDE, w=SIDE, seed=SEED, shift=st.floats(-0.1, 0.1))
def test_hsv_round_trip_with_hue_shift(h, w, seed, shift):
    """ColorJitter's hue step: RGB -> HSV, H shifted mod 180, -> RGB."""
    img = _image(seed, h, w)

    def jitter(to_hsv, to_rgb):
        hsv = to_hsv(img)
        hsv[..., 0] = (hsv[..., 0].astype(np.int32) + int(shift * 180)) % 180
        return to_rgb(hsv)

    _check(jitter(imgproc.rgb_to_hsv, imgproc.hsv_to_rgb),
           jitter(lambda x: cv2.cvtColor(x, cv2.COLOR_RGB2HSV),
                  lambda x: cv2.cvtColor(x, cv2.COLOR_HSV2RGB)))


def test_hsv_to_rgb_every_hue_saturation_value():
    """Every 8-bit HSV triple (V in steps of 3), in rows of 32 pixels
    and of 1 pixel (OpenCV's vector path and its per-pixel path)."""
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(0, 256, 3),
                          indexing="ij")
    hsv = np.stack([h, s, v], axis=-1).astype(np.uint8)
    for width in (32, 1):
        rows = hsv.reshape(-1, width, 3)
        _check(imgproc.hsv_to_rgb(rows), cv2.cvtColor(rows, cv2.COLOR_HSV2RGB))


@EXAMPLES
@given(h=SIDE, w=SIDE, seed=SEED)
def test_rgb_to_gray(h, w, seed):
    img = _image(seed, h, w)
    _check(imgproc.rgb_to_gray(img), cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


@EXAMPLES
@given(h=SIDE, w=SIDE, seed=SEED, sigma=st.floats(0.1, 2.0))
def test_gaussian_blur_k5(h, w, seed, sigma):
    img = _image(seed, h, w)
    _check(imgproc.gaussian_blur(img, 5, sigma),
           cv2.GaussianBlur(img, (5, 5), sigma))


@pytest.mark.parametrize("sigma", [0.1, 0.5, 1.0, 1.3, 2.0])
def test_gaussian_kernel_sums_to_one(sigma):
    k = imgproc.gaussian_kernel(5, sigma)
    assert k.sum() == 256 and np.array_equal(k, k[::-1])
    np.testing.assert_allclose(k / 256, cv2.getGaussianKernel(5, sigma)[:, 0],
                               atol=1 / 256)


def test_data_path_shapes():
    """The host loader's and the cache's own shapes: COCO-sized images."""
    img = _image(3, 480, 640)
    crop = img[17:407, 31:523]
    _check(imgproc.resize_linear(crop, 224, 224),
           cv2.resize(crop, (224, 224), interpolation=cv2.INTER_LINEAR))
    _check(imgproc.resize_linear(img, 341, 256),
           cv2.resize(img, (341, 256), interpolation=cv2.INTER_LINEAR))
    square = img[:, 80:560]
    _check(imgproc.resize_area(square, 256, 256),
           cv2.resize(square, (256, 256), interpolation=cv2.INTER_AREA))
    tile = np.ascontiguousarray(img[:224, :224])
    _check(imgproc.hsv_to_rgb(imgproc.rgb_to_hsv(tile)),
           cv2.cvtColor(cv2.cvtColor(tile, cv2.COLOR_RGB2HSV),
                        cv2.COLOR_HSV2RGB))


def test_rejects_other_dtypes():
    with pytest.raises(TypeError):
        imgproc.resize_linear(np.zeros((4, 4, 3), np.float32), 2, 2)
