"""The image operations of the host transforms, on uint8 HWC numpy arrays:
the port's stand-in for the OpenCV calls of the JAX package's data path
(``cv2.resize`` with ``INTER_LINEAR`` and ``INTER_AREA``, ``cvtColor``
RGB<->HSV and RGB->GRAY, ``GaussianBlur``), which the card's machine does
not have.

Each function follows OpenCV's own arithmetic for 8-bit images, so that
the port's host batches are the JAX package's:

* ``resize_linear``: OpenCV's fixed-point bilinear rule, 11-bit
  coefficients rounded from float32 source positions, a horizontal pass
  in int32 and a vertical pass that keeps 16 bits of each product (the
  rule of its vectorised ``VResizeLinearVec_32s8u``); an exact halving
  takes the 2x2 mean, as OpenCV does;
* ``resize_area``: for a downscale the area weights of each destination
  pixel over the source pixels it covers, accumulated in float32 (the
  mean of whole blocks at an integer factor); for an upscale OpenCV's
  bilinear rule with its area coefficients;
* ``rgb_to_hsv``: the 8-bit rule with the division tables (12-bit fixed
  point; H in [0, 180)); ``hsv_to_rgb`` goes through float32 as OpenCV's
  does, with its fused multiply-adds, and truncated where OpenCV's
  vector path truncates (whole blocks of 32 pixels of a row);
* ``rgb_to_gray``: 15-bit fixed-point weights;
* ``gaussian_blur``: the bit-exact 8-bit rule: a kernel of 8-bit fixed
  point (rounded with error diffusion so that it sums to one), a
  horizontal then a vertical pass, the border reflected about the edge
  pixel (``BORDER_REFLECT_101``).

``tests/test_torch_imgproc.py`` holds each against OpenCV.
"""

from __future__ import annotations

import math

import numpy as np

_COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS
_COEF_ONE = 1 << _COEF_BITS


def _round_even(x: np.ndarray) -> np.ndarray:
    """``cvRound``: to the nearest integer, ties to even."""
    return np.rint(x).astype(np.int64)


def _linear_taps(n_src: int, n_dst: int, area: bool, horizontal: bool):
    """Per destination index: the two source indices and their 11-bit
    weights (``resize.cpp``'s ``xofs``/``ialpha`` and ``yofs``/``ibeta``).
    Past an edge the source index is clamped; OpenCV zeroes the weight
    of the second tap there only horizontally, so a clamped row keeps
    both weights on the same source row."""
    inv = n_dst / n_src
    scale = 1.0 / inv
    d = np.arange(n_dst, dtype=np.float64)
    if area:  # INTER_AREA's coefficients where it scales up
        sx = np.floor(d * scale)
        fx = ((d + 1) - (sx + 1) * inv).astype(np.float32)
        fx = np.where(fx <= 0, np.float32(0), fx - np.floor(fx))
    else:
        f = ((d + 0.5) * scale - 0.5).astype(np.float32)
        sx = np.floor(f)
        fx = f - sx
    sx = sx.astype(np.int64)
    if horizontal:
        edge = (sx < 0) | (sx >= n_src - 1)
        fx = np.where(edge, np.float32(0), fx).astype(np.float32)
    one = np.float32(_COEF_ONE)
    a0 = _round_even((np.float32(1) - fx) * one)
    a1 = _round_even(fx * one)
    return (np.clip(sx, 0, n_src - 1), np.clip(sx + 1, 0, n_src - 1),
            a0, a1)


def _resize_fixed(img: np.ndarray, width: int, height: int,
                  area: bool) -> np.ndarray:
    h, w = img.shape[:2]
    x0, x1, a0, a1 = _linear_taps(w, width, area, horizontal=True)
    y0, y1, b0, b1 = _linear_taps(h, height, area, horizontal=False)
    rows = np.unique(np.concatenate([y0, y1]))
    src = img[rows].astype(np.int64)
    horiz = (src[:, x0] * a0[None, :, None]
             + src[:, x1] * a1[None, :, None]) >> 4
    at = np.searchsorted(rows, y0), np.searchsorted(rows, y1)
    out = (((b0[:, None, None] * horiz[at[0]]) >> 16)
           + ((b1[:, None, None] * horiz[at[1]]) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def _area_fast(img: np.ndarray, fx: int, fy: int) -> np.ndarray:
    """The mean of each fy x fx block (integer factors): a 2x2 block
    rounds half up in integers, others through float32, ties to even."""
    h, w = img.shape[:2]
    hd, wd = h // fy, w // fx
    blocks = img[:hd * fy, :wd * fx].astype(np.int64).reshape(
        hd, fy, wd, fx, -1).sum(axis=(1, 3))
    if fx == fy == 2:
        out = (blocks + 2) >> 2
    else:
        out = _round_even(blocks.astype(np.float32)
                          * np.float32(1.0 / (fx * fy)))
    return np.clip(out, 0, 255).astype(np.uint8)


def _area_taps(n_src: int, n_dst: int):
    """INTER_AREA's downscale weights (``computeResizeAreaTab``): per
    destination index, up to ``taps`` (source index, float32 weight)
    pairs in source order, padded with weight 0."""
    scale = n_src / n_dst
    entries = []
    for dx in range(n_dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, n_src - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, n_src - 1)
        sx1 = min(sx1, sx2)
        row = []
        if sx1 - fsx1 > 1e-3:
            row.append((sx1 - 1, (sx1 - fsx1) / cell))
        row += [(sx, 1.0 / cell) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            row.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        entries.append(row)
    taps = max(len(r) for r in entries)
    idx = np.zeros((n_dst, taps), np.int64)
    wgt = np.zeros((n_dst, taps), np.float32)
    for dx, row in enumerate(entries):
        for t, (sx, a) in enumerate(row):
            idx[dx, t], wgt[dx, t] = sx, a
    return idx, wgt


def _area_generic(img: np.ndarray, width: int, height: int) -> np.ndarray:
    h, w = img.shape[:2]
    xi, xw = _area_taps(w, width)
    yi, yw = _area_taps(h, height)
    src = img.astype(np.float32)
    horiz = np.zeros((h, width, img.shape[2]), np.float32)
    for t in range(xi.shape[1]):  # in source order, as OpenCV sums
        horiz += src[:, xi[:, t]] * xw[None, :, t, None]
    out = np.zeros((height, width, img.shape[2]), np.float32)
    for t in range(yi.shape[1]):
        out += horiz[yi[:, t]] * yw[:, t, None, None]
    return np.clip(_round_even(out), 0, 255).astype(np.uint8)


def _as_hwc(img: np.ndarray):
    """(H, W, C) view of a uint8 (H, W) or (H, W, C) image."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"expected a uint8 image, got {img.dtype}")
    return (img[..., None], True) if img.ndim == 2 else (img, False)


def _integer_factor(n_src: int, n_dst: int):
    return n_src // n_dst if n_src % n_dst == 0 else None


def resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=INTER_LINEAR)``."""
    img, flat = _as_hwc(img)
    h, w = img.shape[:2]
    if (h, w) == (height, width):
        out = img.copy()
    elif 2 * width == w and 2 * height == h:
        out = _area_fast(img, 2, 2)
    else:
        out = _resize_fixed(img, width, height, area=False)
    return out[..., 0] if flat else out


def resize_area(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=INTER_AREA)``."""
    img, flat = _as_hwc(img)
    h, w = img.shape[:2]
    if (h, w) == (height, width):
        out = img.copy()
    elif width <= w and height <= h:
        fx, fy = _integer_factor(w, width), _integer_factor(h, height)
        out = (_area_fast(img, fx, fy) if fx and fy
               else _area_generic(img, width, height))
    else:
        out = _resize_fixed(img, width, height, area=True)
    return out[..., 0] if flat else out


_HSV_SHIFT = 12
_SDIV = np.array([0] + [round((255 << _HSV_SHIFT) / i) for i in range(1, 256)],
                 np.int64)
_HDIV180 = np.array([0] + [round((180 << _HSV_SHIFT) / (6.0 * i))
                           for i in range(1, 256)], np.int64)


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_RGB2HSV)`` on uint8: H in [0, 180)."""
    rgb = img.astype(np.int64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = rgb.max(axis=-1)
    diff = v - rgb.min(axis=-1)
    s = (diff * _SDIV[v] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV180[diff] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


_VECTOR_PIXELS = 32
# (b, g, r) picks from (v, v(1-s), v(1-sh), v(1-s(1-h))) per sector.
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1],
                     [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def _one_minus_product(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """float32 ``1 - a * b`` rounded once, as a fused multiply-add gives
    it (OpenCV's vectorised HSV2RGB): the float64 product of two float32
    values is exact."""
    return (1.0 - a.astype(np.float64) * b).astype(np.float32)


def hsv_to_rgb(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_HSV2RGB)`` on uint8 (H in [0, 180)),
    in float32 as OpenCV computes it."""
    hsv = img.astype(np.float32)
    one = np.float32(1)
    h = hsv[..., 0] * np.float32(6.0 / 180.0)
    s = hsv[..., 1] * np.float32(1.0 / 255.0)
    v = hsv[..., 2] * np.float32(1.0 / 255.0)
    sector = np.floor(h)
    h = h - sector
    sector = sector.astype(np.int64) % 6
    tab = np.stack([v, v * (one - s), v * _one_minus_product(s, h),
                    v * _one_minus_product(s, one - h)], axis=-1)
    bgr = np.take_along_axis(tab, _SECTORS[sector], axis=-1)
    rgb = bgr[..., ::-1] * np.float32(255)
    # OpenCV's 256-bit vector path takes each row's pixels in blocks of
    # _VECTOR_PIXELS and truncates; the row's remainder is rounded.
    width = img.shape[-2] if img.ndim == 3 else 1
    blocked = (np.arange(width) < width - width % _VECTOR_PIXELS)[:, None]
    rgb = np.where(blocked, np.floor(rgb), np.rint(rgb))
    return np.clip(rgb, 0, 255).astype(np.uint8)


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_RGB2GRAY)``: (H, W) uint8."""
    rgb = img.astype(np.int64)
    y = (rgb[..., 0] * 9798 + rgb[..., 1] * 19235 + rgb[..., 2] * 3735
         + (1 << 14)) >> 15
    return y.astype(np.uint8)


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """OpenCV's 8-bit Gaussian kernel: int64 weights of 8 fractional bits
    summing to 256 (``getGaussianKernelBitExact``, then rounded with
    error diffusion from the ends to the centre)."""
    if ksize % 2 != 1 or sigma <= 0:
        raise ValueError("an odd ksize and a positive sigma")
    scale = -0.125 / (sigma * sigma)
    half = (ksize - 1) // 2
    values = [math.exp(float(x * x) * scale) for x in range(1 - ksize, -1, 2)]
    total = 2.0 * sum(values) + 1.0
    mul = 1.0 / total
    out = np.zeros(ksize, np.int64)
    err, acc = 0.0, 0
    for i, t in enumerate(values):
        adj = (t * mul) * 256.0 + err
        v = int(np.rint(adj))
        err = adj - v
        out[i] = out[ksize - 1 - i] = v
        acc += v
    out[half] = 256 - 2 * acc
    return out


def _reflect101(n: int, pad: int) -> np.ndarray:
    """Source index of each of ``n + 2 pad`` positions under
    BORDER_REFLECT_101 (``borderInterpolate``, which reflects again until
    the index lies inside)."""
    idx = []
    for p in range(-pad, n + pad):
        if n == 1:
            idx.append(0)
            continue
        while not 0 <= p < n:
            p = -p if p < 0 else 2 * (n - 1) - p
        idx.append(p)
    return np.array(idx, np.int64)


def gaussian_blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (ksize, ksize), sigma)`` on uint8."""
    img, flat = _as_hwc(img)
    k = gaussian_kernel(ksize, sigma)
    pad = ksize // 2
    h, w = img.shape[:2]
    src = img.astype(np.int64)
    cols = _reflect101(w, pad)
    horiz = sum(src[:, cols[t:t + w]] * k[t] for t in range(ksize))
    rows = _reflect101(h, pad)
    out = sum(horiz[rows[t:t + h]] * k[t] for t in range(ksize))
    out = ((out + (1 << 15)) >> 16).astype(np.uint8)
    return out[..., 0] if flat else out


__all__ = ["gaussian_blur", "gaussian_kernel", "hsv_to_rgb", "resize_area",
           "resize_linear", "rgb_to_gray", "rgb_to_hsv"]
