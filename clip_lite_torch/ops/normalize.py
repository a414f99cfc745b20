"""ImageNet normalize of NHWC image batches: K3, the counterpart of the JAX
package's ``ops/pallas_kernels.py``.

K3 is hand-written CUDA (``csrc/normalize.cu``) with two entry points:

- :func:`normalize_u8` (the JAX name) computes ``(x - 255 * mean_c) *
  1 / (255 * std_c)`` over a (B, H, W, 3) uint8 or float32 batch, channel
  = flat index mod 3, into float32 or bfloat16.  Its plain twin is
  :func:`normalize_reference`.  Both use the TPU kernel's constants
  (``pallas_kernels.py:51-52``: Python-double products rounded once to
  fp32) and round twice, after the subtract and after the multiply, so the
  kernel and the twin agree bit for bit.
- :func:`augment_normalize_u8` is the uint8 training path's one pass: the
  per-image flip and colour jitter of ``ops/image_ops.py`` and the
  normalize, from uint8 into float32.  Its plain twin is
  ``image_ops.augment_reference`` (flip, jitter, normalize as separate
  tensor operations); the two differ only in how each image's contrast
  mean is summed (the kernel's sum of bytes is exact).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from clip_lite_torch.data.transforms import (
    IMAGENET_COLOR_MEAN,
    IMAGENET_COLOR_STD,
)
from clip_lite_torch.utils.trace import traced

# pallas_kernels.py:51-52 of the JAX package, rounded once to fp32.
MEAN_255 = tuple(float(np.float32(m * 255.0)) for m in IMAGENET_COLOR_MEAN)
INV_STD_255 = tuple(float(np.float32(1.0 / (s * 255.0)))
                    for s in IMAGENET_COLOR_STD)
_IN_CODES = {torch.uint8: 0, torch.float32: 1}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def normalize_reference(images: torch.Tensor,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K3's plain twin: (B, H, W, 3) uint8 or float -> normalized
    ``dtype``, subtract then multiply in fp32, one cast at the end."""
    mean = torch.tensor(MEAN_255, dtype=torch.float32, device=images.device)
    inv_std = torch.tensor(INV_STD_255, dtype=torch.float32,
                           device=images.device)
    return ((images.float() - mean) * inv_std).to(dtype)


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the ctypes signatures of ``csrc/normalize.cu``'s entry points."""
    lib.normalize_u8.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                                 + [ctypes.c_int] * 2 + [ctypes.c_float] * 6
                                 + [ctypes.c_void_p])
    lib.augment_normalize_u8.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 7
        + [ctypes.c_int] * 2 + [ctypes.c_float] * 6 + [ctypes.c_void_p])
    lib.normalize_u8.restype = lib.augment_normalize_u8.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    from clip_lite_torch.ops import _build

    return declare(_build.load("normalize"))


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.kernel_error_string(err).decode())


def _check(images: torch.Tensor, dtype: torch.dtype) -> None:
    if images.ndim != 4 or images.shape[-1] != 3:
        raise ValueError(f"normalize_u8 takes (B, H, W, 3) RGB batches, got "
                         f"{tuple(images.shape)}")
    if images.dtype not in _IN_CODES:
        raise TypeError(f"normalize_u8 takes uint8 or float32 images, got "
                        f"{images.dtype}")
    if dtype not in _OUT_CODES:
        raise TypeError(f"normalize_u8 writes float32 or bfloat16, not {dtype}")
    if images.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no normalize kernel for device {images.device}")


def launch_normalize(lib: ctypes.CDLL, images: torch.Tensor,
                     dtype: torch.dtype, stream) -> torch.Tensor:
    """Call ``lib``'s ``normalize_u8`` on ``stream``; raises if the entry
    point refuses the launch."""
    out = torch.empty(images.shape, dtype=dtype, device=images.device)
    _raise_on(lib, lib.normalize_u8(
        images.data_ptr(), out.data_ptr(), images.numel(),
        _IN_CODES[images.dtype], _OUT_CODES[dtype], *MEAN_255, *INV_STD_255,
        stream), "K3")
    return out


@traced("K3 normalize_u8")
def normalize_u8(images: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, 3) uint8 (or float32 in [0, 255]) -> ImageNet-normalized
    ``dtype`` (float32 or bfloat16), a contiguous NHWC tensor.

    CPU tensors take :func:`normalize_reference`.  CUDA tensors launch K3
    or raise (a non-contiguous or empty batch too); every launch adds one
    to ``normalize_u8.launches``.
    """
    _check(images, dtype)
    if images.device.type == "cpu":
        return normalize_reference(images, dtype)
    if not images.is_contiguous() or images.numel() == 0:
        raise ValueError("normalize_u8 takes a contiguous, non-empty batch")
    with torch.cuda.device(images.device):
        out = launch_normalize(_library(), images, dtype,
                               torch.cuda.current_stream().cuda_stream)
    normalize_u8.launches += 1
    return out


normalize_u8.launches = 0

# The draws the fused pass reads, by flag, in the entry point's order.
_FLIP_DRAWS = (("flip", torch.bool),)
_JITTER_DRAWS = (("apply", torch.bool), ("brightness", torch.float32),
                 ("contrast", torch.float32), ("saturation", torch.float32),
                 ("hue", torch.float32))


def _per_image(x: torch.Tensor, batch: int, device: torch.device,
               dtype: torch.dtype, name: str) -> torch.Tensor:
    if x.shape != (batch,) or x.device != device:
        raise ValueError(f"augment_normalize_u8: {name} must be ({batch},) on "
                         f"{device}, got {tuple(x.shape)} on {x.device}")
    x = x.to(dtype).contiguous()  # on the device: no host sync
    return x.view(torch.uint8) if dtype == torch.bool else x


def launch_augment_normalize(lib: ctypes.CDLL, images_u8: torch.Tensor,
                             draws, flip: bool, color_jitter: bool,
                             mean: Optional[torch.Tensor],
                             stream) -> torch.Tensor:
    """Check the draws and call ``lib``'s ``augment_normalize_u8`` on
    ``stream``; raises if the entry point refuses the launch."""
    b, h, w, _ = images_u8.shape
    device = images_u8.device
    wanted = (_FLIP_DRAWS if flip else ()) + (_JITTER_DRAWS if color_jitter
                                              else ())
    ptrs = dict.fromkeys([n for n, _ in _FLIP_DRAWS + _JITTER_DRAWS]
                         + ["mean"])
    kept = []  # the (B,) tensors whose memory the launch reads
    for name, dtype in wanted:
        kept.append(_per_image(getattr(draws, name), b, device, dtype, name))
        ptrs[name] = kept[-1].data_ptr()
    if color_jitter and mean is not None:
        kept.append(_per_image(mean, b, device, torch.float32, "mean"))
        ptrs["mean"] = kept[-1].data_ptr()
    out = torch.empty(images_u8.shape, dtype=torch.float32, device=device)
    _raise_on(lib, lib.augment_normalize_u8(
        images_u8.data_ptr(), out.data_ptr(), b, h, w, *ptrs.values(),
        int(flip), int(color_jitter), *MEAN_255, *INV_STD_255, stream),
        "K3 fused")
    return out


@traced("K3 augment_normalize_u8")
def augment_normalize_u8(images_u8: torch.Tensor, draws, flip: bool = True,
                         color_jitter: bool = True,
                         mean: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> flipped where ``draws.flip`` (if ``flip``),
    colour-jittered where ``draws.apply`` (if ``color_jitter``) and
    ImageNet-normalized float32, a contiguous NHWC tensor: K3's fused pass.

    ``draws`` is an ``image_ops.AugDraws`` of (B,) tensors on the batch's
    device.  ``mean`` (B,), where given, replaces each image's contrast
    mean (the mean of the brightened image), which the pass otherwise sums
    itself.  CPU tensors take the plain composition
    (``image_ops.augment_reference``).  CUDA tensors launch the fused pass
    or raise (a non-contiguous or empty batch, or draws of another shape
    or device, too); every launch adds one to
    ``augment_normalize_u8.launches``.
    """
    if images_u8.ndim != 4 or images_u8.shape[-1] != 3:
        raise ValueError(f"augment_normalize_u8 takes (B, H, W, 3) RGB "
                         f"batches, got {tuple(images_u8.shape)}")
    if images_u8.dtype != torch.uint8:
        raise TypeError(f"augment_normalize_u8 takes uint8 images, got "
                        f"{images_u8.dtype}")
    device = images_u8.device
    if device.type == "cpu":
        from clip_lite_torch.ops.image_ops import augment_reference

        return augment_reference(images_u8, draws, flip, color_jitter, mean)
    if device.type != "cuda":
        raise ValueError(f"no augment_normalize kernel for device {device}")
    if not images_u8.is_contiguous() or images_u8.numel() == 0:
        raise ValueError("augment_normalize_u8 takes a contiguous, non-empty "
                         "batch")
    with torch.cuda.device(device):
        out = launch_augment_normalize(
            _library(), images_u8, draws, flip, color_jitter, mean,
            torch.cuda.current_stream().cuda_stream)
    augment_normalize_u8.launches += 1
    return out


augment_normalize_u8.launches = 0

__all__ = ["normalize_u8", "normalize_reference", "augment_normalize_u8",
           "MEAN_255", "INV_STD_255"]
