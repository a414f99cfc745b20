"""ImageNet normalize of NHWC image batches: K3, the counterpart of the JAX
package's ``ops/pallas_kernels.py``.

K3 is a hand-written CUDA kernel (``csrc/normalize.cu``) computing
``(x - 255 * mean_c) * 1 / (255 * std_c)`` over a (B, H, W, 3) uint8 or
float32 batch, channel = flat index mod 3, into float32 or bfloat16.  Its
wrapper :func:`normalize_u8` keeps the JAX name; its plain PyTorch twin is
:func:`normalize_reference`.  Both use the TPU kernel's constants
(``pallas_kernels.py:51-52``: Python-double products rounded once to
fp32) and round twice, after the subtract and after the multiply, so the
kernel and the twin agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from clip_lite_torch.data.transforms import (
    IMAGENET_COLOR_MEAN,
    IMAGENET_COLOR_STD,
)

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


@functools.cache
def _library() -> ctypes.CDLL:
    from clip_lite_torch.ops import _build

    lib = _build.load("normalize")
    lib.normalize_u8.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                                 + [ctypes.c_int] * 2 + [ctypes.c_float] * 6
                                 + [ctypes.c_void_p])
    lib.normalize_u8.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


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
    out = torch.empty(images.shape, dtype=dtype, device=images.device)
    lib = _library()
    with torch.cuda.device(images.device):
        err = lib.normalize_u8(
            images.data_ptr(), out.data_ptr(), images.numel(),
            _IN_CODES[images.dtype], _OUT_CODES[dtype], *MEAN_255,
            *INV_STD_255, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("K3 launch failed: "
                           + lib.kernel_error_string(err).decode())
    normalize_u8.launches += 1
    return out


normalize_u8.launches = 0

__all__ = ["normalize_u8", "normalize_reference", "MEAN_255", "INV_STD_255"]
