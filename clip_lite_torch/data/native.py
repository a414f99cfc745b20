"""The native JPEG batch path (``DATA.NATIVE_PIPELINE``), the counterpart of
the JAX package's ``data/native.py`` and of its C++ core
(``native/clrec_core.cpp``).

A batch of JPEG records becomes one (B, S, S, 3) uint8 tensor on the card:

1. nvJPEG decodes every JPEG of the batch with its batched API into one
   device arena, interleaved RGB (``csrc/decode_crop.cu``);
2. ``crop_resize_flip_u8``, a hand-written kernel (``csrc/crop_resize.cuh``),
   cuts each image's crop box out of the arena, resizes it bilinearly to
   S x S and mirrors it where asked, all images in one launch, straight
   into the output (which may be a slice of the device cache's tiles).

Flip, colour jitter and the normalize then happen in the train step (K3's
fused pass), as the JAX package leaves them to its compiled step.

The crop arithmetic is the JAX core's ``sample_crop`` as its compiled
library runs it: fp32, with the fused multiply-adds that its build
contracts (``fma`` below marks each one), so that the kernel and the plain
twin equal the JAX core bit for bit on the same decoded pixels.

:func:`decode_crop_batch` is the entry point.  On a CUDA device it runs
nvJPEG and the kernel, or raises; given ``device="cpu"`` it runs the plain
twin, :func:`decode_crop_batch_plain`: PIL's libjpeg decode with the JAX
core's DCT-domain scale rule (``Image.draft``), then
:func:`crop_resize_flip_reference` in numpy.  The twin equals the JAX core
bit for bit (``tests/test_torch_native.py``).

Deliberate differences on the card (ROADMAP Queue 3): nvJPEG always
decodes at full resolution, so where the JAX core takes a 1/2-1/8 scaled
decode (a crop whose short side keeps at least 2.6 x S source pixels) the
kernel samples the full image averaged over blocks of the same
denominator (the scale in the pixel domain, not the DCT's); nvJPEG's IDCT
and chroma upsampling are not libjpeg's, so the card's tiles differ from
the twin's by a level or so.  A JPEG that the JAX core cannot turn into RGB (CMYK,
YCCK, bytes that are no JPEG, one cut inside a header) gives a zero tile
and counts as a failure, on the card and in the twin; so does one that
nvJPEG refuses where libjpeg decodes it (a scan of restart markers only).
A record image that is not encoded bytes raises.
"""

from __future__ import annotations

import ctypes
import functools
import io
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from clip_lite_torch.utils.trace import traced

f32 = np.float32


def random_resized_crop_boxes(rng: np.random.Generator, n: int,
                              scale=(0.2, 1.0), ratio=(0.75, 4 / 3)
                              ) -> np.ndarray:
    """(n, 4) float32 normalized (y0, x0, y1, x1) crop boxes with the area
    and aspect law of the host ``RandomResizedSquareCrop``: the JAX
    ``native.random_resized_crop_boxes``, the same draws in the same
    order."""
    boxes = np.empty((n, 4), np.float32)
    for i in range(n):
        area = rng.uniform(*scale)
        aspect = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = min(1.0, np.sqrt(area * aspect))
        ch = min(1.0, np.sqrt(area / aspect))
        x0 = rng.uniform(0, 1 - cw)
        y0 = rng.uniform(0, 1 - ch)
        boxes[i] = (y0, x0, y0 + ch, x0 + cw)
    return boxes


def full_image_boxes(n: int) -> np.ndarray:
    """Boxes that ask for the whole image (y0 < 0), resized to a square."""
    return np.full((n, 4), -1.0, np.float32)


# ---------------------------------------------------------------------------
# The plain twin
# ---------------------------------------------------------------------------

def fma(a, b, c) -> torch.Tensor:
    """fp32 ``a * b + c`` rounded once (IEEE fused multiply-add), with
    plain tensor operations on any device: the product is exact in float64,
    the sum is rounded to odd in float64 (which has more than 24 + 2 bits),
    and that rounds to the nearest float32 as the single rounding would.
    Arguments broadcast; each is taken as float32."""
    a, b, c = (torch.as_tensor(x).to(torch.float32).double() for x in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)  # the sum's rounding error, exactly
    bits = s.contiguous().view(torch.int64)
    odd = (err != 0) & ((bits & 1) == 0)  # inexact: step to the odd one
    away = (err > 0) == (s > 0)  # the exact sum lies beyond s, from zero
    bits = torch.where(odd, bits + torch.where(away, 1, -1), bits)
    return bits.view(torch.float64).float()


def scale_denom(box: np.ndarray, height: int, width: int, out_size: int) -> int:
    """The JAX core's DCT-domain scale (1, 2, 4 or 8) for a JPEG of
    ``height`` x ``width`` whose ``box`` is resampled to ``out_size``:
    halve while the crop's short side keeps 1.3 x ``out_size`` pixels."""
    box = np.asarray(box, np.float32)
    frac = f32(1) if box[0] < 0 else min(box[2] - box[0], box[3] - box[1])
    if not frac > 0:
        frac = f32(1)
    crop_px = f32(frac) * f32(min(height, width))
    threshold = f32(out_size) * f32(1.3)
    denom = 1
    while denom < 8 and crop_px * f32(0.5 / denom) >= threshold:
        denom *= 2
    return denom


def scale_denoms(boxes: np.ndarray, sizes: np.ndarray, out_size: int
                 ) -> np.ndarray:
    """:func:`scale_denom` of each image of (H, W) ``sizes`` for its box (1
    for a failed decode, 0 x 0): the block a full-resolution decode is
    averaged over to stand in for the JAX core's scaled decode.  The same
    float32 operations over the batch at once."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    sizes = np.asarray(sizes).reshape(-1, 2)
    frac = np.minimum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1])
    frac = np.where((boxes[:, 0] < 0) | ~(frac > 0), f32(1), frac)
    crop_px = frac * sizes.min(1).astype(np.float32)
    threshold = f32(out_size) * f32(1.3)
    denoms = np.ones(len(boxes), np.int32)
    for denom in (1, 2, 4):
        denoms[(denoms == denom) & (crop_px * f32(0.5 / denom) >= threshold)] *= 2
    denoms[(sizes == 0).any(1)] = 1
    return denoms


def decode_rgb(jpeg: bytes, box: np.ndarray, out_size: int,
               scaled: bool = True) -> Optional[np.ndarray]:
    """``jpeg`` decoded to HWC uint8 RGB by PIL's libjpeg as the JAX core
    decodes it for ``box`` at ``out_size``: at its DCT-domain scale
    (``Image.draft``, the same IDCT and upsampling; at full resolution
    where ``scaled`` is false, as nvJPEG decodes), greyscale expanded to
    RGB, no EXIF orientation.  None where the JAX core fails: bytes that
    are no JPEG, or a JPEG with no RGB output (CMYK, YCCK).

    An end-of-image marker is appended, as libjpeg's memory source
    appends one where the data ends early: a truncated baseline JPEG then
    decodes as far as it goes, as in the JAX core, where PIL alone would
    refuse it."""
    from PIL import Image, UnidentifiedImageError

    try:
        image = Image.open(io.BytesIO(jpeg + b"\xff\xd9"))
    except (UnidentifiedImageError, OSError):
        return None
    with image:
        if image.format not in ("JPEG", "MPO") or image.mode not in ("RGB", "L"):
            return None
        width, height = image.size
        denom = scale_denom(box, height, width, out_size) if scaled else 1
        if denom > 1:
            image.draft(image.mode, (width // denom, height // denom))
            if image.size != (-(-width // denom), -(-height // denom)):
                raise AssertionError(f"PIL's draft gave {image.size} for "
                                     f"1/{denom} of {width} x {height}")
        try:
            return np.asarray(image.convert("RGB"), np.uint8)
        except (OSError, SyntaxError, ValueError):
            return None


def _axis_taps(size: int, start, step, extent: int, flip: bool, device):
    """``sample_crop``'s source positions along one axis for outputs
    0..size-1 (mirrored with ``flip``): the clamped floor, its clamped
    neighbour and the weight of the neighbour."""
    o = torch.arange(size, device=device)
    o = (size - 1 - o if flip else o).to(torch.float32)
    f = fma(o + 0.5, step, start) - 0.5
    f = torch.minimum(torch.where(f < 0, 0.0, f),
                      torch.tensor(extent - 1, dtype=torch.float32,
                                   device=device))
    i = f.to(torch.int32)
    return i.long(), torch.where(i + 1 < extent, i + 1, i).long(), f - i.float()


def box_average(src: torch.Tensor, denom: int) -> torch.Tensor:
    """(H, W, 3) uint8 averaged over denom x denom blocks into (ceil(H /
    denom), ceil(W / denom), 3): each block's integer sum plus half its
    pixel count, divided by the count (blocks at the far edges are cut)."""
    h, w = src.shape[:2]
    hs, ws = -(-h // denom), -(-w // denom)
    total = torch.zeros((hs * denom, ws * denom, 3), dtype=torch.int64,
                        device=src.device)
    count = torch.zeros((hs * denom, ws * denom, 1), dtype=torch.int64,
                        device=src.device)
    total[:h, :w], count[:h, :w] = src, 1
    total = total.view(hs, denom, ws, denom, 3).sum((1, 3))
    count = count.view(hs, denom, ws, denom, 1).sum((1, 3))
    return torch.div(total + count // 2, count,
                     rounding_mode="floor").to(torch.uint8)


def _sample_crop(src: torch.Tensor, box: np.ndarray, flip: bool,
                 size: int) -> torch.Tensor:
    """The JAX core's ``sample_crop`` of one decoded (H, W, 3) uint8 image,
    in its compiled order of fp32 operations.  The box's scalars are
    numpy float32 (IEEE division included); the per-pixel work is plain
    tensor operations on ``src``'s device."""
    h, w = src.shape[:2]
    b = np.asarray(box, np.float32)
    if b[0] < 0:
        y0 = x0 = f32(0)
        sy, sx = f32(h) / f32(size), f32(w) / f32(size)
    else:
        y0, x0 = b[0] * f32(h), b[1] * f32(w)
        sy = f32(fma(b[2], f32(h), -y0)) / f32(size)
        sx = f32(fma(b[3], f32(w), -x0)) / f32(size)
    iy, iy1, wy = _axis_taps(size, y0, sy, h, False, src.device)
    ix, ix1, wx = _axis_taps(size, x0, sx, w, flip, src.device)
    wx, wy = wx[None, :, None], wy[:, None, None]

    def pix(rows, cols):
        return src[rows[:, None], cols[None, :]].float()

    top = fma(pix(iy, ix), 1.0 - wx, pix(iy, ix1) * wx)
    bot = fma(pix(iy1, ix), 1.0 - wx, pix(iy1, ix1) * wx)
    v = fma(top, 1.0 - wy, wy * bot)
    return (v + 0.5).to(torch.int32).to(torch.uint8)


def crop_resize_flip_reference(arena, offsets, sizes, boxes, flips,
                               out_size: int, denoms=None) -> torch.Tensor:
    """``crop_resize_flip_u8``'s plain twin, same arguments, on the arena's
    device (tensor operations a tile); returns the (B, S, S, 3) uint8
    tiles there."""
    arena = torch.as_tensor(arena)
    n = len(offsets)
    out = torch.zeros((n, out_size, out_size, 3), dtype=torch.uint8,
                      device=arena.device)
    boxes = np.asarray(boxes, np.float32).reshape(n, 4)
    denoms = np.ones(n, np.int32) if denoms is None else np.asarray(denoms)
    for i in range(n):
        h, w = int(sizes[i][0]), int(sizes[i][1])
        if h and w:
            src = arena[int(offsets[i]): int(offsets[i]) + h * w * 3]
            src = src.view(h, w, 3)
            if denoms[i] > 1:
                src = box_average(src, int(denoms[i]))
            out[i] = _sample_crop(src, boxes[i], bool(flips[i]), out_size)
    return out


def arena_offsets(sizes: np.ndarray) -> Tuple[np.ndarray, int]:
    """Each image's byte offset in an arena of interleaved RGB images of
    ``sizes`` (n, 2) = (H, W), one after another, and the arena's bytes."""
    nbytes = sizes[:, 0].astype(np.int64) * sizes[:, 1] * 3
    offsets = np.concatenate([[0], np.cumsum(nbytes)[:-1]]).astype(np.int64)
    return offsets, int(nbytes.sum())


def pack_arena(images: Sequence[Optional[np.ndarray]]
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decoded HWC uint8 images (None for a failure) as one flat arena with
    their byte offsets and (H, W) sizes (0 x 0 for a failure)."""
    sizes = np.array([im.shape[:2] if im is not None else (0, 0)
                      for im in images], np.int32).reshape(-1, 2)
    offsets, _ = arena_offsets(sizes)
    arena = np.concatenate([im.reshape(-1) for im in images if im is not None]
                           or [np.zeros(0, np.uint8)])
    return arena, offsets, sizes


def decode_crop_batch_plain(jpegs: Sequence[bytes], out_size: int,
                            crop_boxes: np.ndarray, flips: np.ndarray
                            ) -> Tuple[torch.Tensor, int]:
    """The plain twin of :func:`decode_crop_batch`: PIL decode at the JAX
    core's scale, then :func:`crop_resize_flip_reference`.  Returns the
    (B, S, S, 3) uint8 CPU tensor and the number of failures."""
    crop_boxes = np.asarray(crop_boxes, np.float32).reshape(-1, 4)
    images = [decode_rgb(jpeg_bytes(j), b, out_size)
              for j, b in zip(jpegs, crop_boxes)]
    arena, offsets, sizes = pack_arena(images)
    out = crop_resize_flip_reference(arena, offsets, sizes, crop_boxes, flips,
                                     out_size)
    return out, sum(im is None for im in images)


def jpeg_bytes(data) -> bytes:
    """A record's image as the bytes of its JPEG; raises unless it is
    encoded bytes."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        return bytes(data)
    raise TypeError("the native path reads JPEG records; this record's image "
                    f"is a {type(data).__name__} "
                    f"{getattr(data, 'shape', '')} (set DATA.NATIVE_PIPELINE "
                    "false for ndarray records)")


# ---------------------------------------------------------------------------
# The card: nvJPEG and crop_resize_flip_u8
# ---------------------------------------------------------------------------

def declare_crop(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the ctypes signatures of ``csrc/crop_resize.cuh``'s entry point,
    (arena, arena bytes, offsets, sizes, boxes, flips, denoms or NULL, n,
    size, out, device, stream) with the per-image arrays on the host, and
    of its limits: ``crop_max_size()``, the largest tile side;
    ``crop_images_per_launch()``; ``crop_bad_params()``, the entry's error
    for images it refuses."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.crop_resize_flip_u8.argtypes = [p, ctypes.c_longlong, p, p, p, p, p,
                                        i, i, p, i, p]
    for fn in (lib.crop_resize_flip_u8, lib.crop_max_size,
               lib.crop_images_per_launch, lib.crop_bad_params):
        fn.restype = i
    return lib


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the ctypes signatures of ``csrc/decode_crop.cu``'s entry points."""
    p, i = ctypes.c_void_p, ctypes.c_int
    declare_crop(lib)
    lib.nvjpeg_info.argtypes = [p, p, i, p]
    lib.nvjpeg_decode.argtypes = [p, p, i, p, p, p, p]
    for fn in (lib.nvjpeg_info, lib.nvjpeg_decode):
        fn.restype = i
    lib.decode_crop_error_string.argtypes = [i]
    lib.decode_crop_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    from clip_lite_torch.ops import _build

    return declare(_build.load("decode_crop"))


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed: "
                           + lib.decode_crop_error_string(err).decode())


def crop_arrays(offsets, sizes, boxes, flips, denoms=None) -> list:
    """The per-image arrays as ``crop_resize_flip_u8``'s C entry reads them
    (int64 offsets, (n, 2) int32 sizes, (n, 4) float32 boxes, uint8 flips,
    int32 denoms or None), contiguous on the host; raises unless each holds
    one entry an image."""
    n = len(offsets)
    arrays = []
    for a, dtype, per in ((offsets, np.int64, 1), (sizes, np.int32, 2),
                          (boxes, np.float32, 4), (flips, np.uint8, 1),
                          (denoms, np.int32, 1)):
        if a is not None:
            a = np.ascontiguousarray(a, dtype)
            if a.size != per * n:
                raise ValueError(f"{a.size} values where {n} images take "
                                 f"{per * n}")
        arrays.append(a)
    return arrays


@traced("crop_resize_flip_u8")
def crop_resize_flip_u8(arena: torch.Tensor, offsets, sizes, boxes, flips,
                        out_size: int, out: Optional[torch.Tensor] = None,
                        denoms=None) -> torch.Tensor:
    """Crop, bilinear resize and flip decoded images into (B, S, S, 3) uint8.

    ``arena`` is a flat uint8 tensor of interleaved RGB images; image i
    starts at byte ``offsets[i]`` and is ``sizes[i]`` = (H, W) (0 x 0: a
    failed decode, a zero tile); ``boxes[i]`` is its normalized (y0, x0, y1,
    x1) crop (y0 < 0: the whole image) and ``flips[i]`` mirrors the tile.
    Where ``denoms[i]`` (1, 2, 4 or 8; default 1) is above 1 the image is
    sampled as :func:`box_average` makes it.  The tiles go to ``out`` where
    given (a contiguous (B, S, S, 3) uint8 tensor on the arena's device),
    else to a new tensor.

    A CPU arena takes :func:`crop_resize_flip_reference`.  A CUDA arena
    launches the kernel on the current stream, ``crop_images_per_launch()``
    images a launch, for tiles of up to ``crop_max_size()`` (1024) a side,
    or raises (ValueError for parameters the kernel refuses: a denom other
    than 1, 2, 4 or 8, an image outside the arena); every launch adds one
    to ``crop_resize_flip_u8.launches``.
    """
    n = len(offsets)
    if arena.dtype != torch.uint8 or arena.ndim != 1:
        raise TypeError(f"the arena is a flat uint8 tensor, got "
                        f"{arena.dtype} {tuple(arena.shape)}")
    if out is not None and (tuple(out.shape) != (n, out_size, out_size, 3)
                            or out.dtype != torch.uint8
                            or out.device != arena.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous ({n}, {out_size}, "
                         f"{out_size}, 3) uint8 tensor on {arena.device}")
    if arena.device.type == "cpu":
        if denoms is not None and not np.isin(denoms, (1, 2, 4, 8)).all():
            raise ValueError(f"denoms are 1, 2, 4 or 8, got {denoms}")
        tiles = crop_resize_flip_reference(arena, offsets, sizes, boxes, flips,
                                           out_size, denoms)
        return tiles if out is None else out.copy_(tiles)
    if arena.device.type != "cuda" or not arena.is_contiguous():
        raise ValueError(f"no crop_resize_flip_u8 for a {arena.device} arena")
    lib = _library()
    if not 0 < out_size <= lib.crop_max_size():
        raise ValueError(f"crop_resize_flip_u8 makes tiles of 1 to "
                         f"{lib.crop_max_size()} pixels a side, not "
                         f"{out_size}")
    if out is None:
        out = torch.empty((n, out_size, out_size, 3), dtype=torch.uint8,
                          device=arena.device)
    if n == 0:
        return out
    arrays = crop_arrays(offsets, sizes, boxes, flips, denoms)
    err = lib.crop_resize_flip_u8(
        arena.data_ptr(), arena.numel(),
        *[None if a is None else a.ctypes.data for a in arrays], n, out_size,
        out.data_ptr(), arena.device.index,
        torch.cuda.current_stream(arena.device).cuda_stream)
    if err == lib.crop_bad_params():
        raise ValueError(lib.decode_crop_error_string(err).decode())
    _raise_on(lib, err, "crop_resize_flip_u8 launch")
    crop_resize_flip_u8.launches += -(-n // lib.crop_images_per_launch())
    return out


crop_resize_flip_u8.launches = 0


def nvjpeg_decode(jpegs: Sequence[bytes], device
                  ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """nvJPEG's decode (its GPU_HYBRID backend) of ``jpegs`` to interleaved
    RGB in one arena on the CUDA ``device``, on the current stream.  Returns the arena, each
    image's byte offset and (H, W): 0 x 0 where the JAX core or nvJPEG
    cannot decode it.  Every call adds one to ``nvjpeg_decode.launches``.
    """
    jpegs = [jpeg_bytes(j) for j in jpegs]
    n = len(jpegs)
    ptrs = (ctypes.c_char_p * n)(*jpegs)  # views of the bytes, kept alive
    lens = (ctypes.c_size_t * n)(*[len(j) for j in jpegs])
    sizes = np.zeros((n, 2), np.int32)
    lib = _library()
    with torch.cuda.device(device):
        _raise_on(lib, lib.nvjpeg_info(ptrs, lens, n, sizes.ctypes.data),
                  "nvjpeg_info")
        offsets, nbytes = arena_offsets(sizes)
        arena = torch.empty(max(1, nbytes), dtype=torch.uint8, device=device)
        _raise_on(lib, lib.nvjpeg_decode(
            ptrs, lens, n, arena.data_ptr(), offsets.ctypes.data,
            sizes.ctypes.data, torch.cuda.current_stream().cuda_stream),
            "nvjpeg_decode")
    nvjpeg_decode.launches += 1
    return arena, offsets, sizes


nvjpeg_decode.launches = 0


def decode_crop_batch(jpegs: Sequence[bytes], out_size: int,
                      crop_boxes: np.ndarray, flips: np.ndarray,
                      device="cuda", out: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, int]:
    """Decode, crop, resize and flip a batch of JPEGs into (B, S, S, 3)
    uint8 on ``device``: the JAX ``native.decode_crop_batch``.

    ``crop_boxes`` (B, 4) float32 normalized (y0, x0, y1, x1), y0 < 0 for
    the whole image; ``flips`` (B,) uint8.  Returns the tiles (``out``
    where given) and the number of JPEGs that did not decode (zero tiles).
    On a CUDA device: nvJPEG at full resolution, then
    ``crop_resize_flip_u8`` over blocks of the JAX core's DCT scale
    (:func:`scale_denoms`), on the current stream, or an error; on the CPU
    the plain twin.
    """
    from clip_lite_torch.eval_utils import resolve_device

    device = resolve_device(device)
    crop_boxes = np.asarray(crop_boxes, np.float32).reshape(-1, 4)
    flips = np.asarray(flips, np.uint8).reshape(-1)
    if device.type == "cpu":
        tiles, failures = decode_crop_batch_plain(jpegs, out_size, crop_boxes,
                                                  flips)
        return (tiles if out is None else out.copy_(tiles)), failures
    arena, offsets, sizes = nvjpeg_decode(jpegs, device)
    tiles = crop_resize_flip_u8(arena, offsets, sizes, crop_boxes, flips,
                                out_size, out=out,
                                denoms=scale_denoms(crop_boxes, sizes, out_size))
    return tiles, int((sizes[:, 0] == 0).sum())


__all__ = ["arena_offsets", "box_average", "crop_arrays",
           "crop_resize_flip_reference", "crop_resize_flip_u8",
           "decode_crop_batch", "decode_crop_batch_plain", "decode_rgb",
           "declare_crop", "fma", "full_image_boxes", "jpeg_bytes",
           "nvjpeg_decode", "pack_arena", "random_resized_crop_boxes",
           "scale_denom", "scale_denoms"]
