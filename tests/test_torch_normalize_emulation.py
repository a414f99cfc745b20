"""K3's CUDA source (``clip_lite_torch/ops/csrc/normalize.cu``) run on the
CPU against its plain twins: the standalone normalize in its four
variants, and the fused flip + colour jitter + normalize pass.

g++ compiles the source against the emulated CUDA of
``tests/cuda_emulation.py``: one thread per CUDA thread, the eight blocks
of one image's thread block cluster at once, their shared memory mapped
across the cluster, ``cluster.sync()`` a barrier.  The fused pass's one
shared-memory array becomes a pointer to the emulated block's memory,
and the standalone launch a call of the emulated launcher.  The
wrappers' own launch helpers (``normalize.launch_normalize``,
``normalize.launch_augment_normalize``) then run the C entry points on CPU
tensors.

Bars: the standalone normalize bit for bit with ``normalize_reference``,
as on the card.  The fused pass given the twin's own per-image contrast
means bit for bit with the plain composition (``augment_reference``): it
mirrors every rounding, and the twin divides by 255 and 6 as the kernel
does; with its own means (an exact integer sum, against the twin's fp32
mean of the brightened values) within 1e-4 on the normalized output,
``tests/test_torch_image_ops.py``'s bar.  This says nothing of the PTX's
syntax, the card's memory model or speed.  It skips where g++ with
C++20's ``<barrier>`` is missing.
"""

import ctypes

import numpy as np
import pytest
import torch
from cuda_emulation import (
    CSRC,
    emulation_dir,
    gxx,
    rewrite_launches,
    substitute,
)

from clip_lite_torch.ops import normalize
from clip_lite_torch.ops.image_ops import (
    AugDraws,
    augment_reference,
    random_flip,
)
from clip_lite_torch.ops.normalize import normalize_reference

AUG_ATOL = 1e-4  # on the normalized output


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    out = emulation_dir(tmp_path_factory)
    src = (CSRC / "normalize.cu").read_text()
    src = substitute(src, "extern __shared__ __align__(16) unsigned char "
                     "smem_raw[];", "unsigned char* smem_raw = emu_block_smem();")
    (out / "normalize.cu").write_text(rewrite_launches(src, "normalize.cu"))
    r = gxx(out, out / "normalize.cu", out / "libnormalize.so")
    assert r.returncode == 0, r.stderr[-4000:]
    return normalize.declare(ctypes.CDLL(str(out / "libnormalize.so")))


def _batch(in_dtype, shape, offset, seed=0):
    """A (B, H, W, 3) batch that starts ``offset`` elements into its
    buffer (1: misaligned for every vector width)."""
    g = torch.Generator().manual_seed(seed)
    n = int(np.prod(shape))
    if in_dtype == torch.uint8:
        buf = torch.randint(0, 256, (n + offset,), dtype=torch.uint8,
                            generator=g)
    else:
        buf = torch.rand(n + offset, generator=g) * 255.0
    return buf[offset:].view(shape)


# A ragged tail (H*W*3 = 75 and 225 values, not a multiple of 4 or 12),
# two blocks of units, one pixel an image.
SHAPES = [(2, 7, 8, 3), (3, 5, 5, 3), (1, 40, 40, 3), (4, 1, 1, 3)]


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset1"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["to-fp32", "to-bf16"])
@pytest.mark.parametrize("in_dtype", [torch.uint8, torch.float32],
                         ids=["u8", "fp32"])
def test_standalone_matches_reference_bit_for_bit(lib, in_dtype, out_dtype,
                                                  shape, offset):
    x = _batch(in_dtype, shape, offset)
    got = normalize.launch_normalize(lib, x, out_dtype, None)
    assert torch.equal(got, normalize_reference(x, out_dtype))


def _draws(b, seed):
    """Draws by the laws of AugDraws.sample, with flip and apply each
    taking both values in the batch."""
    rs = np.random.RandomState(seed)
    flip = np.arange(b) % 2 == 0
    apply = np.arange(b) % 3 != 1
    u = rs.rand(4, b).astype(np.float32)
    return AugDraws(
        flip=torch.from_numpy(flip), apply=torch.from_numpy(apply),
        brightness=torch.from_numpy(0.6 + 0.8 * u[0]),
        contrast=torch.from_numpy(0.6 + 0.8 * u[1]),
        saturation=torch.from_numpy(0.6 + 0.8 * u[2]),
        hue=torch.from_numpy(-0.1 + 0.2 * u[3]))


def _twin_means(images, draws, flip):
    """The plain composition's contrast means: each flipped image times its
    brightness, averaged in fp32 as random_color_jitter averages it."""
    if flip:
        images = random_flip(images, draws.flip)
    y = images.float() * draws.brightness.view(-1, 1, 1, 1)
    return y.mean(dim=(1, 2, 3))


def _u8(shape, seed):
    return torch.from_numpy(
        np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8))


# Odd sizes: 7 rows of 9 (one row a block, the eighth block idle, images
# that start off a 16-byte boundary); 100 rows of 90 (13 rows, two tiles a
# block); one pixel an image; rows too wide to stage in shared memory
# (read twice from memory instead).
FUSED_SHAPES = [(6, 7, 9, 3), (1, 100, 90, 3), (3, 1, 1, 3), (1, 3, 75001, 3)]


@pytest.mark.parametrize("shape", FUSED_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("flip,jitter", [(True, True), (True, False),
                                         (False, True), (False, False)])
def test_fused_pass_matches_plain_composition(lib, flip, jitter, shape):
    images = _u8(shape, seed=sum(shape))
    draws = _draws(shape[0], seed=shape[1])
    want = augment_reference(images, draws, flip, jitter)
    got = normalize.launch_augment_normalize(lib, images, draws, flip, jitter,
                                             None, None)
    assert got.dtype == torch.float32 and got.shape == images.shape
    assert (got - want).abs().max().item() <= AUG_ATOL
    if not jitter:
        assert torch.equal(got, want)  # no mean: exact
        return
    means = _twin_means(images, draws, flip)
    want = augment_reference(images, draws, flip, jitter, means)
    got = normalize.launch_augment_normalize(lib, images, draws, flip, jitter,
                                             means, None)
    assert torch.equal(got, want)


def test_fused_pass_own_means_are_the_exact_sums(lib):
    """With contrast 0 the jittered image is its mean before saturation and
    hue: a grey image (saturation 1, no hue shift) holds mu everywhere, and
    mu is the exact byte sum times the brightness over 3 H W."""
    images = _u8((2, 13, 11, 3), seed=4)
    b = images.shape[0]
    draws = AugDraws(flip=torch.zeros(b, dtype=torch.bool),
                     apply=torch.ones(b, dtype=torch.bool),
                     brightness=torch.tensor([0.75, 1.25]),
                     contrast=torch.zeros(b), saturation=torch.ones(b),
                     hue=torch.zeros(b))
    got = normalize.launch_augment_normalize(lib, images, draws, False, True,
                                             None, None)
    exact = (images.double().sum(dim=(1, 2, 3))
             * draws.brightness.double() / images[0].numel())
    means = exact.float()
    want = augment_reference(images, draws, False, True, means)
    assert torch.equal(got, want)


def test_fused_entry_point_refuses_missing_draws(lib):
    images = _u8((1, 2, 2, 3), seed=0)
    out = torch.empty(images.shape)
    args = [images.data_ptr(), out.data_ptr(), 1, 2, 2] + [None] * 7
    assert lib.augment_normalize_u8(*args, 1, 0, *[0.0] * 6, None) != 0
    assert lib.augment_normalize_u8(*args, 0, 1, *[0.0] * 6, None) != 0
    assert lib.augment_normalize_u8(images.data_ptr(), out.data_ptr(), 0, 2,
                                    2, *[None] * 7, 0, 0, *[0.0] * 6,
                                    None) != 0
