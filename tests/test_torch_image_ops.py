"""The port's on-device preprocessing (``clip_lite_torch/ops/image_ops.py``
and K3's wrapper ``ops/normalize.py``, its plain twin on the CPU) against
the JAX package's ``ops/image_ops.py`` and ``ops/pallas_kernels.py`` (the
Pallas kernel in interpret mode).

The augmentation draws are the JAX package's own: the test computes them
with ``jax.random`` along the split sequence of ``image_ops.py:140, 109``
and passes them to the port as :class:`AugDraws`.

Bars: normalize 1e-5 in fp32 and 1e-2 in bf16 (one bf16 rounding of
values up to 2.7); flip exact; jitter, hue and the whole of
``device_preprocess`` 1e-4 absolute on the normalized output (about 6e-3
on the 0-255 scale).  The readings (``python tests/test_torch_image_ops.py``
prints them): normalize 4.8e-7 apart in fp32, the hue rotation 1.1e-4
and the colour jitter 1.6e-4 on the 0-255 scale, ``device_preprocess``
with flip and jitter 2.9e-6 on the normalized output, the HSV round trip
6.0e-7 on the 0-1 scale (the port divides by 255 and 6 as a product with
the fp32 reciprocal, as eager PyTorch does on the card; JAX divides)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_lite_tpu.data import transforms as jtransforms
from clip_lite_tpu.ops import image_ops as jops
from clip_lite_tpu.ops.pallas_kernels import normalize_u8 as jnormalize_u8
from clip_lite_torch.data import transforms
from clip_lite_torch.ops import image_ops
from clip_lite_torch.ops.image_ops import AugDraws
from clip_lite_torch.ops.normalize import (
    augment_normalize_u8,
    normalize_reference,
    normalize_u8,
)

NORM_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
            torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
AUG_ATOL = 1e-4  # on the normalized output
SCALE_ATOL = 6e-3  # the same bar on the 0-255 scale


@pytest.fixture(autouse=True, scope="module")
def _threefry():
    """JAX's draws below are threefry's; another test in the same process
    may have switched the default PRNG to rbg."""
    with jax.default_prng_impl("threefry2x32"):
        yield


def jax_aug_draws(key, b: int) -> AugDraws:
    """The draws that JAX's ``device_preprocess(images, key, flip=True,
    color_jitter=True)`` makes for a batch of ``b``, as the port's
    :class:`AugDraws` (``image_ops.py:140, 46, 109-121, 131``)."""
    k_flip, k_jit = jax.random.split(key)
    k_apply, k_b, k_c, k_s, k_h = jax.random.split(k_jit, 5)

    def factor(k, f):
        return jax.random.uniform(k, (b, 1, 1, 1), minval=1 - f, maxval=1 + f)

    def tensor(x):
        return torch.from_numpy(np.asarray(x).reshape(b).copy())

    return AugDraws(
        flip=tensor(jax.random.bernoulli(k_flip, 0.5, (b,))),
        apply=tensor(jax.random.bernoulli(k_apply, 0.8, (b, 1, 1, 1))),
        brightness=tensor(factor(k_b, 0.4)),
        contrast=tensor(factor(k_c, 0.4)),
        saturation=tensor(factor(k_s, 0.4)),
        hue=tensor(jax.random.uniform(k_h, (b, 1, 1), minval=-0.1,
                                      maxval=0.1)))


def _u8(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


def _inputs(kind, shape, seed=0):
    imgs = _u8(seed, shape)
    if kind == "float32":
        # After the jitter the normalize takes floats in [0, 255].
        imgs = imgs.astype(np.float32) + np.random.RandomState(seed + 1).rand(
            *shape).astype(np.float32) * 0.99
    return imgs


def test_constants_equal_jax():
    assert transforms.IMAGENET_COLOR_MEAN == jtransforms.IMAGENET_COLOR_MEAN
    assert transforms.IMAGENET_COLOR_STD == jtransforms.IMAGENET_COLOR_STD


@pytest.mark.parametrize("kind", ["uint8", "float32"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 16, 32, 3), (2, 7, 8, 3)],
                         ids=["2x16x32", "ragged-2x7x8"])
def test_normalize_matches_jax(kind, dtype, shape):
    """normalize_u8 (the plain twin on the CPU) against JAX's
    normalize_images and the Pallas kernel in interpret mode (8-row
    blocks: 14 rows leave a ragged last block)."""
    imgs = _inputs(kind, shape)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want_xla = np.asarray(jops.normalize_images(jnp.asarray(imgs), jdtype),
                          np.float32)
    want_pallas = np.asarray(jnormalize_u8(jnp.asarray(imgs), dtype=jdtype,
                                           block_rows=8, interpret=True),
                             np.float32)
    got = normalize_u8(torch.from_numpy(imgs), dtype)
    assert got.dtype == dtype and got.shape == shape and got.is_contiguous()
    for want in (want_xla, want_pallas):
        np.testing.assert_allclose(got.float().numpy(), want,
                                   **NORM_TOL[dtype])


def test_normalize_constants_are_the_pallas_kernels():
    """The twin uses the Pallas kernel's fp32 constants: in fp32 the two
    agree exactly on every uint8 value."""
    imgs = np.arange(256, dtype=np.uint8)[None, None, :, None].repeat(3, -1)
    got = normalize_reference(torch.from_numpy(imgs)).numpy()
    want = np.asarray(jnormalize_u8(jnp.asarray(imgs), interpret=True))
    np.testing.assert_array_equal(got, want)


def test_normalize_rejects_what_k3_does_not_take():
    with pytest.raises(ValueError):
        normalize_u8(torch.zeros(2, 4, 4, 4, dtype=torch.uint8))
    with pytest.raises(ValueError):
        normalize_u8(torch.zeros(4, 4, 3, dtype=torch.uint8))
    with pytest.raises(TypeError):
        normalize_u8(torch.zeros(2, 4, 4, 3, dtype=torch.float16))
    with pytest.raises(TypeError):
        normalize_u8(torch.zeros(2, 4, 4, 3, dtype=torch.uint8),
                     torch.float16)


def test_cpu_wrapper_counts_no_launch():
    before = normalize_u8.launches
    normalize_u8(torch.zeros(1, 2, 2, 3, dtype=torch.uint8))
    assert normalize_u8.launches == before


@pytest.mark.parametrize("seed", [0, 1])
def test_random_flip_matches_jax(seed):
    imgs = _u8(3 + seed, (16, 4, 6, 3))
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jops.random_flip(jnp.asarray(imgs), key))
    flips = torch.from_numpy(np.asarray(jax.random.bernoulli(key, 0.5, (16,))))
    assert 0 < int(flips.sum()) < 16
    got = image_ops.random_flip(torch.from_numpy(imgs), flips)
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_hue_matches_jax():
    imgs = _u8(7, (8, 6, 6, 3)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    want = np.asarray(jops.random_hue(jnp.asarray(imgs), key, hue=0.4))
    shift = jax.random.uniform(key, (8, 1, 1), minval=-0.4, maxval=0.4)
    got = image_ops.random_hue(
        torch.from_numpy(imgs), torch.from_numpy(np.asarray(shift).reshape(8).copy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SCALE_ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_color_jitter_matches_jax(seed):
    imgs = _u8(10 + seed, (16, 8, 8, 3))
    key = jax.random.PRNGKey(seed)
    _, k_jit = jax.random.split(key)
    want = np.asarray(jops.random_color_jitter(jnp.asarray(imgs), k_jit))
    draws = jax_aug_draws(key, 16)
    assert 0 < int(draws.apply.sum()) < 16  # both branches taken
    got = image_ops.random_color_jitter(torch.from_numpy(imgs), draws)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SCALE_ATOL)


@pytest.mark.parametrize("flip,jitter", [(True, True), (True, False),
                                         (False, True), (False, False)])
@pytest.mark.parametrize("seed", [0, 2])
def test_device_preprocess_matches_jax(seed, flip, jitter):
    imgs = _u8(20 + seed, (16, 12, 10, 3))
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jops.device_preprocess(jnp.asarray(imgs), key, flip=flip,
                                             color_jitter=jitter))
    got = image_ops.device_preprocess(torch.from_numpy(imgs),
                                      jax_aug_draws(key, 16), flip=flip,
                                      color_jitter=jitter)
    assert got.dtype == torch.float32 and got.shape == imgs.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=AUG_ATOL)


def test_device_preprocess_without_draws_normalizes_only():
    imgs = torch.from_numpy(_u8(30, (2, 5, 5, 3)))
    np.testing.assert_array_equal(
        image_ops.device_preprocess(imgs, None, flip=True,
                                    color_jitter=True).numpy(),
        normalize_reference(imgs).numpy())


def test_random_color_jitter_given_its_own_means_is_bit_identical():
    """The ``mean`` argument (which lets a test give the twin and K3's
    fused pass the same contrast means) changes nothing when it holds the
    means the twin computes itself."""
    imgs = torch.from_numpy(_u8(12, (16, 9, 7, 3)))
    draws = jax_aug_draws(jax.random.PRNGKey(3), 16)
    means = (imgs.float() * draws.brightness.view(-1, 1, 1, 1)).mean(
        dim=(1, 2, 3))
    assert torch.equal(image_ops.random_color_jitter(imgs, draws, means),
                       image_ops.random_color_jitter(imgs, draws))


@pytest.mark.parametrize("with_draws", [True, False],
                         ids=["draws", "no-draws"])
def test_device_preprocess_on_cpu_launches_no_kernel(with_draws):
    """CPU tensors take the plain composition: neither K3 entry point
    counts a launch."""
    imgs = torch.from_numpy(_u8(31, (4, 6, 5, 3)))
    draws = jax_aug_draws(jax.random.PRNGKey(1), 4) if with_draws else None
    before = normalize_u8.launches, augment_normalize_u8.launches
    got = image_ops.device_preprocess(imgs, draws, flip=True,
                                      color_jitter=True)
    assert (normalize_u8.launches, augment_normalize_u8.launches) == before
    want = (image_ops.augment_reference(imgs, draws) if with_draws
            else normalize_reference(imgs))
    assert torch.equal(got, want)


def test_aug_draws_laws():
    """Drawn from a StepRNG: shapes, ranges, the Bernoulli rates within
    5 sigma over 4096 images, a function of (seed, step)."""
    from clip_lite_torch.ops.layers import StepRNG

    d = AugDraws.sample(StepRNG(0, 3, "cpu"), 4096)
    again = AugDraws.sample(StepRNG(0, 3, "cpu"), 4096)
    other = AugDraws.sample(StepRNG(0, 4, "cpu"), 4096)
    assert torch.equal(d.brightness, again.brightness)
    assert not torch.equal(d.brightness, other.brightness)
    assert d.flip.dtype == torch.bool and d.flip.shape == (4096,)
    assert abs(d.flip.float().mean().item() - 0.5) < 5 * (0.25 / 4096) ** 0.5
    assert abs(d.apply.float().mean().item() - 0.8) < 5 * (0.16 / 4096) ** 0.5
    for x in (d.brightness, d.contrast, d.saturation):
        assert 0.6 <= x.min().item() and x.max().item() < 1.4
    assert -0.1 <= d.hue.min().item() and d.hue.max().item() < 0.1


def test_hsv_round_trip_identity():
    rgb = np.random.RandomState(5).rand(32, 4, 4, 3).astype(np.float32)
    h, s, v = image_ops._rgb_to_hsv(torch.from_numpy(rgb))
    back = image_ops._hsv_to_rgb(h, s, v)
    np.testing.assert_allclose(back.numpy(), rgb, atol=1e-5)
    jh, js, jv = jops._rgb_to_hsv(jnp.asarray(rgb))
    for got, want in ((h, jh), (s, js), (v, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


if __name__ == "__main__":
    # The readings behind the bars above: over this file's cases, the
    # largest gap between the port and JAX.  Run from the root of the repo:
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_image_ops.py
    with jax.default_prng_impl("threefry2x32"):
        norm = 0.0
        for kind in ("uint8", "float32"):
            for shape in ((2, 16, 32, 3), (2, 7, 8, 3)):
                imgs = _inputs(kind, shape)
                want = np.asarray(jops.normalize_images(jnp.asarray(imgs)))
                got = normalize_u8(torch.from_numpy(imgs)).numpy()
                norm = max(norm, float(np.abs(got - want).max()))
        hue_imgs = _u8(7, (8, 6, 6, 3)).astype(np.float32)
        key = jax.random.PRNGKey(0)
        shift = jax.random.uniform(key, (8, 1, 1), minval=-0.4, maxval=0.4)
        hue = float(np.abs(image_ops.random_hue(
            torch.from_numpy(hue_imgs),
            torch.from_numpy(np.asarray(shift).reshape(8).copy())).numpy()
            - np.asarray(jops.random_hue(jnp.asarray(hue_imgs), key,
                                         hue=0.4))).max())
        jitter = pre = 0.0
        for seed in (0, 1, 2):
            imgs = _u8(20 + seed, (16, 12, 10, 3))
            key = jax.random.PRNGKey(seed)
            draws = jax_aug_draws(key, 16)
            _, k_jit = jax.random.split(key)
            jitter = max(jitter, float(np.abs(
                image_ops.random_color_jitter(torch.from_numpy(imgs),
                                              draws).numpy()
                - np.asarray(jops.random_color_jitter(jnp.asarray(imgs),
                                                      k_jit))).max()))
            pre = max(pre, float(np.abs(
                image_ops.device_preprocess(torch.from_numpy(imgs), draws,
                                            color_jitter=True).numpy()
                - np.asarray(jops.device_preprocess(
                    jnp.asarray(imgs), key, color_jitter=True))).max()))
        rgb = np.random.RandomState(5).rand(32, 4, 4, 3).astype(np.float32)
        trip = float(np.abs(image_ops._hsv_to_rgb(*image_ops._rgb_to_hsv(
            torch.from_numpy(rgb))).numpy() - rgb).max())
        print(f"normalize fp32 vs JAX: {norm}")
        print(f"random_hue (0-255 scale): {hue}")
        print(f"random_color_jitter (0-255 scale): {jitter}")
        print(f"device_preprocess, flip + jitter (normalized): {pre}")
        print(f"HSV round trip (0-1 scale): {trip}")
