"""The native JPEG batch path (clip_lite_torch/data/native.py, DATA.NATIVE_PIPELINE)
on the CPU against the JAX package's (clip_lite_tpu/data/native.py over its
C++ core, native/libclrec_core.so):

* ``random_resized_crop_boxes`` draws the JAX function's numbers;
* ``fma`` rounds once, as libm's ``fmaf``;
* the plain twin ``decode_crop_batch_plain`` equals the JAX core's
  ``decode_crop_batch`` bit for bit: 480 x 640 and 640 x 480 sources at
  4:2:0 and 4:2:2, 4:4:4, progressive, greyscale, the JAX package's own
  OpenCV encode, a 1280 x 960 source whose crop takes the JAX core's
  DCT-domain scaled decode (the twin's ``Image.draft``), a truncated
  baseline JPEG (both decode what is there), train boxes, whole-image
  boxes, 1 x 1 crops and crops against each border, flips on and off, at
  224, 32 and 1; CMYK and bytes that are no JPEG give zero tiles and the
  same failure counts.  PIL's libjpeg-turbo (3.x, bundled) and the
  system's (2.1, which the JAX core links) decode these bit for bit: the
  bar is equality.  A truncated progressive JPEG is the one difference
  found: both decode it, PIL's partial scan differs by a few levels;
* ``CocoCaptionsDataset.load_batch``, the loader over two epochs (with
  DATA.SEQ_BUCKETS and the length-grouped shuffle, in the background and
  not), the device cache's ``load_host`` equal the JAX package's on JPEG
  CLRec records: ids, tokens and uint8 images exactly;
* the host cache's key tells the native tiles from the Python path's, and
  a card's decode from the CPU's; the native tiles go through the host
  cache and back;
* the card's stand-in for the scaled decode (nvJPEG's full image averaged
  over blocks of the JAX core's scale) lands within the decode bars of
  the JAX core's tiles on textured photos, and sampling the full image
  as it is does not;
* the training CLI runs DATA.NATIVE_PIPELINE through the loader and
  through DATA.DEVICE_CACHE;
* ``crop_resize_flip_u8``'s CUDA source (``csrc/crop_resize.cuh``) compiled
  by g++ against ``tests/cuda_emulation.py`` equals the twin bit for bit at
  the tiling's edges (B = 1, S = 1, boxes against each border, failed
  decodes in the middle of a batch, images of 1 x 1), rows of widths that
  are no multiple of 4 or 16 bytes in an arena and tiles at odd
  addresses, tiles of several bands, up- and down-sampling, also averaging
  over blocks of 1, 2, 4 and 8 with ragged blocks at the far edges; built
  a second time with its shared memory squeezed, so that the same images
  take its column tiles and runs of rows; its entry refuses what it does
  not take;
* ``scale_denoms`` over a batch equals ``scale_denom`` image by image.

The JAX core's tests are skipped where its library is not built, as
``tests/test_native.py`` skips.
"""

import ctypes
import io
import os

import numpy as np
import pytest
import torch
from cuda_emulation import (
    CSRC,
    emulate_cp_async,
    emulation_dir,
    gxx,
    rewrite_launches,
    substitute,
)
from PIL import Image

import jax  # noqa: F401  (the JAX package's modules expect it loaded)

from clip_lite_tpu.config import Config as JConfig
from clip_lite_tpu.data import native as jnative
from clip_lite_tpu.data import pipeline as jpipeline
from clip_lite_tpu.data import readers as jreaders
from clip_lite_tpu.data.device_cache import DeviceDataCache as JDeviceDataCache
from clip_lite_tpu.factories import PretrainingDatasetFactory as JFactory
from clip_lite_torch.config import Config
from clip_lite_torch.data import native, pipeline
from clip_lite_torch.data.device_cache import host_cache_key, load_host
from clip_lite_torch.data.readers import ClRecWriter
from clip_lite_torch.factories import PretrainingDatasetFactory
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


pytestmark = pytest.mark.skipif(
    not jnative.native_available(), reason="native library not built")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "configs", "fs_bs1024_ni250k.yaml")
B, N_TRAIN, N_VAL, CROP = 4, 14, 6, 32
WORDS = ("a an the man woman child dog cat horse bus train car plate pizza "
         "table street city field beach kitchen red blue white").split()


def photo(h, w, seed=0):
    """A smooth seeded RGB image with noise: what a JPEG codec is built
    for, so that chroma subsampling and rounding matter."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f, p = rng.uniform(0.005, 0.08, 6), rng.uniform(0, 6, 3)
    img = np.stack([np.sin(xx * f[c] + p[c]) * np.cos(yy * f[3 + c])
                    for c in range(3)], axis=-1)
    return np.clip((img + 1) * 127.5 + rng.normal(0, 6, img.shape),
                   0, 255).astype(np.uint8)


def jpeg(image, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, "JPEG", **kw)
    return buf.getvalue()


def cmyk_jpeg() -> bytes:
    buf = io.BytesIO()
    Image.fromarray(photo(40, 48, 9)).convert("CMYK").save(buf, "JPEG")
    return buf.getvalue()


SOURCES = {
    "480x640_420": lambda: jpeg(photo(480, 640, 1), quality=90),
    "640x480_422": lambda: jpeg(photo(640, 480, 2), quality=90, subsampling=1),
    "444": lambda: jpeg(photo(61, 83, 3), quality=95, subsampling=0),
    "progressive": lambda: jpeg(photo(480, 640, 4), quality=85,
                                progressive=True),
    "greyscale": lambda: jpeg(photo(480, 640, 5)[..., 1], quality=90),
    "jax_encode_image": lambda: jreaders.encode_image(photo(64, 48, 6)),
    "1280x960_scaled": lambda: jpeg(photo(960, 1280, 7), quality=90),
    "truncated": lambda: jpeg(photo(480, 640, 8), quality=90)[:9000],
    "cmyk": cmyk_jpeg,
    "no_jpeg": lambda: b"\xff\xd8" + bytes(100),
    "png": lambda: (lambda b: (Image.fromarray(photo(8, 8)).save(b, "PNG"),
                               b.getvalue())[1])(io.BytesIO()),
    # Cut inside the scan's header: no image in either.
    "cut_in_header": lambda: (lambda b: b[:b.index(b"\xff\xda") + 5])(
        jpeg(photo(48, 64, 10), quality=90)),
    # A scan of restart markers only: libjpeg decodes it (nvJPEG refuses
    # it on the card, a deliberate difference).
    "restart_markers": lambda: (lambda b: b[:b.index(b"\xff\xda") + 14]
                                + b"\xff\xd0\xff\xd3" * 200 + b"\xff\xd9")(
        jpeg(photo(48, 64, 11), quality=90)),
}
FAILING = ("cmyk", "cut_in_header", "no_jpeg", "png")


@pytest.fixture(scope="module")
def sources():
    return {k: make() for k, make in SOURCES.items()}


def edge_boxes(n):
    """Crops against each border in turn, 1 x 1-pixel ones among them."""
    cases = np.array([[0.0, 0.0, 0.3, 0.2], [0.7, 0.8, 1.0, 1.0],
                      [0.0, 0.6, 1.0, 1.0], [0.4, 0.0, 1.0, 0.5],
                      [0.5, 0.5, 0.5005, 0.5005], [0.999, 0.0, 1.0, 0.001],
                      [0.0, 0.999, 0.001, 1.0], [0.0, 0.0, 1.0, 1.0]],
                     np.float32)
    return cases[np.arange(n) % len(cases)]


BOXES = {
    "train": lambda n: jnative.random_resized_crop_boxes(
        np.random.default_rng(n), n),
    "full": lambda n: np.full((n, 4), -1.0, np.float32),
    "edges": edge_boxes,
}


def test_crop_boxes_equal_jax():
    for seed, n in ((0, 1), (1, 7), (2, 128)):
        got = native.random_resized_crop_boxes(np.random.default_rng(seed), n)
        want = jnative.random_resized_crop_boxes(np.random.default_rng(seed), n)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert (native.full_image_boxes(3) < 0).all()


def test_fma_rounds_once():
    libm = ctypes.CDLL("libm.so.6")
    libm.fmaf.argtypes = [ctypes.c_float] * 3
    libm.fmaf.restype = ctypes.c_float
    rng = np.random.default_rng(0)
    n = 4000
    a = (rng.uniform(0, 300, n) * rng.choice([1, 1e-3, 1e-6], n)).astype(np.float32)
    b = rng.uniform(-3, 3, n).astype(np.float32)
    c = (rng.uniform(-700, 700, n) * rng.choice([1, 1e-5], n)).astype(np.float32)
    # Products exactly half an ulp off c's grid: ties of the one rounding.
    a[:50], b[:50] = np.float32(1 + 2.0 ** -12), np.float32(1 + 2.0 ** -12)
    c[:50] = np.float32(-1)
    got = native.fma(a, b, c).numpy()
    want = np.array([libm.fmaf(x, y, z) for x, y, z in zip(a, b, c)],
                    np.float32)
    np.testing.assert_array_equal(got, want)
    separate = a * b + c  # two roundings: differs somewhere
    assert (separate != want).any()


def _both(jpegs, out_size, boxes, flips):
    want, want_fail = jnative.decode_crop_batch(jpegs, out_size, boxes, flips,
                                                num_threads=2)
    got, got_fail = native.decode_crop_batch_plain(jpegs, out_size, boxes,
                                                   flips)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    return got.numpy(), got_fail, want, want_fail


@pytest.mark.parametrize("boxes", sorted(BOXES))
@pytest.mark.parametrize("out_size", [224, 32, 1])
def test_plain_twin_equals_jax_core(sources, out_size, boxes):
    names = sorted(sources)
    jpegs = [sources[k] for k in names]
    box = BOXES[boxes](len(names))
    for flip in (0, 1):
        flips = np.full(len(names), flip, np.uint8)
        got, got_fail, want, want_fail = _both(jpegs, out_size, box, flips)
        assert got_fail == want_fail == len(FAILING)
        for i, name in enumerate(names):
            np.testing.assert_array_equal(got[i], want[i], err_msg=name)
            if name in FAILING:
                assert not got[i].any(), name


def test_scaled_decode_is_taken(sources):
    """The 1280 x 960 source takes the JAX core's 1/2 decode for a whole
    image at 224 and 1/8 at 32; the COCO-sized ones take none at 224."""
    full = np.full(4, -1.0, np.float32)
    assert native.scale_denom(full, 960, 1280, 224) == 2
    assert native.scale_denom(full, 960, 1280, 32) == 8
    assert native.scale_denom(full, 480, 640, 224) == 1
    assert native.scale_denom(full, 480, 640, 256) == 1
    assert native.scale_denom(full, 640, 640, 224) == 2  # 640 >= 2.6 x 224
    rgb = native.decode_rgb(sources["1280x960_scaled"], full, 224)
    assert rgb.shape == (480, 640, 3)


def textured(h, w, seed):
    """:func:`photo` with a 1/f-like luminance texture (noise fields at 1
    to 1/32 of the resolution, 30 levels in all), as chip_smoke.py's
    photo_jpeg: a photo's bytes, detail that a resample can alias."""
    rng = np.random.default_rng(seed)
    tex = np.zeros((h, w), np.float32)
    for k in range(6):
        f = rng.normal(0, 1, (-(-h >> k), -(-w >> k))).astype(np.float32)
        tex += f.repeat(1 << k, 0).repeat(1 << k, 1)[:h, :w]
    return np.clip(photo(h, w, seed) + 30 / np.sqrt(6) * tex[..., None],
                   0, 255).astype(np.uint8)


@pytest.mark.parametrize("shape", [(640, 640), (960, 1280)])
def test_block_average_stands_in_for_the_scaled_decode(shape):
    """The card decodes at full resolution and averages over blocks of the
    JAX core's DCT scale (scale_denoms).  Against the JAX core's scaled
    decode, on textured photos at 224 (1/2) and 32 (1/8), train and whole
    boxes, that lands within the card's decode bars (mean |d| <= 1 level,
    PSNR >= 40 dB a tile; they read 0.58-0.67 and 47-48 dB); the
    full image sampled as it is would not (6-15 levels, 23-30 dB)."""
    data = jpeg(textured(*shape, seed=shape[0]), quality=90)
    flips = np.zeros(4, np.uint8)
    for boxes in (native.full_image_boxes(4), BOXES["train"](4)):
        for size in (224, 32):
            want, _ = jnative.decode_crop_batch([data] * 4, size, boxes, flips,
                                                num_threads=2)
            full = native.decode_rgb(data, boxes[0], size, scaled=False)
            arena, offsets, sizes = native.pack_arena([full] * 4)
            denoms = native.scale_denoms(boxes, sizes, size)
            assert (denoms > 1).all() if size == 32 else (denoms > 1).any()
            for d, bar in ((denoms, True), (None, False)):
                got = native.crop_resize_flip_reference(
                    torch.from_numpy(arena), offsets, sizes, boxes, flips,
                    size, d).numpy()
                diff = (got.astype(float) - want).reshape(4, -1)[denoms > 1]
                mean = np.abs(diff).mean(1)
                psnr = 10 * np.log10(255.0 ** 2 / (diff ** 2).mean(1))
                within = (mean <= 1.0) & (psnr >= 40.0)
                assert within.all() if bar else not within.any(), (
                    boxes[0], size, d, mean, psnr)


def test_truncated_progressive_decodes_in_both(sources):
    """The one difference found: a progressive JPEG cut short decodes in
    both (no failure), PIL's partial scan a few levels from libjpeg's."""
    data = jpeg(photo(480, 640, 8), quality=90, progressive=True)[:9000]
    box = np.full((1, 4), -1.0, np.float32)
    got, got_fail, want, want_fail = _both([data], 64, box,
                                           np.zeros(1, np.uint8))
    assert got_fail == want_fail == 0
    assert np.abs(got.astype(int) - want).mean() < 2.0


def test_record_images_must_be_bytes():
    with pytest.raises(TypeError, match="JPEG records"):
        native.decode_crop_batch_plain([np.zeros((4, 4, 3), np.uint8)], 8,
                                       native.full_image_boxes(1),
                                       np.zeros(1, np.uint8))


def test_wrappers_on_the_cpu(sources):
    """``decode_crop_batch`` on the CPU is the twin, written into ``out``
    when given; ``crop_resize_flip_u8`` on a CPU arena is its twin; the
    default device is CUDA, which raises where there is none."""
    jpegs = [sources["480x640_420"], sources["cmyk"]]
    boxes, flips = BOXES["train"](2), np.array([1, 0], np.uint8)
    twin, fails = native.decode_crop_batch_plain(jpegs, 16, boxes, flips)
    out = torch.full((2, 16, 16, 3), 7, dtype=torch.uint8)
    got, got_fails = native.decode_crop_batch(jpegs, 16, boxes, flips,
                                              device="cpu", out=out)
    assert got is out and got_fails == fails == 1 and torch.equal(got, twin)
    images = [native.decode_rgb(j, b, 16) for j, b in zip(jpegs, boxes)]
    arena, offsets, sizes = native.pack_arena(images)
    tiles = native.crop_resize_flip_u8(torch.from_numpy(arena), offsets, sizes,
                                       boxes, flips, 16)
    assert torch.equal(tiles, twin)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            native.decode_crop_batch(jpegs, 16, boxes, flips)


# ---------------------------------------------------------------------------
# The dataset, the loader and the cache on JPEG records
# ---------------------------------------------------------------------------

def write_jpeg_corpus(root, n_train=N_TRAIN, n_val=N_VAL, seed=0):
    """Train and val CLRec files of JPEG records (48 x 64 and 64 x 48 in
    turn, one greyscale and one CMYK among them), 1-5 captions of 2-9
    words each."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        path = os.path.join(str(root), f"coco_{split}_train_sbert2017.clrec")
        with ClRecWriter(path) as w:
            for i in range(n):
                image = photo(*((48, 64) if i % 2 == 0 else (64, 48)),
                              seed=100 * (split == "val") + i)
                data = (cmyk_jpeg() if i == 3 else
                        jpeg(image[..., 0] if i == 5 else image, quality=90))
                captions = [" ".join(rng.choice(WORDS, rng.integers(2, 10)))
                            for _ in range(1 + i % 5)]
                w.append({"image_id": 1000 * (split == "val") + i,
                          "image": data, "captions": captions})
    return str(root)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_jpeg_corpus(tmp_path_factory.mktemp("jpeg_corpus"))


TINY = ["DATA.IMAGE_CROP_SIZE", CROP, "DATA.MAX_CAPTION_LENGTH", 16,
        "MODEL.TEXTUAL.VOCAB_SIZE", 512]


def overrides(root, *extra, native_path=True):
    return (["MODEL.NAME", "captions", "DATA.ROOT", root,
             "DATA.NATIVE_PIPELINE", native_path] + TINY + list(extra))


def _datasets(over, split="train"):
    ours = PretrainingDatasetFactory.from_config(Config(FLAGSHIP, over), split,
                                                 device="cpu")
    theirs = JFactory.from_config(JConfig(FLAGSHIP, over), split)
    assert ours.native_pipeline and theirs.native_pipeline
    return ours, theirs


def _same_batch(ours, theirs):
    assert list(ours) == list(theirs) == ["image_id", "image", "input_ids",
                                          "attention_mask"]
    for k in ours:
        np.testing.assert_array_equal(torch.as_tensor(ours[k]).numpy(),
                                      theirs[k], err_msg=k)
    assert ours["image"].dtype == torch.uint8


@pytest.mark.parametrize("case", ["train", "val", "single_caption"])
def test_load_batch_equals_jax(corpus, case):
    extra = ["DATA.USE_SINGLE_CAPTION", True] if case == "single_caption" else []
    split = "val" if case == "val" else "train"
    ours, theirs = _datasets(overrides(corpus, *extra), split)
    for epoch, idxs in ((0, [0, 1, 2, 3]), (1, [5, 3, 0, 4]), (2, [2])):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = ours.load_batch(np.asarray(idxs)), theirs.load_batch(idxs)
        _same_batch(got, want)
        assert got["image"].shape == (len(idxs), CROP, CROP, 3)
        for j, i in enumerate(idxs):  # record 3 is CMYK: a zero tile
            assert bool(got["image"][j].any()) == (i != 3)


LOADER_CASES = {
    "plain": [],
    "buckets": ["DATA.SEQ_BUCKETS", [8, 12], "DATA.LENGTH_GROUP_BATCHES", 2],
}


@pytest.mark.parametrize("background", [True, False],
                         ids=["background", "foreground"])
@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_loader_equals_jax_over_two_epochs(corpus, case, background):
    over = overrides(corpus, *LOADER_CASES[case])
    ds, jds = _datasets(over)
    cfg = Config(FLAGSHIP, over)
    group = cfg.DATA.LENGTH_GROUP_BATCHES if cfg.DATA.SEQ_BUCKETS else 0
    ours = pipeline.DataLoader(ds, B, shuffle=True, num_workers=2, seed=7,
                               background=background,
                               length_group_batches=group)
    theirs = jpipeline.DataLoader(jds, B, shuffle=True, num_workers=2, seed=7,
                                  background=False, length_group_batches=group,
                                  num_shards=1, shard_index=0)
    widths = []
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == N_TRAIN // B
        for a, b in zip(got, want):
            _same_batch(a, b)
            widths.append(a["input_ids"].shape[1])
    if case == "buckets":
        assert set(widths) <= {8, 12, 16} and len(set(widths)) > 1


def test_val_loader_equals_jax(corpus):
    ds, jds = _datasets(overrides(corpus), "val")
    ours = pipeline.DataLoader(ds, B, shuffle=False, seed=7)
    theirs = jpipeline.DataLoader(jds, B, shuffle=False, seed=7,
                                  background=False, num_shards=1,
                                  shard_index=0)
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == N_VAL // B
    for a, b in zip(got, want):
        _same_batch(a, b)


@pytest.mark.parametrize("rows", [None, [5, 0, 3, 11]])
def test_load_host_equals_jax(corpus, rows, monkeypatch):
    ds, jds = _datasets(overrides(corpus))
    rows = np.arange(len(ds)) if rows is None else np.asarray(rows)
    monkeypatch.setattr("clip_lite_torch.data.device_cache.NATIVE_CHUNK", 3)
    ours = load_host(ds, 40, rows)  # chunks of 3 records
    images, ids, mask, n_caps, image_ids = JDeviceDataCache._load_host(
        jds, 40, rows)
    assert isinstance(ours.images, torch.Tensor)
    np.testing.assert_array_equal(ours.images.numpy(), images)
    np.testing.assert_array_equal(ours.n_caps, n_caps)
    np.testing.assert_array_equal(ours.image_ids, image_ids)
    for ours_list, theirs_list in ((ours.ids, ids), (ours.mask, mask)):
        for a, b in zip(ours_list, theirs_list):
            np.testing.assert_array_equal(a, b)


def test_host_cache_key_tells_native_from_python(corpus):
    rows = np.arange(N_TRAIN)
    nat, _ = _datasets(overrides(corpus))
    py = PretrainingDatasetFactory.from_config(
        Config(FLAGSHIP, overrides(corpus, native_path=False)), "train")
    assert not py.native_pipeline
    assert host_cache_key(nat, 40, rows) != host_cache_key(py, 40, rows)
    again, _ = _datasets(overrides(corpus))
    assert host_cache_key(again, 40, rows) == host_cache_key(nat, 40, rows)


def test_host_cache_key_tells_card_decode_from_cpu_decode(corpus):
    """nvJPEG's tiles (a card) are not the JAX core's scaled libjpeg tiles
    (the CPU twin): a cache written by one is not read by the other."""
    import copy

    rows = np.arange(N_TRAIN)
    cpu, _ = _datasets(overrides(corpus))
    card = copy.copy(cpu)
    card.device = torch.device("cuda")  # the key reads the device type only
    py = PretrainingDatasetFactory.from_config(
        Config(FLAGSHIP, overrides(corpus, native_path=False)), "train")
    keys = {host_cache_key(d, 40, rows) for d in (cpu, card, py)}
    assert len(keys) == 3


def test_host_cache_round_trip_native(corpus, tmp_path):
    """The native tiles (a tensor) go to the host cache as an .npy and come
    back memory-mapped, equal."""
    from clip_lite_torch.data.device_cache import load_host_cached

    ds, _ = _datasets(overrides(corpus))
    rows = np.arange(6)
    first = load_host_cached(ds, 40, rows, str(tmp_path))
    assert isinstance(first.images, torch.Tensor)
    again = load_host_cached(ds, 40, rows, str(tmp_path))
    assert isinstance(again.images, np.memmap)
    np.testing.assert_array_equal(again.images, first.images.numpy())
    np.testing.assert_array_equal(again.image_ids, first.image_ids)


@pytest.mark.parametrize("cache", [False, True], ids=["loader", "device_cache"])
def test_cli_trains_on_the_native_path(corpus, tmp_path, cache, monkeypatch):
    from test_torch_cli import _args

    from clip_lite_torch.data import datasets
    from clip_lite_torch.train import main

    calls = {"load_batch": 0, "decode": 0}
    real_load_batch = datasets.CocoCaptionsDataset.load_batch
    real_decode = native.decode_crop_batch

    def load_batch(self, idxs):
        calls["load_batch"] += 1
        return real_load_batch(self, idxs)

    def decode(*a, **kw):
        calls["decode"] += 1
        return real_decode(*a, **kw)

    monkeypatch.setattr(datasets.CocoCaptionsDataset, "load_batch", load_batch)
    monkeypatch.setattr(native, "decode_crop_batch", decode)
    extra = ["DATA.NATIVE_PIPELINE", True, "OPTIM.NUM_ITERATIONS", 2]
    if cache:
        extra += ["DATA.DEVICE_CACHE", True, "DATA.CACHE_IMAGE_SIZE", 40]
    state = main(_args(corpus, tmp_path / "run", extra=extra))
    assert state.step == 2
    # One val sweep of N_VAL // B batches, at step 2; the cache's build
    # decodes once (one chunk), the loader a batch a step (and what it
    # prefetches).
    sweep = N_VAL // B
    if cache:
        assert calls == {"load_batch": sweep, "decode": 1 + sweep}
    else:
        assert calls["load_batch"] == calls["decode"] >= 2 + sweep


# ---------------------------------------------------------------------------
# crop_resize_flip_u8's CUDA source, emulated
# ---------------------------------------------------------------------------

# The emulated build's shared memory a block where it is squeezed: little
# enough that the small images of EMU_CASES take column tiles and runs of
# rows, enough for tiles of 40 (crop_resize.cuh's kMaxSize is then 41).
SQUEEZED_SMEM = 1856


def _emulated_lib(out, name: str, smem=None) -> ctypes.CDLL:
    src = emulate_cp_async((CSRC / "crop_resize.cuh").read_text())
    src = substitute(src, "extern __shared__ __align__(16) unsigned char "
                     "crop_smem[];", "unsigned char* crop_smem = "
                     "emu_block_smem();")
    if smem is not None:
        src = f"#define CROP_SMEM_BYTES {smem}\n" + src
    (out / f"{name}.cu").write_text(rewrite_launches(src, "crop_resize.cuh"))
    r = gxx(out, out / f"{name}.cu", out / f"lib{name}.so")
    assert r.returncode == 0, r.stderr[-4000:]
    return native.declare_crop(ctypes.CDLL(str(out / f"lib{name}.so")))


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return _emulated_lib(emulation_dir(tmp_path_factory), "crop_resize")


@pytest.fixture(scope="module")
def emulated_squeezed(tmp_path_factory):
    return _emulated_lib(emulation_dir(tmp_path_factory), "crop_squeezed",
                         SQUEEZED_SMEM)


EMU_CASES = {  # (image sizes, a None for a failed decode), out sizes
    "one_image_one_pixel": ([(5, 7)], 1),
    "one_pixel_source": ([(1, 1), (1, 9), (9, 1)], 3),
    "borders": ([(13, 17), (17, 13), (6, 6), None, (20, 31)], 17),
    "ragged_blocks": ([(40, 30), (3, 50)], 23),
    "blocks_past_the_edges": ([(19, 21), (7, 9), (33, 26), (17, 3)], 5),
    # Rows of 15, 33, 21 and 39 bytes; the arena and the tiles at odd
    # addresses (ODD_LEAD), so every image and row starts at an odd byte.
    "odd_rows_odd_offsets": ([(9, 5), (7, 11), None, (13, 7), (5, 13)], 7),
    "several_bands": ([(24, 30), (50, 45), (31, 17)], 40),
    "upsampling": ([(4, 6), (6, 4), (3, 3)], 19),
    "downsampling": ([(60, 50), (45, 70), None, (64, 64)], 9),
}
ODD_LEAD = {"odd_rows_odd_offsets": 3, "several_bands": 1}


def _emulated_equals_twin(lib, case):
    """Every image of the case as it is and averaged over blocks of 8, 1, 2
    and 4 in turn (ragged blocks at the far edges), under four kinds of
    box and three of flip, through ``lib`` against the twin, bit for bit;
    the bytes around the tiles untouched."""
    shapes, size = EMU_CASES[case]
    lead = ODD_LEAD.get(case, 0)
    rng = np.random.default_rng(len(shapes) * size)
    images = [None if s is None else
              rng.integers(0, 256, (*s, 3), dtype=np.uint8) for s in shapes]
    packed, offsets, sizes = native.pack_arena(images)
    arena = np.zeros(len(packed) + lead, np.uint8)
    arena[lead:] = packed
    n = len(images)
    blocks = np.array([8, 1, 2, 4], np.int32)[np.arange(n) % 4]
    for boxes in (edge_boxes(n), np.roll(edge_boxes(8), 3, axis=0)[:n],
                  native.full_image_boxes(n), BOXES["train"](n)):
        for flips, denoms in ((np.zeros(n, np.uint8), None),
                              (np.ones(n, np.uint8), None),
                              ((np.arange(n) % 2).astype(np.uint8), None),
                              ((np.arange(n) % 2).astype(np.uint8), blocks)):
            arrays = native.crop_arrays(offsets, sizes, boxes, flips, denoms)
            buf = torch.full((lead + n * size * size * 3 + 5,), 77,
                             dtype=torch.uint8)
            assert lib.crop_resize_flip_u8(
                arena.ctypes.data + lead, len(packed),
                *[None if a is None else a.ctypes.data for a in arrays], n,
                size, buf.data_ptr() + lead, 0, None) == 0
            want = native.crop_resize_flip_reference(
                torch.from_numpy(packed), offsets, sizes, boxes, flips, size,
                denoms)
            got = buf[lead:lead + want.numel()].view(want.shape)
            assert torch.equal(got, want), (boxes, flips, denoms)
            assert (buf[:lead] == 77).all() and (buf[-5:] == 77).all()


@pytest.mark.parametrize("case", sorted(EMU_CASES))
def test_emulated_kernel_equals_twin(emulated, case):
    _emulated_equals_twin(emulated, case)


@pytest.mark.parametrize("case", sorted(EMU_CASES))
def test_emulated_kernel_in_passes_equals_twin(emulated_squeezed, case):
    """The same with the shared memory squeezed: the source of a band no
    longer fits at once, so the kernel cuts it into column tiles and runs
    of rows."""
    _emulated_equals_twin(emulated_squeezed, case)


@pytest.mark.parametrize("n", [128, 129, 800, 801, 1601])
def test_emulated_kernel_at_each_batch_size_equals_twin(emulated, n):
    """Batches on either side of the entry's cut into launches of 800
    images (their parameters by value): one launch up to 800, two past it,
    three past 1600; tiny images (every 7th a failed decode) in 2 x 2
    tiles, flips alternate."""
    rng = np.random.default_rng(n)
    images = [None if i % 7 == 3 else
              rng.integers(0, 256, (1 + i % 3, 1 + i % 4, 3), dtype=np.uint8)
              for i in range(n)]
    arena, offsets, sizes = native.pack_arena(images)
    boxes = BOXES["train"](n)
    flips = (np.arange(n) % 2).astype(np.uint8)
    arrays = native.crop_arrays(offsets, sizes, boxes, flips)
    out = torch.full((n, 2, 2, 3), 77, dtype=torch.uint8)
    assert emulated.crop_resize_flip_u8(
        arena.ctypes.data, arena.size,
        *[None if a is None else a.ctypes.data for a in arrays], n, 2,
        out.data_ptr(), 0, None) == 0
    want = native.crop_resize_flip_reference(torch.from_numpy(arena), offsets,
                                             sizes, boxes, flips, 2)
    assert torch.equal(out, want)


def test_emulated_entry_refuses_what_it_does_not_take(emulated):
    """No image, a tile too large, a denom of 3 and an image that runs past
    the arena's end are refused before anything is launched."""
    image = np.full((4, 4, 3), 9, np.uint8)
    arena, offsets, sizes = native.pack_arena([image, image])
    out = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)

    def call(n=2, size=8, arena_bytes=arena.size, denoms=None):
        arrays = native.crop_arrays(offsets, sizes, native.full_image_boxes(2),
                                    np.zeros(2, np.uint8), denoms)
        return emulated.crop_resize_flip_u8(
            arena.ctypes.data, arena_bytes,
            *[None if a is None else a.ctypes.data for a in arrays], n, size,
            out.data_ptr(), 0, None)

    assert call() == 0 and out.any()
    assert call(n=0) == call(size=emulated.crop_max_size() + 1) == 1
    assert call(denoms=np.array([1, 3], np.int32)) == emulated.crop_bad_params()
    assert call(arena_bytes=arena.size - 1) == emulated.crop_bad_params()


def test_emulated_entry_states_its_limits(emulated, emulated_squeezed):
    """The limits that the wrapper reads from the library: tiles of up to
    1024 a side (41 with the budget squeezed), 800 images a launch."""
    assert emulated.crop_max_size() == 1024
    assert emulated_squeezed.crop_max_size() == 41
    assert emulated.crop_images_per_launch() == 800
    assert emulated.crop_bad_params() == emulated_squeezed.crop_bad_params() > 0


def test_scale_denoms_equal_the_per_image_rule():
    """The batch's denoms at once equal scale_denom image by image: seeded
    train, whole, empty and inverted boxes over sizes up to 6000 (d
    reaches 8), 640 x 640 and failed decodes, at four tile sizes."""
    rng = np.random.default_rng(5)
    n = 4000
    boxes = native.random_resized_crop_boxes(rng, n)
    boxes[::7] = -1.0
    boxes[3::11] = (0.5, 0.5, 0.5, 0.6)   # no height
    boxes[5::13] = (0.5, 0.5, 0.4, 0.9)   # inverted
    sizes = rng.integers(1, 6000, (n, 2)).astype(np.int32)
    sizes[::5] = (640, 640)
    sizes[1::9] = (0, 0)
    for size in (1, 32, 224, 256):
        want = [native.scale_denom(b, h, w, size) if h and w else 1
                for b, (h, w) in zip(boxes, sizes)]
        got = native.scale_denoms(boxes, sizes, size)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert set(got) == {1, 2, 4, 8}
