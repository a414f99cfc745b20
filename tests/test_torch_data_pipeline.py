"""The port's datasets and loader (clip_lite_torch/data/{datasets,pipeline}
.py) and the device cache's host pass (data/device_cache.py::load_host)
against the JAX package's, on a tiny CLRec corpus of ndarray records
(COCO's two shapes, scaled down to 48 x 64 and 64 x 48; five captions an
image) and on ``RandomDataset``.

For the same seed both loaders give the same batches: the index order,
``image_id``, ``input_ids``, ``attention_mask`` and each batch's trimmed
width equal, and the images within one grey level (1 / (255 * 0.224)
after Normalize), with and without DATA.SEQ_BUCKETS and the
length-grouped shuffle, over two epochs.  Also: ``infinite_batches``
resumed at N is the stream from its N-th batch; a producer's error is
re-raised and a consumer that leaves stops the producer; ``load_host``
gives JAX's ``_load_host`` corpus (tokens equal, tiles within one level);
the host cache's key follows the tokenizer and the caption length, and
a corpus with no file is not cached."""

import os
import threading
import time

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package's modules expect it loaded)

from clip_lite_tpu.config import Config as JConfig
from clip_lite_tpu.data import pipeline as jpipeline
from clip_lite_tpu.data.device_cache import DeviceDataCache as JDeviceDataCache
from clip_lite_tpu.factories import PretrainingDatasetFactory as JFactory
from clip_lite_torch.config import Config
from clip_lite_torch.data import pipeline
from clip_lite_torch.data.device_cache import (
    host_cache_key,
    load_host,
    load_host_cached,
)
from clip_lite_torch.data.readers import ClRecWriter
from clip_lite_torch.data.transforms import IMAGENET_COLOR_STD
from clip_lite_torch.factories import PretrainingDatasetFactory

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "configs", "fs_bs1024_ni250k.yaml")
B = 4
N_TRAIN, N_VAL = 26, 9
LEVEL = 1.0 / (255 * min(IMAGENET_COLOR_STD)) * (1 + 1e-6)
WORDS = ("a an the man woman child dog cat horse bus train car plate pizza "
         "table street city field beach kitchen red blue white black small "
         "large young old two three sitting standing riding eating holding "
         "walking parked next to on in with near under of at while left "
         "right").split()


def write_corpus(root, n_train=N_TRAIN, n_val=N_VAL, seed=0,
                 shapes=((48, 64), (64, 48))):
    """Train and val CLRec files of ndarray records under ``root``: seeded
    uint8 images of ``shapes`` in turn, five captions of 3-12 words each."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        path = os.path.join(str(root), f"coco_{split}_train_sbert2017.clrec")
        with ClRecWriter(path) as w:
            for i in range(n):
                h, w_ = shapes[i % len(shapes)]
                captions = [" ".join(rng.choice(WORDS, rng.integers(3, 13)))
                            for _ in range(5)]
                w.append({"image_id": 1000 * (split == "val") + i,
                          "image": rng.integers(0, 256, (h, w_, 3),
                                                dtype=np.uint8),
                          "captions": captions})
    return str(root)


TINY = ["DATA.IMAGE_CROP_SIZE", 32, "DATA.MAX_CAPTION_LENGTH", 16,
        "MODEL.TEXTUAL.VOCAB_SIZE", 512]


def overrides(root, *extra):
    return ["MODEL.NAME", "captions", "DATA.ROOT", root] + TINY + list(extra)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("corpus"))


def _datasets(over, split="train"):
    return (PretrainingDatasetFactory.from_config(Config(FLAGSHIP, over), split),
            JFactory.from_config(JConfig(FLAGSHIP, over), split))


def _loaders(over, split="train", background=True):
    ds, jds = _datasets(over, split)
    cfg = Config(FLAGSHIP, over)
    group = cfg.DATA.LENGTH_GROUP_BATCHES if cfg.DATA.SEQ_BUCKETS else 0
    shuffle = split == "train"
    ours = pipeline.DataLoader(ds, B, shuffle=shuffle, num_workers=3, seed=7,
                               background=background,
                               length_group_batches=group)
    theirs = jpipeline.DataLoader(jds, B, shuffle=shuffle, num_workers=2,
                                  seed=7, background=False,
                                  length_group_batches=group,
                                  num_shards=1, shard_index=0)
    return ours, theirs


def _same_batch(ours, theirs, tol):
    assert set(ours) == set(theirs) == {"image_id", "image", "input_ids",
                                        "attention_mask"}
    for k in ("image_id", "input_ids", "attention_mask"):
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k])
    assert str(ours["image"].dtype) == "torch.float32"
    assert theirs["image"].dtype == np.float32
    diff = np.abs(ours["image"].numpy().astype(np.float64) - theirs["image"])
    assert diff.max() <= tol


CASES = {
    "plain": [],
    "buckets": ["DATA.SEQ_BUCKETS", [8, 12], "DATA.LENGTH_GROUP_BATCHES", 2],
    "no_normalize": ["DATA.IMAGE_TRANSFORM_TRAIN",
                     ["random_resized_crop", "horizontal_flip", "color_jitter"]],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loader_matches_jax_over_two_epochs(corpus, case):
    ours, theirs = _loaders(overrides(corpus, *CASES[case]))
    tol = 1.0 if case == "no_normalize" else LEVEL
    widths = []
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        np.testing.assert_array_equal(ours._epoch_order(), theirs._epoch_order())
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == N_TRAIN // B
        for a, b in zip(got, want):
            _same_batch(a, b, tol)
            widths.append(a["input_ids"].shape[1])
    if case == "buckets":
        assert set(widths) <= {8, 12, 16} and len(set(widths)) > 1
    else:
        assert set(widths) == {16}
    if case == "no_normalize":  # finding: 0-255 floats, as JAX ships them
        assert got[0]["image"].max() > 200


def test_val_loader_matches_jax(corpus):
    ours, theirs = _loaders(overrides(corpus), split="val")
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == N_VAL // B
    for a, b in zip(got, want):
        _same_batch(a, b, LEVEL)


@pytest.mark.parametrize("buckets", [False, True])
def test_random_dataset_matches_jax(buckets):
    extra = ["DATA.SEQ_BUCKETS", [8, 12]] if buckets else []
    ours, theirs = _loaders(["MODEL.NAME", "random"] + TINY + extra)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for a, b, _ in zip(ours, theirs, range(3)):
            _same_batch(a, b, LEVEL)


def test_infinite_batches_resume_exact(corpus):
    ours, theirs = _loaders(overrides(corpus, *CASES["buckets"]))
    per_epoch = len(ours)
    stream = [b for b, _ in zip(pipeline.infinite_batches(ours), range(15))]
    jstream = [b for b, _ in zip(jpipeline.infinite_batches(theirs), range(15))]
    for a, b in zip(stream, jstream):
        _same_batch(a, b, LEVEL)
    for start in (per_epoch - 1, per_epoch + 2, 8):
        resumed = pipeline.infinite_batches(ours, start)
        for i, batch in zip(range(start, 15), resumed):
            for k in batch:
                assert torch_equal(batch[k], stream[i][k]), (start, i, k)
        resumed.close()


def torch_equal(a, b):
    return a.shape == b.shape and bool((a == b).all())


class _Failing:
    """A dataset whose item ``bad`` raises."""

    def __init__(self, bad):
        self.bad = bad

    def __len__(self):
        return 12

    def __getitem__(self, i):
        if i == self.bad:
            raise RuntimeError(f"item {i} is broken")
        return {"x": np.full(2, i)}

    def collate_fn(self, items):
        return {"x": np.stack([d["x"] for d in items])}


def _producers_alive():
    return [t for t in threading.enumerate()
            if t.name == "batch_producer" and t.is_alive()]


def _wait_for_producers(timeout=5.0):
    deadline = time.monotonic() + timeout
    while _producers_alive() and time.monotonic() < deadline:
        time.sleep(0.05)
    return _producers_alive()


@pytest.mark.parametrize("stream", ["epoch", "infinite"])
def test_producer_error_is_reraised(stream):
    loader = pipeline.DataLoader(_Failing(bad=5), 2, shuffle=False,
                                 num_workers=2)
    source = iter(loader) if stream == "epoch" else \
        pipeline.infinite_batches(loader)
    seen = []
    with pytest.raises(RuntimeError, match="item 5 is broken"):
        for batch in source:
            seen.append(batch["x"][:, 0].tolist())
    assert seen == [[0, 1], [2, 3]]
    assert _wait_for_producers() == []


def test_consumer_that_leaves_stops_the_producer():
    loader = pipeline.DataLoader(_Failing(bad=-1), 2, shuffle=False,
                                 num_workers=2, prefetch=1)
    source = pipeline.infinite_batches(loader)
    assert next(source)["x"].shape == (2, 2)
    time.sleep(0.2)  # the producer fills the queue and blocks
    source.close()
    assert _wait_for_producers() == []


def test_foreground_loader_matches_background(corpus):
    fore, _ = _loaders(overrides(corpus), background=False)
    back, _ = _loaders(overrides(corpus), background=True)
    for a, b in zip(fore, back):
        for k in a:
            assert torch_equal(a[k], b[k])


def test_more_than_one_shard_raises(corpus):
    """Shards that do not split every batch evenly raise (the JAX loader's
    checks); shards that do load (tests/test_torch_distributed.py)."""
    ds, _ = _datasets(overrides(corpus))
    with pytest.raises(ValueError, match="must divide"):
        pipeline.DataLoader(ds, B + 1, num_shards=2, shard_index=1)
    with pytest.raises(ValueError, match="drop_last"):
        pipeline.DataLoader(ds, B, drop_last=False, num_shards=2,
                            shard_index=1)
    with pytest.raises(ValueError, match="out of range"):
        pipeline.DataLoader(ds, B, num_shards=2, shard_index=2)
    assert pipeline.DataLoader(ds, B, num_shards=2, shard_index=1).num_shards \
        == 2


def test_native_pipeline_raises(corpus):
    """The native path (tests/test_torch_native.py) refuses what it cannot
    run: ndarray records (it decodes JPEG bytes), and its default device,
    CUDA, where there is none."""
    cfg = Config(FLAGSHIP, overrides(corpus, "DATA.NATIVE_PIPELINE", True))
    with pytest.raises(TypeError, match="JPEG records"):
        PretrainingDatasetFactory.from_config(cfg, "train", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PretrainingDatasetFactory.from_config(cfg, "train")


@pytest.mark.parametrize("rows", [None, [5, 0, 3, 11]])
def test_load_host_matches_jax(corpus, rows):
    ds, jds = _datasets(overrides(corpus))
    rows = np.arange(len(ds)) if rows is None else np.asarray(rows)
    ours = load_host(ds, 40, rows)
    images, ids, mask, n_caps, image_ids = JDeviceDataCache._load_host(
        jds, 40, rows)
    assert ours.images.shape == images.shape == (len(rows), 40, 40, 3)
    assert np.abs(ours.images.astype(int) - images).max() <= 1
    np.testing.assert_array_equal(ours.n_caps, n_caps)
    np.testing.assert_array_equal(ours.image_ids, image_ids)
    for a, b in zip(ours.ids, ids):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ours.mask, mask):
        np.testing.assert_array_equal(a, b)


def test_host_cache_key_follows_the_tokens(corpus):
    rows = np.arange(N_TRAIN)
    base, _ = _datasets(overrides(corpus))
    key = host_cache_key(base, 40, rows)
    assert host_cache_key(_datasets(overrides(corpus))[0], 40, rows) == key
    for extra in (["MODEL.TEXTUAL.VOCAB_SIZE", 600],
                  ["DATA.MAX_CAPTION_LENGTH", 20]):
        ds, _ = _datasets(overrides(corpus, *extra))
        assert host_cache_key(ds, 40, rows) != key, extra
    assert host_cache_key(base, 48, rows) != key
    assert host_cache_key(base, 40, rows[:-1]) != key


def test_host_cache_refuses_a_corpus_without_a_file(tmp_path):
    ds, _ = _datasets(["MODEL.NAME", "random"] + TINY)
    with pytest.raises(ValueError, match="needs a corpus read from a file"):
        load_host_cached(ds, 40, np.arange(4), str(tmp_path))


def test_host_cache_round_trip(corpus, tmp_path):
    ds, _ = _datasets(overrides(corpus))
    rows = np.arange(6)
    first = load_host_cached(ds, 40, rows, str(tmp_path))
    assert len(os.listdir(tmp_path)) == 2
    again = load_host_cached(ds, 40, rows, str(tmp_path))
    assert isinstance(again.images, np.memmap)
    np.testing.assert_array_equal(again.images, first.images)
    for a, b in zip(again.ids, first.ids):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(again.n_caps, first.n_caps)
