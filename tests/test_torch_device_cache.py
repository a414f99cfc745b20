"""The port's device-resident dataset cache
(``clip_lite_torch/data/device_cache.py``) over a decoded corpus: the
JAX cache's own host pass (``DeviceDataCache._load_host``) over a tiny
CLRec corpus of solid-colour tiles, as ``tests/test_device_cache.py``
builds it.  Every pixel of item i carries its identity, so each crop's
source is checkable.  The port draws from torch generators, so its
batches are not the JAX cache's: the tests hold shapes, purity in
(seed, step), provenance, the static sequence trim and the memory
formula against the JAX package."""

import numpy as np
import pytest
import torch

from clip_lite_tpu.config import Config as JConfig
from clip_lite_tpu.data.device_cache import DeviceDataCache as JDeviceDataCache
from clip_lite_tpu.data.device_cache import _static_seq_len as j_static_seq_len
from clip_lite_tpu.data.readers import ClRecWriter, encode_image
from clip_lite_tpu.factories import PretrainingDatasetFactory
from clip_lite_tpu.parallel import create_mesh
from clip_lite_torch.data.device_cache import (
    DecodedCorpus,
    DeviceDataCache,
    _static_seq_len,
)

N_ITEMS, CACHE, CROP, B = 12, 64, 48, 8


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("dc")
    rng = np.random.default_rng(0)
    path = str(root / "coco_train_train_sbert2017.clrec")
    with ClRecWriter(path) as w:
        for i in range(N_ITEMS):
            base = np.array([20 * i + 10, 255 - 20 * i, 128], np.uint8)
            img = np.broadcast_to(base, (80, 100, 3)).copy()
            img += rng.integers(0, 4, img.shape).astype(np.uint8)
            caps = [f"number {i} tile in a plain image",
                    f"tile {i}"][: (i % 2) + 1]
            w.append({"image_id": 1000 + i, "image": encode_image(img),
                      "captions": caps})
    cfg = JConfig(override_list=[
        "MODEL.NAME", "captions", "DATA.NAME", "train_sbert",
        "DATA.ROOT", str(root), "MODEL.TEXTUAL.VOCAB_SIZE", 30522])
    return PretrainingDatasetFactory.from_config(cfg, split="train")


@pytest.fixture(scope="module")
def corpus(dataset):
    return DecodedCorpus(*JDeviceDataCache._load_host(
        dataset, CACHE, np.arange(len(dataset))))


@pytest.fixture(scope="module")
def cache(corpus):
    return DeviceDataCache(corpus, batch_size=B, cache_size=CACHE,
                           crop_size=CROP, seq_buckets=[12, 20], seed=3,
                           device="cpu")


def _np(batch):
    return {k: v.numpy() for k, v in batch.items()}


def test_shapes_and_dtypes(cache):
    b = cache.batch_at(0)
    assert b["image"].shape == (B, CROP, CROP, 3)
    assert b["image"].dtype == torch.uint8 and b["image"].is_contiguous()
    # Every caption fits the smallest bucket (<= 12 tokens).
    assert b["input_ids"].shape == b["attention_mask"].shape == (B, 12)
    assert b["input_ids"].dtype == torch.int32
    assert b["image_id"].shape == (B,) and b["image_id"].dtype == torch.int64


def test_pure_function_of_step(cache, corpus):
    a1, a2, b = _np(cache.batch_at(7)), _np(cache.batch_at(7)), \
        _np(cache.batch_at(8))
    for k in a1:
        np.testing.assert_array_equal(a1[k], a2[k])
    assert any(not np.array_equal(a1[k], b[k]) for k in a1)
    twin = DeviceDataCache(corpus, batch_size=B, cache_size=CACHE,
                           crop_size=CROP, seq_buckets=[12, 20], seed=3,
                           device="cpu")
    other = DeviceDataCache(corpus, batch_size=B, cache_size=CACHE,
                            crop_size=CROP, seq_buckets=[12, 20], seed=4,
                            device="cpu")
    t, o = _np(twin.batch_at(7)), _np(other.batch_at(7))
    assert all(np.array_equal(a1[k], t[k]) for k in a1)
    assert not np.array_equal(a1["image"], o["image"])


def test_iter_respects_start(cache):
    cache.set_start(5)
    it = iter(cache)
    for step in (5, 6):
        got, want = _np(next(it)), _np(cache.batch_at(step))
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


def test_crops_are_windows_of_their_source_tile(cache, corpus):
    """Each crop equals the window of its sampled item's tile at some
    offset inside the tile."""
    ids = list(corpus.image_ids)
    span = CACHE - CROP + 1
    batch = _np(cache.batch_at(11))
    for j in range(B):
        tile = corpus.images[ids.index(int(batch["image_id"][j]))]
        crop = batch["image"][j]
        assert any(np.array_equal(crop, tile[y:y + CROP, x:x + CROP])
                   for y in range(span) for x in range(span))


def test_crop_offsets_vary(cache):
    """Offsets are drawn, not fixed: over a few batches the crops of one
    tile are not all the same window."""
    seen = {}
    for step in range(6):
        batch = _np(cache.batch_at(step))
        for j, img_id in enumerate(batch["image_id"]):
            seen.setdefault(int(img_id), set()).add(batch["image"][j].tobytes())
    assert any(len(v) > 1 for v in seen.values())


def test_caption_index_in_range(cache, corpus):
    """Odd items have 2 captions, even items 1: every sampled caption is a
    real caption of its item, and over the steps both of an odd item's
    captions are drawn."""
    drawn = set()
    for step in range(12):
        b = _np(cache.batch_at(step))
        for j, img_id in enumerate(b["image_id"]):
            i = list(corpus.image_ids).index(int(img_id))
            rows = corpus.ids[i][:, :b["input_ids"].shape[1]]
            hits = [c for c, r in enumerate(rows)
                    if np.array_equal(b["input_ids"][j], r)]
            assert hits, (step, j)
            drawn.add((i, hits[0]))
    assert any(c == 1 for _, c in drawn)


@pytest.mark.parametrize("max_len,buckets,fallback", [
    (7, [12, 20], 30), (12, [20, 12], 30), (13, [12, 20], 30),
    (25, [12, 20], 30), (5, [], 30), (5, None, 16), (40, [48], 32)])
def test_static_seq_len_matches_jax(max_len, buckets, fallback):
    assert _static_seq_len(max_len, buckets, fallback) == \
        j_static_seq_len(max_len, buckets, fallback)


def test_memory_bytes_match_jax_at_one_device(dataset, cache):
    jcache = JDeviceDataCache(dataset, create_mesh(num_devices=1),
                              batch_size=B, cache_size=CACHE, crop_size=CROP,
                              seq_buckets=[12, 20], seed=3)
    assert cache.memory_bytes() == jcache.memory_bytes()
    assert cache.memory_bytes_per_device() == jcache.memory_bytes_per_device()
    jb = jcache.batch_at(0)
    assert tuple(jb["input_ids"].shape) == tuple(cache.batch_at(0)["input_ids"].shape)


def test_rejects_what_one_card_does_not_do(corpus):
    with pytest.raises(ValueError):
        DeviceDataCache(corpus, batch_size=B, cache_size=CACHE,
                        crop_size=CACHE + 1, device="cpu")
    with pytest.raises(ValueError):  # tiles of another size
        DeviceDataCache(corpus, batch_size=B, cache_size=CACHE + 8,
                        crop_size=CROP, device="cpu")


def test_device_tensor_corpus_is_not_copied(corpus):
    """A tile tensor already on the cache's device is used as it is."""
    tiles = torch.from_numpy(np.ascontiguousarray(corpus.images))
    cache = DeviceDataCache(corpus._replace(images=tiles), batch_size=B,
                            cache_size=CACHE, crop_size=CROP, device="cpu")
    assert cache._images.data_ptr() == tiles.data_ptr()
