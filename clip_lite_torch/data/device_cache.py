"""Device-resident dataset cache for one card, the counterpart of the JAX
package's ``data/device_cache.py``.

The decoded corpus (square uint8 tiles, per-item caption token stacks)
lives in device memory, and each training batch is assembled there: the
sampler draws B items with replacement, one caption of each and a random
crop offset, and one indexed gather cuts the (B, crop, crop, 3) uint8
crops out of the tiles.  The train step then finishes augmentation on
the card (``engine._maybe_device_preprocess``).  Batches are a pure
function of (seed, step), so a resume at step K replays the stream.

The corpus comes from a dataset through :func:`load_host` (the JAX
``_load_host``: every caption cleaned and tokenized, and each record's
image made a tile, by the Python path (its centre square, resized by
area) or, for a dataset with ``native_pipeline``, by the native decode
(the whole image resized to the square with ``sample_crop``'s bilinear,
256 records a batch, the tiles made on the dataset's device and left
there)), memoized on disk by :func:`load_host_cached`
(``DATA.CACHE_HOST_DIR``); :meth:`DeviceDataCache.from_dataset` joins the
two, as the training CLI calls it.

Across ranks (the JAX cache's ``placement``, its ``device_cache.py:10-62,
100-114``): the seed-keyed corpus permutation splits the items into one
block a rank (sizes differing by at most one, each wrap-padded to the
same m rows), and rank r draws its B/n items of each step from its block
with a generator keyed by (seed, step, r).  ``sharded`` decodes and keeps
only the rank's block on its card; ``replicated`` keeps every block and
draws from its own, so the two placements give the same batches bit for
bit.  The ranks agree on the caption padding (count and length) with one
all-reduce of their maxima.

Differences from the JAX cache, by design:
  * the host cache's key folds in the tokenizer, the caption length and
    the dataset's class besides the file, and an unnamed corpus is not
    cached, so a cache that the JAX package wrote is not reused;
  * the draws come from a torch generator on the device, so batches are
    not the JAX cache's for the same seed;
  * over a world of one the permutation changes nothing (sampling is
    uniform over the corpus either way) and is left out, so the tiles
    are used in the caller's order with no second copy, and both
    placements are the same.

With ``ssl_aug`` (visual SSL) a batch also holds ``aug_image``, a second
crop of each item's tile at its own offset, as the JAX cache makes it;
the step then augments it with draws of its own.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import time
from typing import Dict, Iterator, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from clip_lite_torch.data.imgproc import resize_area
from clip_lite_torch.eval_utils import resolve_device
from clip_lite_torch.parallel.collectives import all_reduce_
from clip_lite_torch.parallel.distributed import process_count, process_index


class DecodedCorpus(NamedTuple):
    """What the JAX ``DeviceDataCache._load_host`` returns: ``images``
    (N, cache, cache, 3) uint8 (numpy, or a tensor, which may already lie
    on the device), per-item unpadded ``ids`` and ``mask`` stacks
    (n_caps_i, L) int, ``n_caps`` (N,) and ``image_ids`` (N,)."""

    images: Union[np.ndarray, torch.Tensor]
    ids: Sequence[np.ndarray]
    mask: Sequence[np.ndarray]
    n_caps: np.ndarray
    image_ids: np.ndarray


def _resize_square(img: np.ndarray, size: int) -> np.ndarray:
    """The centre square of ``img``, resized to ``size`` by area."""
    h, w = img.shape[:2]
    s = min(h, w)
    y0, x0 = (h - s) // 2, (w - s) // 2
    return resize_area(img[y0:y0 + s, x0:x0 + s], size, size)


# Records a native decode batch of the cache's build (the JAX chunk).
NATIVE_CHUNK = 256


def _captions_of(rec) -> dict:
    """A record without its image (a corpus's images would not fit)."""
    return {"image_id": rec["image_id"], "captions": rec["captions"]}


def _native_tiles(dataset, cache_size: int, rows: np.ndarray):
    """The native path's tiles of ``rows`` (a uint8 tensor on the dataset's
    device) and their records' ids and captions."""
    from clip_lite_torch.data import native

    images = torch.empty((len(rows), cache_size, cache_size, 3),
                         dtype=torch.uint8, device=dataset.device)
    recs = []
    for lo in range(0, len(rows), NATIVE_CHUNK):
        chunk = [dataset.reader.record(int(i))
                 for i in rows[lo:lo + NATIVE_CHUNK]]
        native.decode_crop_batch(
            [r["image"] for r in chunk], cache_size,
            native.full_image_boxes(len(chunk)), np.zeros(len(chunk), np.uint8),
            device=dataset.device, out=images[lo:lo + len(chunk)])
        recs += [_captions_of(r) for r in chunk]
    return images, recs


def load_host(dataset, cache_size: int, rows: np.ndarray) -> DecodedCorpus:
    """Decode the dataset rows ``rows`` to (cache, cache, 3) uint8 tiles
    and tokenize all their captions (each through the dataset's
    ``caption_transform`` with ``default_rng(0)``): per-item unpadded
    token stacks, as the JAX ``DeviceDataCache._load_host`` gives them.
    ``dataset`` is a ``CocoCaptionsDataset`` (its ``reader``,
    ``caption_transform`` and ``_tokenize``); with its ``native_pipeline``
    the tiles are a tensor on its device, else a numpy array."""
    n = len(rows)
    if getattr(dataset, "native_pipeline", False):
        images, recs = _native_tiles(dataset, cache_size, rows)
    else:
        images = np.empty((n, cache_size, cache_size, 3), np.uint8)
        recs = []
        for j, i in enumerate(rows):
            rec = dataset.reader[int(i)]
            images[j] = _resize_square(rec["image"], cache_size)
            recs.append(_captions_of(rec))
    ids_per_item, mask_per_item = [], []
    n_caps = np.empty(n, np.int32)
    image_ids = np.empty(n, np.int64)
    for j, rec in enumerate(recs):
        image_ids[j] = rec["image_id"]
        caps = rec["captions"]
        caps = caps if isinstance(caps, list) else [caps]
        item_ids, item_mask = [], []
        for cap in caps:
            cap = dataset.caption_transform(
                caption=cap, rng=np.random.default_rng(0))["caption"]
            tid, tmask = dataset._tokenize(cap)
            item_ids.append(tid)
            item_mask.append(tmask)
        ids_per_item.append(np.stack(item_ids))
        mask_per_item.append(np.stack(item_mask))
        n_caps[j] = len(caps)
    return DecodedCorpus(images, ids_per_item, mask_per_item, n_caps,
                         image_ids)


def host_cache_key(dataset, cache_size: int, rows: np.ndarray) -> str:
    """The key of :func:`load_host`'s result: the records' file (path,
    size, mtime), the tile size, the rows, the path that makes the tiles
    (the Python path, or the native one and the device type that decodes
    there: nvJPEG on a card, the JAX core's scaled libjpeg decode on the
    CPU; all three differ), and what the tokens depend on: the dataset's
    class, the tokenizer's name and vocabulary size and the caption
    length.  A dataset without a file has no key (ValueError)."""
    root = getattr(dataset, "root", "")
    if not root:
        raise ValueError("the host cache needs a corpus read from a file "
                         f"({type(dataset).__name__} names none)")
    st = os.stat(root)
    tok = dataset.tokenizer
    tile_maker = ("native", dataset.device.type) \
        if getattr(dataset, "native_pipeline", False) else "python"
    fingerprint = (os.path.abspath(root), st.st_size, st.st_mtime_ns,
                   cache_size, len(dataset), rows.tobytes(),
                   type(dataset).__name__, dataset.tokenizer_name,
                   type(tok).__name__, tok.vocab_size,
                   dataset.max_caption_length, tile_maker)
    return hashlib.sha1(repr(fingerprint).encode()).hexdigest()[:16]


def load_host_cached(dataset, cache_size: int, rows: np.ndarray,
                     host_cache_dir: str) -> DecodedCorpus:
    """:func:`load_host`, kept in ``host_cache_dir`` under
    :func:`host_cache_key`: the tiles as an .npy (read back memory-mapped)
    and the token stacks as a pickle, each written to a temporary name
    and renamed.  The pickle is this program's own."""
    key = host_cache_key(dataset, cache_size, rows)
    os.makedirs(host_cache_dir, exist_ok=True)
    img_path = os.path.join(host_cache_dir, f"corpus_{key}_images.npy")
    meta_path = os.path.join(host_cache_dir, f"corpus_{key}_meta.pkl")
    if os.path.exists(img_path) and os.path.exists(meta_path):
        with open(meta_path, "rb") as f:
            meta = pickle.load(f)
        return DecodedCorpus(np.load(img_path, mmap_mode="r"), meta["ids"],
                             meta["mask"], meta["n_caps"], meta["image_ids"])
    out = load_host(dataset, cache_size, rows)
    tmp = img_path + ".tmp.npy"
    np.save(tmp, torch.as_tensor(out.images).cpu().numpy())
    os.replace(tmp, img_path)
    with open(meta_path + ".tmp", "wb") as f:
        pickle.dump({"ids": out.ids, "mask": out.mask, "n_caps": out.n_caps,
                     "image_ids": out.image_ids}, f)
    os.replace(meta_path + ".tmp", meta_path)
    return out


def _static_seq_len(max_len: int, seq_buckets, fallback: int) -> int:
    """Smallest configured bucket holding the corpus max caption length."""
    if not seq_buckets:
        return fallback
    for b in sorted(seq_buckets):
        if max_len <= b:
            return int(b)
    return fallback


def shard_layout(n_items: int, world: int, seed: int):
    """The JAX cache's partition of ``n_items`` over ``world`` ranks:
    ``take`` (world x m dataset rows, rank r's block at [r m, (r + 1) m)),
    ``valid`` (each block's items before its wrap-padding) and ``m``."""
    if n_items < world:
        raise ValueError(f"corpus of {n_items} items cannot shard over "
                         f"{world} ranks")
    perm = np.random.default_rng(seed).permutation(n_items)
    base, rem = divmod(n_items, world)
    m = base + (1 if rem else 0)
    valid = (base + (np.arange(world) < rem)).astype(np.int64)
    take = np.empty(m * world, np.int64)
    start = 0
    for d in range(world):
        block = perm[start:start + valid[d]]
        start += valid[d]
        take[d * m:(d + 1) * m] = np.resize(block, m)
    return take, valid, m


def rows_held(n_items: int, seed: int, placement: str = "sharded"
              ) -> np.ndarray:
    """The dataset rows this rank's cache holds, in its order: all of
    them over a world of one, else the rank's block (``sharded``) or
    every block (``replicated``) of :func:`shard_layout`."""
    if placement not in ("sharded", "replicated"):
        raise ValueError(f"Unknown placement {placement!r}")
    world = process_count()
    if world == 1:
        return np.arange(n_items)
    take, _, m = shard_layout(n_items, world, seed)
    if placement == "replicated":
        return take
    r = process_index()
    return take[r * m:(r + 1) * m]


class DeviceDataCache:
    """The corpus on the card and a sampler of batches over it.

    ``corpus`` is a :class:`DecodedCorpus` (or the 5-tuple of the JAX
    ``_load_host``) of the rows :func:`rows_held` names, in that order,
    of a dataset of ``n_items`` (needed over more than one rank).
    Captions are padded to the corpus-wide caption count and trimmed to
    the smallest of ``seq_buckets`` that holds the longest caption (one
    shape for the whole run).  Each batch holds this rank's
    ``batch_size`` / n rows of the global batch.
    """

    def __init__(self, corpus: Sequence, batch_size: int,
                 cache_size: int = 256, crop_size: int = 224,
                 seq_buckets=None, seed: int = 0, ssl_aug: bool = False,
                 device="cuda", placement: str = "sharded",
                 n_items: Optional[int] = None):
        images, ids_list, mask_list, n_caps, image_ids = corpus
        if cache_size < crop_size:
            raise ValueError(
                f"cache_size {cache_size} < crop_size {crop_size}")
        if placement not in ("sharded", "replicated"):
            raise ValueError(f"Unknown placement {placement!r}")
        self.world, self.rank = process_count(), process_index()
        if batch_size % self.world:
            raise ValueError(f"batch_size {batch_size} must divide across "
                             f"{self.world} ranks")
        self.placement = placement
        n = len(ids_list)
        self._offset, self._valid = 0, n
        if self.world > 1:
            if n_items is None:
                raise ValueError("a cache across ranks needs n_items")
            _, valid, m = shard_layout(n_items, self.world, seed)
            held = m * (self.world if placement == "replicated" else 1)
            if n != held:
                raise ValueError(f"the corpus holds {n} rows, not the {held} "
                                 f"of rows_held({n_items}, ...)")
            self._valid = int(valid[self.rank])
            if placement == "replicated":
                self._offset = self.rank * m
        if tuple(images.shape) != (n, cache_size, cache_size, 3) \
                or images.dtype not in (np.uint8, torch.uint8):
            raise ValueError(f"images must be ({n}, {cache_size}, {cache_size},"
                             f" 3) uint8, got {tuple(images.shape)} "
                             f"{images.dtype}")
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.crop_size = crop_size
        self.cache_size = cache_size
        self.seed = seed
        self.ssl_aug = bool(ssl_aug)

        max_len = max(int(mm.sum(axis=-1).max()) for mm in mask_list)
        c_max = max(ii.shape[0] for ii in ids_list)
        if self.world > 1:  # every rank pads to the corpus-wide shapes
            maxima = torch.tensor([max_len, c_max], device=self.device)
            all_reduce_(maxima, op=torch.distributed.ReduceOp.MAX)
            max_len, c_max = (int(v) for v in maxima.tolist())
        s_tok = ids_list[0].shape[1]
        seq = min(_static_seq_len(max_len, seq_buckets, s_tok), s_tok)
        ids = np.zeros((n, c_max, seq), np.int32)
        mask = np.zeros((n, c_max, seq), np.int32)
        for i, (ii, mm) in enumerate(zip(ids_list, mask_list)):
            # Caption-axis padding stays zero; the sampler never reads it.
            ids[i, :ii.shape[0]] = ii[:, :seq]
            mask[i, :mm.shape[0]] = mm[:, :seq]

        def put(a):
            return torch.as_tensor(a).to(self.device)

        self._images = put(images)
        self._ids = put(ids)
        self._mask = put(mask)
        self._n_caps = put(np.asarray(n_caps, np.int32))
        self._image_ids = put(np.asarray(image_ids, np.int64))
        self._window = torch.arange(crop_size, device=self.device)
        self._step = 0

    @classmethod
    def from_dataset(cls, dataset, batch_size: int, cache_size: int = 256,
                     crop_size: int = 224, seq_buckets=None, seed: int = 0,
                     ssl_aug: bool = False, host_cache_dir: str = "",
                     device="cuda", placement: str = "sharded"
                     ) -> "DeviceDataCache":
        """The cache of ``dataset``'s rows that this rank holds
        (:func:`rows_held`), decoded by :func:`load_host` (through
        :func:`load_host_cached` with a ``host_cache_dir``), each once;
        ``build_seconds`` holds the time it took."""
        t0 = time.perf_counter()
        rows = rows_held(len(dataset), seed, placement)
        unique, inverse = np.unique(rows, return_inverse=True)
        corpus = (load_host_cached(dataset, cache_size, unique, host_cache_dir)
                  if host_cache_dir else load_host(dataset, cache_size, unique))
        if len(unique) != len(rows) or (unique != rows).any():
            images = corpus.images
            corpus = DecodedCorpus(
                images[torch.as_tensor(inverse, device=images.device)]
                if isinstance(images, torch.Tensor) else images[inverse],
                [corpus.ids[i] for i in inverse],
                [corpus.mask[i] for i in inverse],
                np.asarray(corpus.n_caps)[inverse],
                np.asarray(corpus.image_ids)[inverse])
        cache = cls(corpus, batch_size, cache_size=cache_size,
                    crop_size=crop_size, seq_buckets=seq_buckets, seed=seed,
                    ssl_aug=ssl_aug, device=device, placement=placement,
                    n_items=len(dataset))
        cache.build_seconds = time.perf_counter() - t0
        return cache

    def _generator(self, step: int) -> torch.Generator:
        key = (self.seed ^ 0x5EED, step) if self.world == 1 else \
            (self.seed ^ 0x5EED, step, self.rank)
        word = np.random.SeedSequence(key).generate_state(1, np.uint64)[0]
        return torch.Generator(device=self.device).manual_seed(int(word) >> 1)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """Batch for iteration ``step``, a pure function of (seed, step):
        ``image`` (B, crop, crop, 3) uint8, ``input_ids`` and
        ``attention_mask`` (B, S) int32, ``image_id`` (B,) int64; with
        ``ssl_aug``, ``aug_image``, the same tiles cropped at offsets drawn
        after the first ones."""
        g = self._generator(step)
        b, dev = self.batch_size // self.world, self.device
        idx = torch.randint(0, self._valid, (b,), generator=g,
                            device=dev) + self._offset
        # A caption below each row's own count: floor(U * n_caps), which
        # torch.randint (one bound for all rows) cannot draw.
        n_caps = self._n_caps[idx]
        u = torch.rand((b,), generator=g, device=dev)
        cap = torch.minimum((u * n_caps).long(), n_caps.long() - 1)

        def crop() -> torch.Tensor:
            off = torch.randint(0, self.cache_size - self.crop_size + 1,
                                (b, 2), generator=g, device=dev)
            rows = off[:, 0, None] + self._window  # (B, crop)
            cols = off[:, 1, None] + self._window
            # One gather, (B, crop, crop, 3).
            return self._images[idx[:, None, None], rows[:, :, None],
                                cols[:, None, :]]

        out = {"image": crop(), "input_ids": self._ids[idx, cap],
               "attention_mask": self._mask[idx, cap],
               "image_id": self._image_ids[idx]}
        if self.ssl_aug:
            out["aug_image"] = crop()
        return out

    def set_start(self, step: int) -> None:
        """Resume point: iteration the next ``__iter__`` batch is for."""
        self._step = int(step)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        while True:
            batch = self.batch_at(self._step)
            self._step += 1
            yield batch

    def memory_bytes_per_device(self) -> int:
        """Device bytes of this rank's padded rows (the JAX cache's
        formula)."""
        return (self._images.numel() + 4 * self._ids.numel() * 2
                + 4 * self._n_caps.numel())

    def memory_bytes(self) -> int:
        """Device bytes of the padded corpus over all ranks, each block
        counted once."""
        shards = self.world if self.placement == "sharded" else 1
        return self.memory_bytes_per_device() * shards


__all__ = ["DecodedCorpus", "DeviceDataCache", "_static_seq_len",
           "host_cache_key", "load_host", "load_host_cached", "rows_held",
           "shard_layout"]
