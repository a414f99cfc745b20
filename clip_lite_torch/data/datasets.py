"""Pretraining datasets, the counterpart of the JAX package's
``data/datasets.py``: numpy items of fixed shape, NHWC images, captions
padded to ``max_caption_length`` (and trimmed per batch to
``DATA.SEQ_BUCKETS``), and randomness from a generator per (seed, epoch,
index), so that the port's items are the JAX package's for the same seed.

Here: ``RandomDataset`` and ``CocoCaptionsDataset`` (CLRec records, the
Python path) in the ``train_sbert`` mode.  Like the JAX package's Python
path, an item's image is float32 whatever the transforms: without
``normalize`` in the list the model trains on 0-255 floats (ROADMAP
Queue 3 keeps this quirk, as the JAX package has it).

Not here yet, each raising with its item of ROADMAP Queue 1: the ``glove``
and ``sbert`` modes, the self-supervised views and the clustered hard
negatives (item 7); JPEG images, ``JsonDataset`` and the native batch
path (item 4); the downstream eval datasets (item 6).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from clip_lite_torch.data import transforms as T
from clip_lite_torch.data.readers import JPEG_PENDING, CocoCaptionsRecordReader
from clip_lite_torch.data.tokenizers import get_hf_tokenizer

NATIVE_PENDING = ("DATA.NATIVE_PIPELINE (the native JPEG batch path) is not "
                  "ported yet (ROADMAP Queue 1, item 4); set it false")


class Dataset:
    """Minimal dataset protocol: ``__len__``, ``__getitem__(idx) -> dict``,
    and a ``collate_fn`` giving fixed-shape numpy batches."""

    seed: int = 0
    epoch: int = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _rng(self, idx: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch, idx]))

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        raise NotImplementedError


class CaptionDatasetBase(Dataset):
    """Image-caption pairs: a caption drawn per item, the image
    transforms, then the caption cleaned and tokenized."""

    def __init__(self, mode: str = "train_sbert",
                 image_transform: Optional[Callable] = None,
                 max_caption_length: int = 30,
                 use_single_caption: bool = False,
                 tokenizer_name: str = "bert-base-uncased",
                 visual_self_supervised: bool = False,
                 textual_self_supervised: bool = False,
                 vocab_size: Optional[int] = None,
                 seq_buckets: Optional[Sequence[int]] = None):
        if mode != "train_sbert":
            raise NotImplementedError(
                f"the {mode!r} dataset mode lands with the rest of the model "
                "matrix (ROADMAP Queue 1, item 7)")
        if visual_self_supervised or textual_self_supervised:
            raise NotImplementedError("the self-supervised views land with "
                                      "the SSL terms (ROADMAP Queue 1, item 7)")
        self.mode = mode
        self.image_transform = image_transform or T.DEFAULT_IMAGE_TRANSFORM
        self.max_caption_length = max_caption_length
        self.use_single_caption = use_single_caption
        # DATA.SEQ_BUCKETS: collate trims captions to the smallest bucket
        # holding the batch's longest one; the top bucket is always
        # max_caption_length.
        buckets = sorted(int(b) for b in (seq_buckets or []))
        if buckets:
            if buckets[-1] > max_caption_length:
                raise ValueError(
                    f"SEQ_BUCKETS {buckets} exceed MAX_CAPTION_LENGTH "
                    f"{max_caption_length}")
            if buckets[-1] != max_caption_length:
                buckets.append(max_caption_length)
        self.seq_buckets = tuple(buckets)
        self.caption_transform = T.Compose(
            [T.NormalizeCaption(max_caption_length)])
        self.tokenizer_name = tokenizer_name
        self.tokenizer = get_hf_tokenizer(
            tokenizer_name, max_length=max_caption_length,
            vocab_size=vocab_size)

    def _tokenize(self, caption: str) -> Tuple[np.ndarray, np.ndarray]:
        enc = self.tokenizer(caption, padding="max_length", truncation=True,
                             max_length=self.max_caption_length)
        ids = np.asarray(enc["input_ids"], np.int32)
        mask = np.asarray(enc["attention_mask"], np.int32)
        return ids, mask

    def _prepare(self, image_id: int, image: np.ndarray, captions,
                 rng: np.random.Generator) -> Dict[str, Any]:
        if isinstance(captions, str):
            captions = [captions]
        if self.use_single_caption or len(captions) == 1:
            caption = captions[0]
        else:
            caption = captions[int(rng.integers(len(captions)))]
        out = self.image_transform(image=image, caption=caption, rng=rng)
        caption = self.caption_transform(
            caption=out.get("caption", caption), rng=rng)["caption"]
        ids, mask = self._tokenize(caption)
        return {"image_id": np.int64(image_id),
                "image": np.asarray(out["image"], np.float32),
                "input_ids": ids, "attention_mask": mask}

    def collate_fn(self, items: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        return {k: np.stack([d[k] for d in items]) for k in items[0]}

    def trim_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Trim the caption arrays of a collated batch to the smallest
        bucket that holds its longest caption (no-op without buckets).
        Padding carries attention_mask 0, so the text tower's outputs at
        real tokens do not change; only the shape does."""
        if not self.seq_buckets:
            return batch
        longest = int(np.max(np.sum(batch["attention_mask"], axis=1)))
        width = next(b for b in self.seq_buckets if b >= longest)
        if width >= batch["attention_mask"].shape[1]:
            return batch
        for k in ("input_ids", "attention_mask"):
            batch[k] = np.ascontiguousarray(batch[k][:, :width])
        return batch

    def _caption_token_length(self, caption: str) -> int:
        enc = self.tokenizer(caption, padding="max_length", truncation=True,
                             max_length=self.max_caption_length)
        return int(np.sum(enc["attention_mask"]))

    def caption_max_token_lengths(self) -> Optional[np.ndarray]:
        """Per item, the longest tokenized length of its candidate captions
        (the choice is random per epoch), for the loader's length-grouped
        shuffle; None where no cheap scan exists."""
        return None


class RandomDataset(CaptionDatasetBase):
    """Synthetic smoke dataset: random images and canned captions, the
    whole pipeline with no data files."""

    CAPTIONS = [
        "a man riding a wave on top of a surfboard",
        "a kitchen with a stove and a refrigerator",
        "two dogs playing with a red ball in the park",
        "a group of people standing around a food truck",
    ]

    def __init__(self, data_root: str = "", split: str = "train",
                 length: int = 118000, image_size: int = 224, **kw):
        kw.pop("percentage", None)
        super().__init__(**kw)
        self.length = length if split == "train" else max(64, length // 100)
        self.image_size = image_size

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int):
        rng = self._rng(idx)
        image = rng.integers(0, 256, (self.image_size, self.image_size, 3),
                             dtype=np.uint8)
        return self._prepare(idx, image, list(self.CAPTIONS), rng)

    def caption_max_token_lengths(self) -> Optional[np.ndarray]:
        bound = max(self._caption_token_length(c) for c in self.CAPTIONS)
        return np.full(self.length, bound, np.int32)


class CocoCaptionsDataset(CaptionDatasetBase):
    """The pretraining dataset over a CLRec split,
    ``{data_root}/coco_{split}_{mode}2017.clrec``."""

    def __init__(self, data_root: str, split: str = "train",
                 percentage: float = 100.0, native_pipeline: bool = False,
                 **kw):
        if native_pipeline:
            raise NotImplementedError(NATIVE_PENDING)
        super().__init__(**kw)
        self.root = os.path.join(data_root,
                                 f"coco_{split}_{self.mode}2017.clrec")
        self.reader = CocoCaptionsRecordReader(self.root, percentage=percentage)

    def load_batch(self, indices):
        raise NotImplementedError(NATIVE_PENDING)

    def __len__(self):
        return len(self.reader)

    def __getitem__(self, idx: int):
        rng = self._rng(idx)
        rec = self.reader[idx]
        return self._prepare(rec["image_id"], rec["image"], rec["captions"],
                             rng)

    def caption_max_token_lengths(self) -> Optional[np.ndarray]:
        out = np.empty(len(self.reader), np.int32)
        for i in range(len(self.reader)):
            out[i] = max(self._caption_token_length(c)
                         for c in self.reader.captions(i))
        return out


def _pending(name: str, why: str) -> type:
    """A dataset class of the JAX package that the port does not have yet:
    constructing it raises ``NotImplementedError`` with ``why``."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"{name}: {why}")

    return type(name, (Dataset,), {"__init__": __init__,
                                   "__doc__": f"Not ported yet: {why}."})


JsonDataset = _pending("JsonDataset", "it reads JPEG files; " + JPEG_PENDING)
CocoCaptionsClusteredDataset = _pending(
    "CocoCaptionsClusteredDataset",
    "the clustered hard negatives land with ROADMAP Queue 1, item 7")
_DOWNSTREAM = "the downstream evals land with ROADMAP Queue 1, item 6"
VOC07ClassificationDataset = _pending("VOC07ClassificationDataset", _DOWNSTREAM)
INaturalist2018Dataset = _pending("INaturalist2018Dataset", _DOWNSTREAM)
ImageNetDataset = _pending("ImageNetDataset", _DOWNSTREAM)
ReEvalDataset = _pending("ReEvalDataset", _DOWNSTREAM)
FlickrReEvalDataset = _pending("FlickrReEvalDataset", _DOWNSTREAM)
CocoObjectGender = _pending("CocoObjectGender", _DOWNSTREAM)

__all__ = ["CaptionDatasetBase", "CocoCaptionsClusteredDataset",
           "CocoCaptionsDataset", "CocoObjectGender", "Dataset",
           "FlickrReEvalDataset", "INaturalist2018Dataset", "ImageNetDataset",
           "JsonDataset", "NATIVE_PENDING", "RandomDataset", "ReEvalDataset",
           "VOC07ClassificationDataset"]
