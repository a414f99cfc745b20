"""Pretraining datasets, the counterpart of the JAX package's
``data/datasets.py``: numpy items of fixed shape, NHWC images, captions
padded to ``max_caption_length`` (and trimmed per batch to
``DATA.SEQ_BUCKETS``), and randomness from a generator per (seed, epoch,
index), so that the port's items are the JAX package's for the same seed.

Here: the pretraining datasets ``RandomDataset``, ``CocoCaptionsDataset``
(CLRec records, through the Python path or, with ``native_pipeline``, the
native JPEG batch path of ``data/native.py``) and ``JsonDataset``
(ALBEF-style json over image files), and the downstream eval datasets (VOC07, iNaturalist 2018, ImageNet, COCO and Flickr30k
retrieval, the gender-labelled COCO subset).  Image files are decoded by
:func:`~clip_lite_torch.data.readers.read_image`.  Like the JAX package's
Python path, an item's image is float32 whatever the transforms: without
``normalize`` in the list the model trains on 0-255 floats (ROADMAP
Queue 3 keeps this quirk, as the JAX package has it).

With ``visual_self_supervised`` or ``textual_self_supervised`` an item
also holds its augmented views for the SSL terms, as the JAX package's
``_prepare`` makes them: ``aug_image``, a second transform draw of the
same image, and ``aug_input_ids``/``aug_attention_mask``, another caption
of the same image.

``CocoCaptionsClusteredDataset`` pairs each item with a hard negative
from its caption cluster, for the training CLI's cluster curriculum.

The text side of an item follows the dataset's ``mode`` (DATA.NAME), as
in the JAX package: ``train_sbert`` gives ``input_ids`` and
``attention_mask`` from the Hugging Face (or hashing) tokenizer;
``glove`` gives ``caption_tokens`` (``<start>``, the words' ids from the
word dictionary at ``word_dict_path``, ``<eos>``, cut to
``max_caption_length`` and padded with ``<pad>``), ``noitpac_tokens`` (the
same ids reversed) and ``caption_lengths``; ``sbert`` gives
``caption_encodings``, a record's precomputed 768-d sentence vector (one
row drawn where it holds several).  Only ``train_sbert`` makes the SSL
views, and only it takes the native batch path.
"""

from __future__ import annotations

import glob
import json
import os
import pickle
import threading
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from clip_lite_torch.data import transforms as T
from clip_lite_torch.data.readers import CocoCaptionsRecordReader, read_image
from clip_lite_torch.data.tokenizers import GloveTokenizer, get_hf_tokenizer

MODES = ("train_sbert", "glove", "sbert")


def _pad_tokens(ids: List[int], length: int, pad: int) -> np.ndarray:
    out = np.full((length,), pad, np.int32)
    ids = ids[:length]
    out[: len(ids)] = ids
    return out


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
                 seq_buckets: Optional[Sequence[int]] = None,
                 word_dict_path: Optional[str] = None):
        if mode not in MODES:
            raise ValueError(f"Unknown dataset mode {mode!r}")
        self.mode = mode
        self.visual_self_supervised = visual_self_supervised
        self.textual_self_supervised = textual_self_supervised
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
        if mode == "glove":
            # Without the dictionary's file every word is <unk>, as in JAX.
            self.tokenizer = (
                GloveTokenizer(word_dict_path)
                if word_dict_path and os.path.exists(word_dict_path)
                else GloveTokenizer(word_dict={w: i for i, w in enumerate(
                    ["<pad>", "<start>", "<eos>", "<unk>"])}))
            self.padding_idx = self.tokenizer.token_to_id("<pad>")
            self.glove_pipeline = T.Compose([
                T.NormalizeCaption(max_caption_length),
                T.TokenizeCaption(self.tokenizer),
                T.TruncateCaptionTokens(max_caption_length)])
        else:
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
        """The item, drawing from ``rng`` in the JAX ``_prepare``'s order:
        the caption, the SSL caption (redrawn while it equals the first),
        the image transform, the caption transforms, the SSL image's own
        transform draw.  In the sbert mode ``captions`` is the item's
        sentence vector itself."""
        if self.mode == "sbert":
            caption = captions
        else:
            if isinstance(captions, str):
                captions = [captions]
            if self.use_single_caption or len(captions) == 1:
                caption = captions[0]
            else:
                caption = captions[int(rng.integers(len(captions)))]
        aug_caption = caption
        if self.textual_self_supervised and isinstance(captions, list) \
                and any(c != caption for c in captions):
            while aug_caption == caption:
                aug_caption = captions[int(rng.integers(len(captions)))]
        out = self.image_transform(image=image, caption=caption, rng=rng)
        item = {"image_id": np.int64(image_id),
                "image": np.asarray(out["image"], np.float32)}
        if self.mode == "sbert":
            item["caption_encodings"] = np.asarray(caption, np.float32)
            return item
        if self.mode == "glove":
            tokens = self.glove_pipeline(caption=out.get("caption", caption),
                                         rng=rng)["caption"]
            n = self.max_caption_length
            item.update(
                caption_tokens=_pad_tokens(tokens, n, self.padding_idx),
                noitpac_tokens=_pad_tokens(tokens[::-1], n, self.padding_idx),
                caption_lengths=np.int64(len(tokens)))
            return item
        caption = self.caption_transform(
            caption=out.get("caption", caption), rng=rng)["caption"]
        item["input_ids"], item["attention_mask"] = self._tokenize(caption)
        if self.textual_self_supervised:
            aug = self.caption_transform(caption=aug_caption, rng=rng)["caption"]
            item["aug_input_ids"], item["aug_attention_mask"] = \
                self._tokenize(aug)
        if self.visual_self_supervised:
            aug_out = self.image_transform(image=image, caption=aug_caption,
                                           rng=rng)
            item["aug_image"] = np.asarray(aug_out["image"], np.float32)
        return item

    def collate_fn(self, items: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        return {k: np.stack([d[k] for d in items]) for k in items[0]}

    _CAPTION_BATCH_KEYS = ("input_ids", "attention_mask",
                           "aug_input_ids", "aug_attention_mask")

    def trim_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Trim the caption arrays of a collated batch (the SSL captions
        too) to the smallest bucket that holds its longest caption (no-op
        without buckets).  Padding carries attention_mask 0, so the text
        tower's outputs at real tokens do not change; only the shape
        does."""
        if not self.seq_buckets or "attention_mask" not in batch:
            return batch
        longest = max(int(np.max(np.sum(batch[k], axis=1)))
                      for k in ("attention_mask", "aug_attention_mask")
                      if k in batch)
        width = next(b for b in self.seq_buckets if b >= longest)
        if width >= batch["attention_mask"].shape[1]:
            return batch
        for k in self._CAPTION_BATCH_KEYS:
            if k in batch:
                batch[k] = np.ascontiguousarray(batch[k][:, :width])
        return batch

    def _caption_token_length(self, caption: str) -> int:
        enc = self.tokenizer(caption, padding="max_length", truncation=True,
                             max_length=self.max_caption_length)
        return int(np.sum(enc["attention_mask"]))

    def caption_max_token_lengths(self) -> Optional[np.ndarray]:
        """Per item, the longest tokenized length of its candidate captions
        (the choice is random per epoch), for the loader's length-grouped
        shuffle; None where no cheap scan exists (and outside the
        ``train_sbert`` mode)."""
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
        captions = list(self.CAPTIONS)
        if self.mode == "sbert":
            captions = rng.normal(size=(768,)).astype(np.float32)
        return self._prepare(idx, image, captions, rng)

    def caption_max_token_lengths(self) -> Optional[np.ndarray]:
        if self.mode != "train_sbert":
            return None
        bound = max(self._caption_token_length(c) for c in self.CAPTIONS)
        return np.full(self.length, bound, np.int32)


class JsonDataset(CaptionDatasetBase):
    """ALBEF-style json caption files, ``[{"image": path, "caption": str or
    list}]``, their entries shuffled once by ``default_rng(0)``; with
    ``percentage`` below 100 the first part of the shuffled list is
    dropped."""

    def __init__(self, json_files: List[str], data_root: str = "",
                 split: str = "train", percentage: float = 100.0, **kw):
        super().__init__(**kw)
        self.ann: List[dict] = []
        for f in json_files:
            with open(f) as fh:
                self.ann += json.load(fh)
        np.random.default_rng(0).shuffle(self.ann)
        if percentage < 100.0:
            drop = int((100.0 - percentage) / 100.0 * len(self.ann))
            self.ann = self.ann[drop:]

    def __len__(self):
        return len(self.ann)

    def __getitem__(self, idx: int):
        rng = self._rng(idx)
        ann = self.ann[idx]
        captions = ann["caption"]
        if not isinstance(captions, list):
            captions = [captions]
        return self._prepare(idx, read_image(ann["image"]), captions, rng)

    def caption_max_token_lengths(self) -> Optional[np.ndarray]:
        if self.mode != "train_sbert":
            return None
        out = np.empty(len(self.ann), np.int32)
        for i, ann in enumerate(self.ann):
            caps = ann["caption"]
            caps = caps if isinstance(caps, list) else [caps]
            out[i] = max(self._caption_token_length(c) for c in caps)
        return out


class CocoCaptionsDataset(CaptionDatasetBase):
    """The pretraining dataset over a CLRec split,
    ``{data_root}/coco_{split}_{mode}2017.clrec``.

    With ``native_pipeline`` (DATA.NATIVE_PIPELINE) the loader takes whole
    batches from :meth:`load_batch`: the JPEG records decoded, cropped (a
    random resized crop in train, the whole image in val) and resized to
    ``crop_size`` on ``device`` in one pass (``data/native.py``), uint8,
    flip, colour jitter and normalize left to the train step, as in the
    JAX package.  The records' images must then be JPEG bytes.
    """

    def __init__(self, data_root: str, split: str = "train",
                 percentage: float = 100.0, native_pipeline: bool = False,
                 crop_size: int = 224, device="cuda", **kw):
        super().__init__(**kw)
        self.root = os.path.join(data_root,
                                 f"coco_{split}_{self.mode}2017.clrec")
        self.reader = CocoCaptionsRecordReader(self.root, percentage=percentage)
        self.split = split
        self.crop_size = crop_size
        self.native_pipeline = bool(native_pipeline)
        self.device = None
        if self.native_pipeline and self.mode != "train_sbert":
            raise ValueError(f"DATA.NATIVE_PIPELINE tokenizes for train_sbert; "
                             f"the {self.mode!r} mode takes the Python path")
        if self.native_pipeline:
            from clip_lite_torch.data import native
            from clip_lite_torch.eval_utils import resolve_device

            self.device = resolve_device(device)
            if len(self.reader):  # the first record says what they hold
                native.jpeg_bytes(self.reader.record(0)["image"])

    def load_batch(self, indices) -> Dict[str, Any]:
        """The native batch path (the JAX ``load_batch``): the records of
        ``indices`` as ``image_id`` (B,) int64, ``image`` (B, crop, crop, 3)
        uint8 on ``device`` (zero tiles where a JPEG does not decode),
        ``input_ids`` and ``attention_mask`` (B, L) int32.  One generator
        per batch, from its first index and the epoch, draws the crop boxes
        and then one caption per record.  As in the JAX package it makes no
        SSL views: the training CLI refuses SSL on this path unless the
        device cache makes the training batches (whose ``ssl_aug`` holds
        the visual view); its val sweeps then score the pair terms."""
        from clip_lite_torch.data import native

        rng = self._rng(int(indices[0]) + 1_000_003 * self.epoch)
        recs = [self.reader.record(int(i)) for i in indices]
        n = len(recs)
        boxes = (native.random_resized_crop_boxes(rng, n)
                 if self.split == "train" else native.full_image_boxes(n))
        images, _ = native.decode_crop_batch(
            [r["image"] for r in recs], self.crop_size, boxes,
            np.zeros(n, np.uint8), device=self.device)  # flips: the step's
        ids_list, mask_list = [], []
        for rec in recs:
            captions = rec["captions"]
            cap = captions[0] if self.use_single_caption else \
                captions[int(rng.integers(len(captions)))]
            cap = self.caption_transform(caption=cap, rng=rng)["caption"]
            ids, mask = self._tokenize(cap)
            ids_list.append(ids)
            mask_list.append(mask)
        return {"image_id": np.asarray([r["image_id"] for r in recs], np.int64),
                "image": images, "input_ids": np.stack(ids_list),
                "attention_mask": np.stack(mask_list)}

    def __len__(self):
        return len(self.reader)

    def __getitem__(self, idx: int):
        rng = self._rng(idx)
        rec = self.reader[idx]
        captions = rec["captions"]
        if self.mode == "sbert":
            captions = rec.get("caption_encodings")
            if captions is None:
                raise ValueError(
                    "sbert mode needs records with precomputed "
                    "'caption_encodings' (run scripts/coco_preprocess.py "
                    "--mode sbert)")
            if isinstance(captions, np.ndarray) and captions.ndim == 2:
                captions = captions[int(rng.integers(len(captions)))]
        return self._prepare(rec["image_id"], rec["image"], captions, rng)

    def caption_max_token_lengths(self) -> Optional[np.ndarray]:
        if self.mode != "train_sbert":
            return None
        out = np.empty(len(self.reader), np.int32)
        for i in range(len(self.reader)):
            out[i] = max(self._caption_token_length(c)
                         for c in self.reader.captions(i))
        return out


class CocoCaptionsClusteredDataset(CaptionDatasetBase):
    """Curriculum hard negatives from k-means clusters of the captions
    (``scripts/cluster.py``), the counterpart of the JAX package's
    ``CocoCaptionsClusteredDataset``: each item pairs a record of the
    CLRec split with a random other image of the same cluster and one of
    its captions, ``neg_image``, ``neg_input_ids``, ``neg_attention_mask``.
    The number of clusters follows the training iteration (the loader's
    ``set_iteration``): from the fewest available at
    ``negative_sampling_start_iter`` to the most at ``total_iters``, the
    ``k`` of ``img_id_cluster_map_{split}_{k}.pkl`` nearest to the
    schedule.  The negative's image is read from ``coco_root`` with the
    port's ``read_image``.

    Items equal the JAX dataset's draw for draw.  Where the JAX dataset
    rebuilds its cluster maps in place on whichever loader thread sees the
    new ``k``, this one builds them aside and swaps them in under a lock,
    so that no concurrent item draws from a half-built member list; and a
    cluster of one image raises, where the JAX loop would spin for ever
    looking for another member."""

    def __init__(self, data_root: str, split: str = "train",
                 total_iters: int = 500000,
                 negative_sampling_start_iter: int = 250000,
                 cluster_path: str = "", coco_root: str = "",
                 percentage: float = 100.0, **kw):
        kw.pop("visual_self_supervised", None)
        kw.pop("textual_self_supervised", None)
        super().__init__(**kw)
        path = os.path.join(data_root, f"coco_{split}_{self.mode}2017.clrec")
        self.reader = CocoCaptionsRecordReader(path, percentage=percentage)
        self.split = split
        self.cluster_path = cluster_path
        self.coco_root = coco_root
        self.total_iters = total_iters
        self.negative_sampling_start_iter = negative_sampling_start_iter
        self.iter_num = 0
        self.current_cluster_num = -1
        self.cluster_options = self._scan_cluster_options()
        self._lock = threading.Lock()
        # (image id -> cluster, cluster -> member image ids), swapped whole.
        self._maps: Tuple[Dict[int, int], Dict[int, List[int]]] = ({}, {})
        self._img_id_caption_map: Optional[dict] = None
        self._img_id_filename_map: Optional[dict] = None

    def _scan_cluster_options(self) -> List[int]:
        options = [int(f.split("_")[-1].replace(".pkl", ""))
                   for f in (os.listdir(self.cluster_path)
                             if os.path.isdir(self.cluster_path) else ())
                   if f"img_id_cluster_map_{self.split}" in f]
        if not options:
            raise FileNotFoundError(
                f"No img_id_cluster_map_{self.split}_*.pkl under "
                f"{self.cluster_path!r} (run scripts/cluster.py first)")
        return sorted(options)

    def set_iteration(self, iteration: int) -> None:
        self.iter_num = iteration

    def cluster_num(self, iteration: int) -> int:
        """The number of clusters of the schedule at ``iteration``."""
        span = self.total_iters - self.negative_sampling_start_iter
        frac = (iteration - self.negative_sampling_start_iter) / max(1, span)
        pred = max(self.cluster_options) * frac
        return min(self.cluster_options, key=lambda x: abs(x - pred))

    def _load_pickle(self, name: str):
        with open(os.path.join(self.cluster_path, name), "rb") as f:
            return pickle.load(f)

    def _current_maps(self) -> Tuple[Dict[int, int], Dict[int, List[int]]]:
        """The cluster maps for the current iteration, loaded and swapped
        in (under the lock) when its number of clusters changed."""
        num = self.cluster_num(self.iter_num)
        if num != self.current_cluster_num:
            with self._lock:
                if num != self.current_cluster_num:
                    if self._img_id_caption_map is None:
                        self._img_id_caption_map = self._load_pickle(
                            f"img_id_caption_map_{self.split}.pkl")
                        self._img_id_filename_map = self._load_pickle(
                            f"img_id_filename_map_{self.split}.pkl")
                    cluster_map = self._load_pickle(
                        f"img_id_cluster_map_{self.split}_{num}.pkl")
                    members: Dict[int, List[int]] = defaultdict(list)
                    for img_id, cluster in cluster_map.items():
                        members[cluster].append(img_id)
                    self._maps = (cluster_map, dict(members))
                    self.current_cluster_num = num
        return self._maps

    def __len__(self):
        return len(self.reader)

    def __getitem__(self, idx: int):
        rng = self._rng(idx)
        cluster_map, cluster_members = self._current_maps()
        rec = self.reader[idx]
        image_id, image, captions = (rec["image_id"], rec["image"],
                                     rec["captions"])
        caption = captions[0] if self.use_single_caption else \
            captions[int(rng.integers(len(captions)))]

        # The hard negative: another image of the same caption cluster.
        members = cluster_members[cluster_map[image_id]]
        if len(members) < 2:
            raise ValueError(f"image {image_id} is alone in its cluster of "
                             f"{self.current_cluster_num}: no negative")
        neg_image_id = image_id
        while neg_image_id == image_id:
            neg_image_id = members[int(rng.integers(len(members)))]
        neg_image = read_image(os.path.join(
            self.coco_root, self._img_id_filename_map[neg_image_id]))
        neg_captions = self._img_id_caption_map[neg_image_id]
        neg_caption = neg_captions[int(rng.integers(len(neg_captions)))]

        pos = self.image_transform(image=image, caption=caption, rng=rng)
        neg = self.image_transform(image=neg_image, caption=neg_caption,
                                   rng=rng)
        pos_c = self.caption_transform(caption=pos["caption"],
                                       rng=rng)["caption"]
        neg_c = self.caption_transform(caption=neg["caption"],
                                       rng=rng)["caption"]
        ids, mask = self._tokenize(pos_c)
        nids, nmask = self._tokenize(neg_c)
        return {
            "image_id": np.int64(image_id),
            "image": np.asarray(pos["image"], np.float32),
            "input_ids": ids, "attention_mask": mask,
            "neg_image": np.asarray(neg["image"], np.float32),
            "neg_input_ids": nids, "neg_attention_mask": nmask,
        }


# ---------------------------------------------------------------------------
# Downstream eval datasets: an image file per item through the transforms
# (drawing from the item's generator), float32 out.
# ---------------------------------------------------------------------------

class _ImageFileDataset(Dataset):
    image_transform: Callable

    def _image(self, path: str, idx: int) -> np.ndarray:
        """The image file at ``path``, transformed with item ``idx``'s
        generator."""
        out = self.image_transform(image=read_image(path), rng=self._rng(idx))
        return np.asarray(out["image"], np.float32)

    @staticmethod
    def collate_fn(items):
        return {k: np.stack([d[k] for d in items]) for k in items[0]}


class VOC07ClassificationDataset(_ImageFileDataset):
    """PASCAL VOC 2007 multi-label classification over
    ``ImageSets/Main/<class>_<split>.txt`` and ``JPEGImages/``.  Labels per
    class: 1 present, 0 absent, -1 ignore (VOC's "difficult")."""

    def __init__(self, data_root: str, split: str = "trainval",
                 image_transform: Optional[Callable] = None):
        self.image_transform = image_transform or T.DEFAULT_IMAGE_TRANSFORM
        ann_paths = sorted(glob.glob(
            os.path.join(data_root, "ImageSets", "Main", f"*_{split}.txt")))
        self.class_names = [os.path.basename(p).split("_")[0]
                            for p in ann_paths]
        labels: Dict[str, np.ndarray] = defaultdict(
            lambda: -np.ones(len(self.class_names), np.int32))
        for cls_num, ann_path in enumerate(ann_paths):
            with open(ann_path) as f:
                for line in f:
                    name, orig = line.strip().split()
                    orig = int(orig)
                    # VOC -1 (absent) -> 0; VOC 0 (difficult) -> -1 (ignore)
                    labels[name][cls_num] = 0 if orig == -1 else \
                        -1 if orig == 0 else 1
        self.instances = [
            (os.path.join(data_root, "JPEGImages", f"{name}.jpg"), lab)
            for name, lab in labels.items()]

    def __len__(self):
        return len(self.instances)

    def __getitem__(self, idx: int):
        path, label = self.instances[idx]
        return {"image": self._image(path, idx),
                "label": np.asarray(label, np.int64)}


class INaturalist2018Dataset(_ImageFileDataset):
    """iNaturalist 2018 from ``annotations/{split}2018.json``."""

    def __init__(self, data_root: str, split: str = "train",
                 image_transform: Optional[Callable] = None):
        self.image_transform = image_transform or T.DEFAULT_IMAGE_TRANSFORM
        with open(os.path.join(data_root, "annotations",
                               f"{split}2018.json")) as f:
            annotations = json.load(f)
        self.image_id_to_file_path = {
            ann["id"]: os.path.join(data_root, ann["file_name"])
            for ann in annotations["images"]}
        self.instances = [(a["image_id"], a["category_id"])
                          for a in annotations["annotations"]]

    def __len__(self):
        return len(self.instances)

    def __getitem__(self, idx: int):
        image_id, label = self.instances[idx]
        return {"image": self._image(self.image_id_to_file_path[image_id], idx),
                "label": np.int64(label)}


class ImageNetDataset(_ImageFileDataset):
    """ImageNet in its directory-per-class layout, ``{split}/<class>/*``,
    classes and files in sorted order; ``percentage`` below 100 keeps the
    first part of each class's train files (the data-efficiency
    ablations)."""

    def __init__(self, data_root: str, split: str = "train",
                 image_transform: Optional[Callable] = None,
                 percentage: float = 100.0):
        self.image_transform = image_transform or T.DEFAULT_IMAGE_TRANSFORM
        split_dir = os.path.join(data_root, split)
        classes = sorted(d for d in os.listdir(split_dir)
                         if os.path.isdir(os.path.join(split_dir, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            files = sorted(glob.glob(os.path.join(split_dir, c, "*")))
            if percentage < 100.0 and split == "train":
                keep = max(1, int(len(files) * percentage / 100.0))
                files = files[:keep]
            self.samples += [(f, self.class_to_idx[c]) for f in files]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int):
        path, label = self.samples[idx]
        return {"image": self._image(path, idx), "label": np.int64(label)}


class _RetrievalDataset(_ImageFileDataset):
    """Images with their captions: ``text`` (cleaned by ``pre_caption``),
    ``txt2img`` (caption index -> image index) and ``img2txt`` (image
    index -> its caption indices)."""

    def _index(self, images: List[str], captions: List[List[str]],
               max_words: int) -> None:
        self.image, self.text = list(images), []
        self.txt2img: Dict[int, int] = {}
        self.img2txt: Dict[int, List[int]] = {}
        for img_idx, caps in enumerate(captions):
            self.img2txt[img_idx] = []
            for caption in caps:
                self.img2txt[img_idx].append(len(self.text))
                self.txt2img[len(self.text)] = img_idx
                self.text.append(T.pre_caption(caption, max_words))

    def __len__(self):
        return len(self.image)


class ReEvalDataset(_RetrievalDataset):
    """COCO retrieval: every image of ``{split}2017/*.jpg`` (sorted; the
    id is the file name) with its captions from
    ``annotations/captions_{split}2017.json``."""

    def __init__(self, data_root: str, split: str = "val",
                 image_transform: Optional[Callable] = None,
                 max_words: int = 30):
        self.image_transform = image_transform or T.DEFAULT_IMAGE_TRANSFORM
        image_filenames = sorted(glob.glob(
            os.path.join(data_root, f"{split}2017", "*.jpg")))
        self.id_filename = [
            (int(os.path.basename(p)[:-4]), p) for p in image_filenames]
        with open(os.path.join(data_root, "annotations",
                               f"captions_{split}2017.json")) as f:
            captions = json.load(f)
        id_to_captions = defaultdict(list)
        for ann in captions["annotations"]:
            id_to_captions[ann["image_id"]].append(ann["caption"])
        self._index([p for _, p in self.id_filename],
                    [id_to_captions[i] for i, _ in self.id_filename],
                    max_words)

    def __getitem__(self, idx: int):
        return {"image": self._image(self.id_filename[idx][1], idx),
                "index": np.int64(idx)}


class FlickrReEvalDataset(_RetrievalDataset):
    """Flickr30k retrieval from an ALBEF-style json annotation file,
    ``[{"image": path under data_root, "caption": [str, ...]}]``."""

    def __init__(self, data_root: str, ann_file: str, split: str = "val",
                 image_transform: Optional[Callable] = None,
                 max_words: int = 30):
        self.image_transform = image_transform or T.DEFAULT_IMAGE_TRANSFORM
        with open(ann_file) as f:
            self.ann = json.load(f)
        self.image_root = data_root
        self._index([a["image"] for a in self.ann],
                    [a["caption"] for a in self.ann], max_words)

    def __getitem__(self, idx: int):
        path = os.path.join(self.image_root, self.ann[idx]["image"])
        return {"image": self._image(path, idx), "index": np.int64(idx)}


class CocoObjectGender(_ImageFileDataset):
    """The gender-labelled COCO subset of the bias analysis: ``{split}.pkl``
    under ``ann_dir`` (default ``data_root/gender_annotations``), a list of
    ``{image_id, filename (under data_root), gender ("man" or "woman"),
    boxes [[x0, y0, x1, y1], ...]}``; ``mask_mode`` none, blackout or blur
    masks the person boxes before the transforms.  ``gender`` is 0 for
    man, 1 for woman."""

    def __init__(self, data_root: str, split: str = "val",
                 ann_dir: Optional[str] = None,
                 image_transform: Optional[Callable] = None,
                 mask_mode: str = "none"):
        self.image_transform = image_transform or T.DEFAULT_IMAGE_TRANSFORM
        self.data_root = data_root
        self.mask_mode = mask_mode
        ann_dir = ann_dir or os.path.join(data_root, "gender_annotations")
        with open(os.path.join(ann_dir, f"{split}.pkl"), "rb") as f:
            self.ann = pickle.load(f)
        self._masker = {"none": None, "blackout": T.BlackoutBox(),
                        "blur": T.BlurBox()}[mask_mode]

    def __len__(self):
        return len(self.ann)

    def __getitem__(self, idx: int):
        rng = self._rng(idx)
        ann = self.ann[idx]
        image = read_image(os.path.join(self.data_root, ann["filename"]))
        sample = {"image": image, "boxes": ann.get("boxes", [])}
        if self._masker is not None:
            sample = self._masker(sample, rng)
        out = self.image_transform(image=sample["image"], rng=rng)
        return {
            "image": np.asarray(out["image"], np.float32),
            "gender": np.int64(0 if ann["gender"] == "man" else 1),
            "image_id": np.int64(ann["image_id"]),
        }


__all__ = ["CaptionDatasetBase", "CocoCaptionsClusteredDataset",
           "CocoCaptionsDataset", "CocoObjectGender", "Dataset",
           "FlickrReEvalDataset", "INaturalist2018Dataset", "ImageNetDataset",
           "JsonDataset", "RandomDataset", "ReEvalDataset",
           "VOC07ClassificationDataset"]
