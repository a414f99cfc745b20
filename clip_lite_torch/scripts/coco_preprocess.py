"""Serialize COCO Captions into the CLRec record files that the training
CLI reads, the counterpart of the JAX package's
``scripts/coco_preprocess.py``: one record per image that has captions,
``{"image_id", "image": JPEG bytes, "captions": [str, ...]}``, in the
annotation file's order, into
``{output_dir}/coco_{split}_{mode}2017.clrec`` (and its ``.idx``).

The input is COCO's own layout (``images/{split}2017/*.jpg`` and
``annotations/captions_{split}2017.json``), read by the port's
``CocoCaptionsDirReader`` (PIL, EXIF orientation applied).  With
``--short-edge`` an image whose short side is longer is resized to it by
area (OpenCV's ``INTER_AREA``, the port's own ``imgproc.resize_area``);
it is then encoded as JPEG at ``--jpeg-quality`` by PIL, where the JAX
script encodes with OpenCV: the records' images decode to the JAX
script's pixels (``tests/test_torch_coco_preprocess.py``).

Modes: ``train_sbert`` and ``glove`` store the caption strings.
``sbert`` would add each record's ``caption_encodings`` from a
SentenceTransformer model, which neither the port nor its machines have,
so it raises; the sbert datasets read such records wherever they come
from (``data/datasets.py``).

Usage:
    python -m clip_lite_torch.scripts.coco_preprocess \\
        --data-root datasets/coco --split train --mode train_sbert \\
        --output-dir datasets/serialized [--short-edge 640]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from clip_lite_torch.data.imgproc import resize_area
from clip_lite_torch.data.readers import (
    ClRecWriter,
    CocoCaptionsDirReader,
    encode_image,
)

parser = argparse.ArgumentParser(
    description="Serialize COCO Captions into CLRec record files.")
parser.add_argument("--data-root", required=True)
parser.add_argument("--split", default="train", choices=["train", "val"])
parser.add_argument("--mode", default="train_sbert",
                    choices=["train_sbert", "glove", "sbert"])
parser.add_argument("--output-dir", required=True)
parser.add_argument("--short-edge", type=int, default=0,
                    help="Resize so the short edge is this (0 = keep).")
parser.add_argument("--jpeg-quality", type=int, default=95)


def maybe_resize(image: np.ndarray, short_edge: int) -> np.ndarray:
    """``image`` with its short side brought down to ``short_edge`` by
    area (the long side rounded), unless it is no longer already."""
    if not short_edge:
        return image
    h, w = image.shape[:2]
    if min(h, w) <= short_edge:
        return image
    scale = short_edge / min(h, w)
    return resize_area(image, int(round(w * scale)), int(round(h * scale)))


def main(args) -> str:
    """Write the records; returns the path of the CLRec file."""
    if args.mode == "sbert":
        raise NotImplementedError(
            "--mode sbert encodes the captions with a SentenceTransformer "
            "model, and none is available here (no sentence-transformers, no "
            "network); use train_sbert or glove")
    reader = CocoCaptionsDirReader(args.data_root, args.split)
    os.makedirs(args.output_dir, exist_ok=True)
    out = os.path.join(args.output_dir,
                       f"coco_{args.split}_{args.mode}2017.clrec")
    with ClRecWriter(out) as writer:
        for i in range(len(reader)):
            rec = reader[i]
            image = maybe_resize(rec["image"], args.short_edge)
            writer.append({"image_id": rec["image_id"],
                           "image": encode_image(image, args.jpeg_quality),
                           "captions": rec["captions"]})
            if (i + 1) % 5000 == 0:
                print(f"{i + 1}/{len(reader)} records")
    print(f"Wrote {len(reader)} records to {out}")
    return out


if __name__ == "__main__":
    main(parser.parse_args())
