"""The port's COCO-to-CLRec script (``python -m
clip_lite_torch.scripts.coco_preprocess``) against the JAX package's
(``clip_lite_tpu.scripts.coco_preprocess``) on a tiny COCO tree (six
images of three shapes, 1-5 captions each, an image without captions
left out), with ``--short-edge`` 0 and 32:

* the same records in the same order: count, ``image_id`` and captions;
* the resize before the encode equals OpenCV's ``INTER_AREA`` exactly;
* the images, JPEG bytes of PIL's encoder in the port and of OpenCV's in
  the JAX script, decode (both with OpenCV) to the same pixels: the bar
  is equality, as measured (both encoders are libjpeg-turbo at the same
  quality, 4:2:0 and the standard tables; with PIL 12.1 and OpenCV 5.0
  even the bytes are the same);
* ``--mode sbert`` raises: no SentenceTransformer model is on either machine.
"""

import argparse
import json
import os

import cv2
import numpy as np
import pytest
from PIL import Image

from clip_lite_tpu.data import readers as jreaders
from clip_lite_tpu.scripts import coco_preprocess as jscript
from clip_lite_torch.data import readers
from clip_lite_torch.scripts import coco_preprocess as script

SHAPES = [(48, 64), (64, 48), (40, 56)]


def write_coco_tree(root, n=6, seed=0):
    """COCO's own layout under ``root``: ``images/train2017/*.jpg`` (PIL,
    quality 95) and ``annotations/captions_train2017.json``; image i has
    1 + i % 5 captions, and one more image has none."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images", "train2017"))
    os.makedirs(os.path.join(root, "annotations"))
    images, anns = [], []
    for i in range(n + 1):
        h, w = SHAPES[i % len(SHAPES)]
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([(xx * (3 + i) + yy * c * 5) % 256 for c in range(3)],
                       axis=-1).astype(np.uint8)
        img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)
        name = f"{500 + 3 * i:012d}.jpg"
        Image.fromarray(img).save(os.path.join(root, "images", "train2017",
                                               name), quality=95)
        images.append({"id": 500 + 3 * i, "file_name": name})
        if i < n:
            anns += [{"image_id": 500 + 3 * i,
                      "caption": f"image {i} caption {k}"}
                     for k in range(1 + i % 5)]
    rng.shuffle(anns)
    with open(os.path.join(root, "annotations", "captions_train2017.json"),
              "w") as f:
        json.dump({"images": images, "annotations": anns}, f)
    return str(root)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_coco_tree(tmp_path_factory.mktemp("coco"))


def _args(tree, out, short_edge, mode="train_sbert"):
    return argparse.Namespace(data_root=tree, split="train", mode=mode,
                              output_dir=str(out), short_edge=short_edge,
                              jpeg_quality=95, sbert_model="unused")


@pytest.mark.parametrize("short_edge", [0, 32])
def test_records_equal_jax(tree, tmp_path, short_edge):
    ours = readers.ClRecReader(script.main(_args(tree, tmp_path / "ours",
                                                 short_edge)))
    theirs = jreaders.ClRecReader(jscript.main(_args(tree, tmp_path / "jax",
                                                     short_edge)))
    assert os.path.basename(ours.path) == os.path.basename(theirs.path) == \
        "coco_train_train_sbert2017.clrec"
    assert len(ours) == len(theirs) == 6
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a["image_id"] == b["image_id"] and a["captions"] == b["captions"]
        assert isinstance(a["image"], bytes)
        got = cv2.imdecode(np.frombuffer(a["image"], np.uint8), cv2.IMREAD_COLOR)
        want = cv2.imdecode(np.frombuffer(b["image"], np.uint8),
                            cv2.IMREAD_COLOR)
        assert got.shape == want.shape
        if short_edge:
            assert min(got.shape[:2]) == short_edge
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,short_edge", [((48, 64), 32), ((64, 48), 32),
                                              ((40, 56), 25), ((30, 20), 32)])
def test_resize_equals_opencv_area(shape, short_edge):
    image = np.random.default_rng(3).integers(0, 256, (*shape, 3), np.uint8)
    np.testing.assert_array_equal(script.maybe_resize(image, short_edge),
                                  jscript.maybe_resize(image, short_edge))


def test_sbert_mode_raises(tree, tmp_path):
    # No SentenceTransformer model is on either machine; the message says so.
    with pytest.raises(NotImplementedError, match="SentenceTransformer"):
        script.main(_args(tree, tmp_path, 0, mode="sbert"))
