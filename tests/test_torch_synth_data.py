"""The port's synthetic corpora against the JAX package's scripts, on the
CPU (OpenCV, which the tests import and the port does not, is the
oracle).

* The rasteriser (``scripts/drawing.py``): every shape of
  ``make_synth_data`` at every size class, at 32, 64 and 256 px, over
  seeded scenes through both scripts' ``render`` (background, noise and
  shape), and each primitive alone at random places, the image's borders
  crossed: the pixels equal OpenCV's bit for bit.
* A tiny corpus from both ``make_synth_data`` scripts: the same file
  lists, annotation JSON, VOC sets and gender pickle; the JPEGs decode
  within a mean of 1 level of each other (PIL's encoder against
  OpenCV's).
* ``make_mock_data`` and ``coco_to_json``: the same trees and JSON.
"""

import json
import os
import pickle

import cv2
import numpy as np
import pytest
from PIL import Image

from clip_lite_torch.scripts import coco_to_json, drawing
from clip_lite_torch.scripts import make_mock_data, make_synth_data
from clip_lite_tpu.scripts import coco_to_json as jcoco_to_json
from clip_lite_tpu.scripts import make_mock_data as jmake_mock_data
from clip_lite_tpu.scripts import make_synth_data as jmake_synth_data

IMAGE_SIZES = (32, 64, 256)
SCENES = 6  # per (image size, shape, size class)


@pytest.mark.parametrize("image_size", IMAGE_SIZES)
@pytest.mark.parametrize("shape", make_synth_data.SHAPES)
def test_render_matches_opencv(shape, image_size):
    colors = list(make_synth_data.COLORS)
    for s, size_name in enumerate(make_synth_data.SIZES):
        for i in range(SCENES):
            seed = (image_size * 1000 + make_synth_data.SHAPES.index(shape)
                    * 100 + s * 10 + i)
            pick = np.random.RandomState(seed)
            color, bg = pick.choice(colors, 2, replace=False)
            pos = pick.randint(9)
            ours, box = make_synth_data.render(
                np.random.RandomState(seed), image_size, color, shape, pos,
                size_name, bg)
            theirs, jbox = jmake_synth_data.render(
                np.random.RandomState(seed), image_size, color, shape, pos,
                size_name, bg)
            assert box == jbox
            assert np.array_equal(ours, theirs), (shape, image_size,
                                                  size_name, i)


def _star(cx, cy, r):
    ang = np.arange(10) * np.pi / 5 - np.pi / 2
    rad = np.where(np.arange(10) % 2 == 0, r, r * 0.45)
    return np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)],
                    1).astype(np.int32)


# Each primitive as make_synth_data calls it: (OpenCV's call, the port's).
PRIMITIVES = {
    "filled circle": (lambda im, cx, cy, r, c: cv2.circle(im, (cx, cy), r, c, -1),
                      lambda im, cx, cy, r, c: drawing.circle(im, (cx, cy), r, c,
                                                              -1)),
    "ring": (lambda im, cx, cy, r, c: cv2.circle(im, (cx, cy), r, c,
                                                 max(2, r // 3)),
             lambda im, cx, cy, r, c: drawing.circle(im, (cx, cy), r, c,
                                                     max(2, r // 3))),
    "rectangle": (lambda im, cx, cy, r, c: cv2.rectangle(
        im, (cx - r, cy - r // 2), (cx + r, cy + r // 2), c, -1),
        lambda im, cx, cy, r, c: drawing.rectangle(
        im, (cx - r, cy - r // 2), (cx + r, cy + r // 2), c)),
    "triangle": (lambda im, cx, cy, r, c: cv2.fillPoly(im, [np.array(
        [[cx, cy - r], [cx + r, cy + r], [cx - r, cy + r]])], c),
        lambda im, cx, cy, r, c: drawing.fill_poly(
        im, [[cx, cy - r], [cx + r, cy + r], [cx - r, cy + r]], c)),
    "diamond": (lambda im, cx, cy, r, c: cv2.fillPoly(im, [np.array(
        [[cx, cy - r], [cx + r, cy], [cx, cy + r], [cx - r, cy]])], c),
        lambda im, cx, cy, r, c: drawing.fill_poly(
        im, [[cx, cy - r], [cx + r, cy], [cx, cy + r], [cx - r, cy]], c)),
    "star": (lambda im, cx, cy, r, c: cv2.fillPoly(im, [_star(cx, cy, r)], c),
             lambda im, cx, cy, r, c: drawing.fill_poly(
                 im, _star(cx, cy, r).tolist(), c)),
}


@pytest.mark.parametrize("size", (32, 64))
@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_primitive_matches_opencv_across_borders(name, size):
    """Centres from a quarter of the image outside it to a quarter beyond,
    radii up to a third of it: the clipping paths of every routine."""
    cv_draw, our_draw = PRIMITIVES[name]
    rng = np.random.RandomState(size)
    for _ in range(150):
        cx, cy = (int(v) for v in rng.randint(-size // 4, size + size // 4, 2))
        r = int(rng.randint(2, size // 3 + 3))
        c = tuple(int(v) for v in rng.randint(1, 256, 3))
        theirs = np.zeros((size, size, 3), np.uint8)
        ours = theirs.copy()
        cv_draw(theirs, cx, cy, r, c)
        our_draw(ours, cx, cy, r, c)
        assert np.array_equal(ours, theirs), (name, cx, cy, r)


def test_sine_table_is_opencvs():
    """Four entries of OpenCV's table, as its source spells them."""
    np.testing.assert_array_equal(
        drawing._SIN_TABLE[[0, 1, 45, 90]],
        np.float32([0.0, 0.0174524, 0.7071068, 1.0]))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _decode_opencv(path):
    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB).astype(np.float64)


def _decode_pil(path):
    return np.asarray(Image.open(path).convert("RGB"), np.float64)


SYNTH_ARGS = ["--train-n", "12", "--val-n", "6", "--zeroshot-per-class", "1",
              "--probe-train-per-class", "1", "--voc-trainval", "6",
              "--voc-test", "4", "--gender-n", "4", "--image-size", "64",
              "--seed", "3"]


def test_synth_corpus_matches_jax(tmp_path):
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    make_synth_data.main(make_synth_data.parser.parse_args(
        ["--output-dir", ours] + SYNTH_ARGS))
    jmake_synth_data.main(jmake_synth_data.parser.parse_args(
        ["--output-dir", theirs] + SYNTH_ARGS))
    files = _files(ours)
    assert files == _files(theirs) and len(files) > 150
    for name in files:
        a, b = os.path.join(ours, name), os.path.join(theirs, name)
        if name.endswith(".jpg"):
            diff = np.abs(_decode_pil(a) - _decode_opencv(b)).mean()
            assert diff <= 1.0, name
        elif name.endswith(".pkl"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert pickle.load(fa) == pickle.load(fb), name
        else:  # annotation JSON, VOC sets
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name
    for split in ("train", "val"):  # the links ReEvalDataset reads through
        assert os.readlink(os.path.join(ours, "coco", f"{split}2017")) == \
            os.readlink(os.path.join(theirs, "coco", f"{split}2017"))


def test_mock_data_matches_jax(tmp_path):
    args = ["--num-records", "6", "--image-size", "48"]
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    make_mock_data.main(make_mock_data.parser.parse_args(
        ["--output-dir", ours] + args))
    jmake_mock_data.main(jmake_mock_data.parser.parse_args(
        ["--output-dir", theirs] + args))
    assert _files(ours) == _files(theirs)
    with open(os.path.join(ours, "mock_data.json")) as f:
        records = json.load(f)
    with open(os.path.join(theirs, "mock_data.json")) as f:
        jrecords = json.load(f)
    assert [r["caption"] for r in records] == [r["caption"] for r in jrecords]
    for r, j in zip(records, jrecords):
        assert os.path.relpath(r["image"], ours) == \
            os.path.relpath(j["image"], theirs)
        diff = np.abs(_decode_pil(r["image"]) - _decode_opencv(j["image"]))
        assert diff.mean() <= 1.0, r["image"]


def test_coco_to_json_matches_jax(tmp_path):
    root = str(tmp_path / "synth")
    make_synth_data.main(make_synth_data.parser.parse_args(
        ["--output-dir", root, "--train-n", "5", "--val-n", "0",
         "--zeroshot-per-class", "0", "--probe-train-per-class", "0",
         "--voc-trainval", "0", "--voc-test", "0", "--gender-n", "0",
         "--image-size", "32"]))
    coco = os.path.join(root, "coco")
    for module, out in ((coco_to_json, "ours.json"),
                        (jcoco_to_json, "theirs.json")):
        module.main(module.parser.parse_args(
            ["--coco-root", coco, "--split", "train",
             "--output", str(tmp_path / out)]))
    ours = (tmp_path / "ours.json").read_text()
    assert ours == (tmp_path / "theirs.json").read_text()
    assert len(json.loads(ours)) == 5
