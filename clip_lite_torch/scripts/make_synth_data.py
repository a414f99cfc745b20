"""Generate the synthetic LEARNABLE caption corpus in COCO layout, the
counterpart of the JAX package's ``scripts/make_synth_data.py``: the same
command line, the same trees, and for a seed the same scenes and captions
(the same ``np.random.RandomState`` draws in the same order).

Each image shows ONE shape in ONE colour on a noisy background of another
colour; its captions name both and usually the position, size and
background, from varied templates.  (colour, shape, position, size,
background) has 9216 combinations, so val captions are near-unique and
retrieval is judged per image, not per class.  A model trained on it must
learn to ground words in pixels, which the held-out retrieval, zero-shot,
linear-probe, VOC07 SVM and bias evaluations then measure
(``scripts/quality_campaign.py``).

The trees:

  <out>/coco/images/{train,val}2017/*.jpg      CocoCaptionsDirReader
  <out>/coco/{train,val}2017 -> images/...     (symlink) ReEvalDataset
  <out>/coco/annotations/captions_*2017.json   both of the above
  <out>/imagenet/{train,val}/<color>_<shape>/  ImageNetDataset (zero-shot
                                               and the linear probe)
  <out>/VOC2007/JPEGImages + ImageSets/Main    VOC07ClassificationDataset
                                               (16 labels: 8 colours + 8
                                               shapes; the background
                                               colour is VOC's "difficult")
  <out>/coco_gender/images + gender_annotations/{split}.pkl
                                               CocoObjectGender (the
                                               protected attribute is the
                                               shape's colour: red stands
                                               for "man", blue for "woman")

The shapes are drawn by ``scripts/drawing.py``, OpenCV's integer rules in
numpy, so that the pixels before encoding equal the JAX script's, which
draws with OpenCV; the images are encoded as JPEG at quality 95 by PIL
where the JAX script uses ``cv2.imwrite`` (``tests/test_torch_synth_data.py``
holds both).

Pipeline (on the card; add ``--device cpu`` to the CLIs on the CPU):
    python -m clip_lite_torch.scripts.make_synth_data --output-dir /tmp/synth
    python -m clip_lite_torch.scripts.coco_preprocess \\
        --data-root /tmp/synth/coco --split train --mode train_sbert \\
        --output-dir /tmp/synth/serialized --short-edge 256
    python -m clip_lite_torch.train --config configs/fs_tpu_tuned.yaml ...
    python -m clip_lite_torch.scripts.quality_campaign --run-dir ... \\
        --synth-root /tmp/synth
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np

from clip_lite_torch.data.readers import encode_image
from clip_lite_torch.scripts import drawing

parser = argparse.ArgumentParser(
    description="Synthetic learnable caption corpus (COCO layout).")
parser.add_argument("--output-dir", required=True)
parser.add_argument("--train-n", type=int, default=4000)
parser.add_argument("--val-n", type=int, default=500)
parser.add_argument("--zeroshot-per-class", type=int, default=8)
parser.add_argument("--probe-train-per-class", type=int, default=12,
                    help="imagenet/train images per class (linear probe).")
parser.add_argument("--voc-trainval", type=int, default=320)
parser.add_argument("--voc-test", type=int, default=160)
parser.add_argument("--gender-n", type=int, default=240,
                    help="coco_gender val images (red/blue populations).")
parser.add_argument("--image-size", type=int, default=256)
parser.add_argument("--seed", type=int, default=0)

# RGB; names appear verbatim in captions and class names.
COLORS = {
    "red": (220, 40, 40), "green": (40, 180, 60), "blue": (40, 80, 220),
    "yellow": (235, 220, 50), "purple": (160, 60, 200),
    "orange": (240, 140, 30), "cyan": (60, 210, 220),
    "white": (245, 245, 245),
}
SHAPES = ("circle", "square", "triangle", "ring", "cross", "diamond",
          "star", "stripe")
POSITIONS = ("top left", "top", "top right", "left", "center", "right",
             "bottom left", "bottom", "bottom right")
SIZES = ("small", "large")

_TEMPLATES = (
    "a {size} {color} {shape} in the {pos} on a {bg} background",
    "a photo of a {color} {shape} in the {pos} of the frame",
    "a {size} {color} {shape} over a {bg} backdrop",
    "there is a {color} {shape} near the {pos}",
    "a picture showing a {size} {color} {shape} on {bg}",
    "the {pos} of the image has a {color} {shape}",
)
JPEG_QUALITY = 95


def _draw_shape(img: np.ndarray, shape: str, color, cx: int, cy: int,
                r: int) -> None:
    c = tuple(int(v) for v in color)
    if shape == "circle":
        drawing.circle(img, (cx, cy), r, c, -1)
    elif shape == "ring":
        drawing.circle(img, (cx, cy), r, c, max(2, r // 3))
    elif shape == "square":
        drawing.rectangle(img, (cx - r, cy - r), (cx + r, cy + r), c)
    elif shape == "diamond":
        drawing.fill_poly(img, [[cx, cy - r], [cx + r, cy], [cx, cy + r],
                                [cx - r, cy]], c)
    elif shape == "triangle":
        drawing.fill_poly(img, [[cx, cy - r], [cx + r, cy + r],
                                [cx - r, cy + r]], c)
    elif shape == "cross":
        w = max(2, r // 3)
        drawing.rectangle(img, (cx - r, cy - w), (cx + r, cy + w), c)
        drawing.rectangle(img, (cx - w, cy - r), (cx + w, cy + r), c)
    elif shape == "star":
        ang = np.arange(10) * np.pi / 5 - np.pi / 2
        rad = np.where(np.arange(10) % 2 == 0, r, r * 0.45)
        pts = np.stack([cx + rad * np.cos(ang),
                        cy + rad * np.sin(ang)], 1).astype(np.int32)
        drawing.fill_poly(img, pts.tolist(), c)
    elif shape == "stripe":
        w = max(3, r // 2)
        drawing.rectangle(img, (cx - r, cy - w), (cx + r, cy + w), c)
    else:  # pragma: no cover - guarded by SHAPES
        raise KeyError(shape)


def render(rng: np.random.RandomState, size: int, color_name: str,
           shape: str, pos_idx: int, size_name: str, bg_name: str
           ) -> tuple:
    """One (colour, shape, position, size, background) scene, with noise
    and brightness jitter so that the mapping is not pixel-trivial.
    Returns ``(image, box)``, box the shape's (x0, y0, x1, y1)."""
    bg = np.asarray(COLORS[bg_name], np.float32) * rng.uniform(0.25, 0.55)
    img = np.tile(bg.astype(np.uint8), (size, size, 1)).astype(np.uint8)
    noise = rng.normal(0, 12, img.shape)
    img = np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)

    row, col = divmod(pos_idx, 3)
    cell = size // 3
    cx = int(col * cell + cell // 2 + rng.randint(-cell // 6, cell // 6 + 1))
    cy = int(row * cell + cell // 2 + rng.randint(-cell // 6, cell // 6 + 1))
    r = (rng.randint(size // 14, size // 9) if size_name == "small"
         else rng.randint(size // 6, size // 4))
    color = np.asarray(COLORS[color_name], np.float32) * rng.uniform(.8, 1.)
    _draw_shape(img, shape, color, cx, cy, r)
    box = [max(0, cx - r), max(0, cy - r),
           min(size - 1, cx + r), min(size - 1, cy + r)]
    return img, box


def _write_jpeg(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_image(img, JPEG_QUALITY))


def _captions(rng: np.random.RandomState, color: str, shape: str,
              pos: str, size_name: str, bg: str, n: int = 2) -> list:
    picks = rng.choice(len(_TEMPLATES), size=n, replace=False)
    return [_TEMPLATES[t].format(color=color, shape=shape, pos=pos,
                                 size=size_name, bg=bg) for t in picks]


def _sample_scene(rng: np.random.RandomState):
    color = list(COLORS)[rng.randint(len(COLORS))]
    shape = SHAPES[rng.randint(len(SHAPES))]
    pos_idx = rng.randint(9)
    size_name = SIZES[rng.randint(2)]
    bg_choices = [c for c in COLORS if c != color]
    bg = bg_choices[rng.randint(len(bg_choices))]
    return color, shape, pos_idx, size_name, bg


def _write_split(root: str, split: str, n: int, size: int,
                 rng: np.random.RandomState) -> None:
    img_dir = os.path.join(root, "images", f"{split}2017")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    # ReEvalDataset looks for <root>/{split}2017 (no images/ prefix),
    # CocoCaptionsDirReader for <root>/images/{split}2017: link them.
    link = os.path.join(root, f"{split}2017")
    if not os.path.exists(link):
        os.symlink(os.path.join("images", f"{split}2017"), link)

    images, annotations = [], []
    ann_id = 1
    for i in range(n):
        color, shape, pos_idx, size_name, bg = _sample_scene(rng)
        img, _ = render(rng, size, color, shape, pos_idx, size_name, bg)
        fname = f"{i:012d}.jpg"
        _write_jpeg(os.path.join(img_dir, fname), img)
        images.append({"id": i, "file_name": fname,
                       "height": size, "width": size})
        for cap in _captions(rng, color, shape, POSITIONS[pos_idx],
                             size_name, bg):
            annotations.append(
                {"id": ann_id, "image_id": i, "caption": cap})
            ann_id += 1
    with open(os.path.join(root, "annotations",
                           f"captions_{split}2017.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    print(f"{split}: {n} images, {len(annotations)} captions")


def _write_imagenet(root: str, split: str, per_class: int, size: int,
                    rng: np.random.RandomState) -> None:
    """A directory per class over all 64 (colour, shape) classes: val
    feeds the zero-shot CLI, train and val the linear probe."""
    for color in COLORS:
        for shape in SHAPES:
            d = os.path.join(root, split, f"{color}_{shape}")
            os.makedirs(d, exist_ok=True)
            for j in range(per_class):
                pos_idx = rng.randint(9)
                size_name = SIZES[rng.randint(2)]
                bg = [c for c in COLORS if c != color][
                    rng.randint(len(COLORS) - 1)]
                img, _ = render(rng, size, color, shape, pos_idx,
                                size_name, bg)
                _write_jpeg(os.path.join(d, f"{j:05d}.jpg"), img)
    n_cls = len(COLORS) * len(SHAPES)
    print(f"imagenet/{split}: {n_cls} classes x {per_class} images")


def _write_voc(root: str, split: str, n: int, size: int,
               rng: np.random.RandomState) -> None:
    """The VOC2007 layout for the SVM evaluation: 16 multi-label classes
    (8 colours + 8 shapes).  An image is positive for its shape's colour
    and shape; its background colour is written as VOC's raw 0
    ("difficult"), which the reader maps to ignore."""
    img_dir = os.path.join(root, "JPEGImages")
    set_dir = os.path.join(root, "ImageSets", "Main")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(set_dir, exist_ok=True)
    classes = list(COLORS) + list(SHAPES)
    lines = {c: [] for c in classes}
    for i in range(n):
        color, shape, pos_idx, size_name, bg = _sample_scene(rng)
        img, _ = render(rng, size, color, shape, pos_idx, size_name, bg)
        name = f"{split}_{i:06d}"
        _write_jpeg(os.path.join(img_dir, f"{name}.jpg"), img)
        for c in classes:
            raw = 1 if c in (color, shape) else 0 if c == bg else -1
            lines[c].append(f"{name} {raw}")
    for c in classes:
        with open(os.path.join(set_dir, f"{c}_{split}.txt"), "w") as f:
            f.write("\n".join(lines[c]) + "\n")
    print(f"VOC2007/{split}: {n} images, {len(classes)} classes")


def _write_gender(root: str, split: str, n: int, size: int,
                  rng: np.random.RandomState) -> None:
    """The coco_gender layout for the bias analysis: the protected
    attribute is the shape's colour, red scenes the "man" population and
    blue ones the "woman" one, so that the definitional pairs are colour
    pairs ("a photo of a blue circle" / "a photo of a red circle")."""
    img_dir = os.path.join(root, "images")
    ann_dir = os.path.join(root, "gender_annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    ann = []
    for i in range(n):
        color = "red" if i % 2 == 0 else "blue"
        _, shape, pos_idx, size_name, _ = _sample_scene(rng)
        bg = [c for c in COLORS if c != color][rng.randint(len(COLORS) - 1)]
        img, box = render(rng, size, color, shape, pos_idx, size_name, bg)
        fname = f"images/{i:06d}.jpg"
        _write_jpeg(os.path.join(root, fname), img)
        ann.append({"image_id": i, "filename": fname,
                    "gender": "man" if color == "red" else "woman",
                    "boxes": [box]})
    with open(os.path.join(ann_dir, f"{split}.pkl"), "wb") as f:
        pickle.dump(ann, f)
    print(f"coco_gender/{split}: {n} images ({n // 2} per population)")


def main(args) -> str:
    rng = np.random.RandomState(args.seed)
    coco_root = os.path.join(args.output_dir, "coco")
    if args.train_n:  # 0 = leave an existing corpus untouched
        _write_split(coco_root, "train", args.train_n, args.image_size, rng)
    if args.val_n:
        _write_split(coco_root, "val", args.val_n, args.image_size, rng)
    imnet = os.path.join(args.output_dir, "imagenet")
    if args.zeroshot_per_class:
        _write_imagenet(imnet, "val", args.zeroshot_per_class,
                        args.image_size, rng)
    if args.probe_train_per_class:
        _write_imagenet(imnet, "train", args.probe_train_per_class,
                        args.image_size, rng)
    voc = os.path.join(args.output_dir, "VOC2007")
    if args.voc_trainval:
        _write_voc(voc, "trainval", args.voc_trainval, args.image_size, rng)
    if args.voc_test:
        _write_voc(voc, "test", args.voc_test, args.image_size, rng)
    if args.gender_n:
        _write_gender(os.path.join(args.output_dir, "coco_gender"), "val",
                      args.gender_n, args.image_size, rng)
    return coco_root


if __name__ == "__main__":
    main(parser.parse_args())
