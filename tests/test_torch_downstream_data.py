"""The port's downstream eval datasets (clip_lite_torch/data/datasets.py)
and ``DownstreamDatasetFactory`` against the JAX package's, on small
synthetic trees of JPEG files in each dataset's real layout:

* COCO retrieval (``val2017/*.jpg``, ``annotations/captions_val2017.json``),
  Flickr30k (``data/flickr30k_test.json``), VOC07 (``JPEGImages/``,
  ``ImageSets/Main/<class>_{trainval,test}.txt`` with absent, difficult and
  present labels), ImageNet (``{train,val}/<class>/``, a PNG named
  ``.JPEG`` among them), iNaturalist (``annotations/{split}2018.json``),
  the gender-labelled COCO subset (``gender_annotations/val.pkl`` with
  boxes, every mask mode), and ``JsonDataset`` (pretraining).
* Each item equals the JAX dataset's: images within one grey level
  (normalized, the bar of tests/test_torch_transforms.py), through the
  train transforms (their draws from the item's generator) and the val
  ones; labels, ids, texts, ``txt2img``/``img2txt`` and class maps equal.
* ``BlackoutBox`` and ``BlurBox`` against OpenCV's: a box inside the
  image, at its edge, 5 px wide, and past the image's edge.
* The factory's keys and their transforms' split.

The tree writers here serve tests/test_torch_eval_cli.py too.
"""

import json
import os
import pickle

import numpy as np
import pytest
from PIL import Image

from clip_lite_tpu.config import Config as JConfig
from clip_lite_tpu.data import datasets as jdatasets
from clip_lite_tpu.data import transforms as JT
from clip_lite_tpu.factories import DownstreamDatasetFactory as JFactory
from clip_lite_torch.config import Config
from clip_lite_torch.data import datasets
from clip_lite_torch.data import transforms as T
from clip_lite_torch.factories import (
    DownstreamDatasetFactory,
    PretrainingDatasetFactory,
)

CROP = 32
LEVEL = 1.0 / (255 * min(T.IMAGENET_COLOR_STD)) * (1 + 1e-6)
WORDS = ("a man woman dog cat on the beach with red car plate of food "
         "street city riding sitting next to two young").split()
VOC_CLASSES = ("bird", "car", "person")
GENDER_BOXES = ([], [[4, 6, 30, 40]], [[0, 0, 56, 12]], [[20, 3, 25, 44]],
                [[30, 20, 70, 60]], [[2.5, 3.7, 19.2, 22.9]])


def photo(seed, h=40, w=56):
    """A seeded image with smooth structure and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    phase = rng.uniform(0, 6, 3)
    base = np.stack([np.sin(xx / (4.0 + c) + phase[c]) * np.cos(yy / 5.0)
                     for c in range(3)], axis=-1)
    noise = rng.normal(0, 0.2, (h, w, 3))
    return np.clip((base + noise + 1) * 127.5, 0, 255).astype(np.uint8)


def save_jpeg(path, seed, h=40, w=56):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(photo(seed, h, w)).save(path, "JPEG", quality=90)


def caption(rng):
    return " ".join(rng.choice(WORDS, rng.integers(3, 9))).capitalize() + "."


def write_coco(root, n=6, seed=0):
    """``root/coco``: n images, image i with 1 + i % 5 captions."""
    rng = np.random.default_rng(seed)
    root = os.path.join(root, "coco")
    anns = []
    for i in range(n):
        image_id = 1000 + 7 * i
        save_jpeg(os.path.join(root, "val2017", f"{image_id:012d}.jpg"),
                  seed + i, 40 + 4 * (i % 3), 56)
        anns += [{"image_id": image_id, "caption": caption(rng)}
                 for _ in range(1 + i % 5)]
    os.makedirs(os.path.join(root, "annotations"))
    with open(os.path.join(root, "annotations", "captions_val2017.json"),
              "w") as f:
        json.dump({"annotations": anns}, f)
    return root


def write_flickr(root, n=4, seed=10):
    rng = np.random.default_rng(seed)
    root = os.path.join(root, "flickr30k")
    ann = []
    for i in range(n):
        name = f"images/{i}.jpg"
        save_jpeg(os.path.join(root, name), seed + i)
        ann.append({"image": name, "caption": [caption(rng) for _ in range(3)]})
    os.makedirs(os.path.join(root, "data"))
    with open(os.path.join(root, "data", "flickr30k_test.json"), "w") as f:
        json.dump(ann, f)
    return root


def write_voc(root, n_trainval=24, n_test=12, seed=20):
    """``root/VOC2007``: each image's label per class drawn from absent
    (-1), difficult (0) and present (1), the first two of each split
    present and absent in every class, so that every fold sees both."""
    rng = np.random.default_rng(seed)
    root = os.path.join(root, "VOC2007")
    main = os.path.join(root, "ImageSets", "Main")
    os.makedirs(main)
    for split, n, start in (("trainval", n_trainval, 0),
                            ("test", n_test, n_trainval)):
        names = [f"{start + i:06d}" for i in range(n)]
        for name in names:
            save_jpeg(os.path.join(root, "JPEGImages", f"{name}.jpg"),
                      seed + int(name))
        for cls in VOC_CLASSES:
            labels = rng.choice([-1, 0, 1], n, p=[0.5, 0.1, 0.4])
            labels[:2] = (1, -1)
            with open(os.path.join(main, f"{cls}_{split}.txt"), "w") as f:
                f.writelines(f"{name} {lab:2d}\n"
                             for name, lab in zip(names, labels))
    return root


def write_imagenet(root, classes=("n01", "n02", "n03"), n_train=6, n_val=3,
                   seed=40):
    root = os.path.join(root, "imagenet")
    for ci, cls in enumerate(classes):
        for split, n in (("train", n_train), ("val", n_val)):
            for i in range(n):
                path = os.path.join(root, split, cls, f"{cls}_{i}.JPEG")
                s = seed + 100 * ci + 10 * (split == "val") + i
                if ci == 1 and i == 0:  # a PNG named .JPEG, as ImageNet has
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    Image.fromarray(photo(s)).save(path, "PNG")
                else:
                    save_jpeg(path, s)
    return root


def write_inaturalist(root, n=5, seed=60):
    root = os.path.join(root, "inaturalist")
    images, annotations = [], []
    for i in range(n):
        name = f"train_val2018/Plantae/{i}/x{i}.jpg"
        save_jpeg(os.path.join(root, name), seed + i)
        images.append({"id": 500 + i, "file_name": name})
        annotations.append({"image_id": 500 + i, "category_id": (3 * i) % 4})
    os.makedirs(os.path.join(root, "annotations"))
    for split in ("train", "val"):
        with open(os.path.join(root, "annotations", f"{split}2018.json"),
                  "w") as f:
            json.dump({"images": images, "annotations": annotations}, f)
    return root


def write_gender(root, n=6, seed=70):
    root = os.path.join(root, "coco_gender")
    ann = []
    for i in range(n):
        name = f"val2014/COCO_val2014_{i:012d}.jpg"
        save_jpeg(os.path.join(root, name), seed + i, 48, 64)
        ann.append({"image_id": 300 + i, "filename": name,
                    "gender": "man" if i % 2 else "woman",
                    "boxes": GENDER_BOXES[i % len(GENDER_BOXES)]})
    os.makedirs(os.path.join(root, "gender_annotations"))
    with open(os.path.join(root, "gender_annotations", "val.pkl"), "wb") as f:
        pickle.dump(ann, f)
    return root


def write_json_pretraining(root, n=5, seed=80):
    rng = np.random.default_rng(seed)
    entries = []
    for i in range(n):
        path = os.path.join(root, "json_images", f"{i}.jpg")
        save_jpeg(path, seed + i)
        caps = [caption(rng) for _ in range(1 + i % 3)]
        entries.append({"image": path, "caption": caps if i % 2 else caps[0]})
    path = os.path.join(root, "pretrain.json")
    with open(path, "w") as f:
        json.dump(entries, f)
    return path


WRITERS = {"coco": write_coco, "flickr30k": write_flickr,
           "VOC2007": write_voc, "imagenet": write_imagenet,
           "inaturalist": write_inaturalist, "coco_gender": write_gender}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("downstream"))
    out = {key: write(root) for key, write in WRITERS.items()}
    out["json"] = write_json_pretraining(root)
    return out


def assert_items_equal(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for i in range(len(theirs)):
        a, b = ours[i], theirs[i]
        assert a.keys() == b.keys()
        for k in b:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.shape == y.shape and x.dtype == y.dtype, (i, k)
            if k == "image":
                assert np.abs(x.astype(np.float64) - y).max() <= LEVEL, i
            else:
                np.testing.assert_array_equal(x, y, err_msg=f"{i} {k}")


def _configs(root):
    over = ["DATA.ROOT", root, "DATA.IMAGE_CROP_SIZE", CROP]
    return Config(None, over), JConfig(None, over)


SPLITS = {"coco": ("val",), "flickr30k": ("val",),
          "VOC2007": ("trainval", "test"), "imagenet": ("train", "val"),
          "inaturalist": ("train", "val"), "coco_gender": ("val",)}


@pytest.mark.parametrize("key,split", [(k, s) for k, splits in SPLITS.items()
                                       for s in splits])
def test_downstream_dataset_items_match_jax(trees, key, split):
    cfg, jcfg = _configs(trees[key])
    ours = DownstreamDatasetFactory.from_config(cfg, split=split)
    theirs = JFactory.from_config(jcfg, split=split)
    assert type(ours).__name__ == type(theirs).__name__
    for attr in ("text", "txt2img", "img2txt", "class_to_idx", "class_names"):
        assert getattr(ours, attr, None) == getattr(theirs, attr, None), attr
    assert_items_equal(ours, theirs)


@pytest.mark.parametrize("crop", [224, 336])
@pytest.mark.parametrize("key", ["coco", "flickr30k"])
def test_retrieval_items_at_clip_crop_sizes_match_jax(trees, key, crop):
    """The retrieval datasets at CLIP's input sizes (``DATA.IMAGE_CROP_SIZE``
    224 for ViT-B and ViT-L/14, 336 for ViT-L/14-336): (crop, crop, 3)
    images equal to the JAX package's, as ``retrieval --weight-init clip``
    feeds them to either package's towers."""
    over = ["DATA.ROOT", trees[key], "DATA.IMAGE_CROP_SIZE", crop]
    ours = DownstreamDatasetFactory.from_config(Config(None, over), split="val")
    theirs = JFactory.from_config(JConfig(None, over), split="val")
    assert np.asarray(ours[0]["image"]).shape == (crop, crop, 3)
    assert_items_equal(ours, theirs)


@pytest.mark.parametrize("mask_mode", ["none", "blackout", "blur"])
def test_gender_masks_match_jax(trees, mask_mode):
    kw = dict(data_root=trees["coco_gender"], split="val", mask_mode=mask_mode)
    assert_items_equal(datasets.CocoObjectGender(**kw),
                       jdatasets.CocoObjectGender(**kw))


def test_imagenet_percentage_and_default_transform(trees):
    for pct in (50.0, 100.0):
        ours = datasets.ImageNetDataset(trees["imagenet"], "train",
                                        percentage=pct)
        theirs = jdatasets.ImageNetDataset(trees["imagenet"], "train",
                                           percentage=pct)
        assert [os.path.basename(p) for p, _ in ours.samples] == \
            [os.path.basename(p) for p, _ in theirs.samples]
        assert len(ours) == (9 if pct == 50.0 else 18)
    assert_items_equal(datasets.ImageNetDataset(trees["imagenet"], "val"),
                       jdatasets.ImageNetDataset(trees["imagenet"], "val"))


@pytest.mark.parametrize("split", ["train", "val"])
def test_json_pretraining_dataset_matches_jax(trees, split):
    over = ["MODEL.NAME", "json", "DATA.IMAGE_CROP_SIZE", CROP,
            "DATA.MAX_CAPTION_LENGTH", 12, f"DATA.JSON_FILES_{split.upper()}",
            [trees["json"]]]
    from clip_lite_tpu.factories import PretrainingDatasetFactory as JPDF

    ours = PretrainingDatasetFactory.from_config(Config(None, over), split)
    theirs = JPDF.from_config(JConfig(None, over), split)
    assert [a["image"] for a in ours.ann] == [a["image"] for a in theirs.ann]
    assert len(ours) == (5 if split == "train" else 3)
    assert_items_equal(ours, theirs)
    np.testing.assert_array_equal(ours.caption_max_token_lengths(),
                                  theirs.caption_max_token_lengths())


BOXES = {"inside": [[10, 12, 50, 40]], "edge": [[0, 0, 80, 25]],
         "narrow": [[30, 5, 35, 55]], "past_the_edge": [[70, 50, 90, 70]],
         "fractional_two": [[3.7, 2.2, 9.9, 30.5], [40, 40, 44, 60]]}


@pytest.mark.parametrize("mask", ["BlackoutBox", "BlurBox"])
@pytest.mark.parametrize("boxes", sorted(BOXES))
def test_box_masks_match_opencv(mask, boxes):
    image = photo(5, 60, 80)
    sample = {"image": image, "boxes": BOXES[boxes]}
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    got = getattr(T, mask)()(dict(sample), rng)["image"]
    want = getattr(JT, mask)()(dict(sample), jrng)["image"]
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, image)
    np.testing.assert_array_equal(sample["image"], image)  # a copy
    assert rng.bit_generator.state == jrng.bit_generator.state


def test_factory_keys_and_errors(tmp_path):
    assert sorted(DownstreamDatasetFactory.products()) == \
        sorted(JFactory._products())
    assert {k: v.__name__ for k, v in DownstreamDatasetFactory.products().items()} \
        == {k: v.__name__ for k, v in JFactory._products().items()}
    cfg, _ = _configs(str(tmp_path / "cifar10"))
    with pytest.raises(KeyError, match="cifar10"):
        DownstreamDatasetFactory.from_config(cfg)
