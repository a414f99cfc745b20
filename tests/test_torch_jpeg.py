"""The port's image decode (clip_lite_torch/data/readers.py: PIL, EXIF
orientation applied) against the JAX package's (OpenCV's ``imdecode`` and
``imread``, then BGR -> RGB).

* Bit for bit: baseline JPEGs at 4:4:4, 4:2:2 and 4:2:0, a progressive
  one, a greyscale one, the JAX package's own ``encode_image`` (OpenCV,
  quality 95), every EXIF orientation 1-8 (as bytes and as files), and a
  PNG named ``.jpg`` (decoded by content).
* CMYK JPEGs: within one grey level (the two decoders' colour conversions
  differ).
* JPEG CLRec records written by the JAX package read, through the port's
  ``CocoCaptionsRecordReader``, as the JAX reader's arrays; COCO's own
  directory through ``CocoCaptionsDirReader`` likewise.
* A file that is missing or is no image raises ``FileNotFoundError`` in
  both packages.
"""

import io
import json
import os

import cv2
import numpy as np
import pytest
from PIL import Image

from clip_lite_tpu.data import readers as jreaders
from clip_lite_tpu.data.datasets import _imread_rgb
from clip_lite_torch.data import readers


def _photo(h=61, w=83, seed=0):
    """A smooth seeded RGB image with some texture: what a JPEG codec is
    built for, so that chroma subsampling and rounding matter."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(xx / 7.0 + c) * np.cos(yy / 5.0 - c)
                     for c in range(3)], axis=-1)
    noise = rng.normal(0, 0.15, (h, w, 3))
    return np.clip((base + noise + 1) * 127.5, 0, 255).astype(np.uint8)


def _pil_bytes(image: Image.Image, fmt="JPEG", **kw) -> bytes:
    buf = io.BytesIO()
    image.save(buf, fmt, **kw)
    return buf.getvalue()


def _cv2_decode(data: bytes) -> np.ndarray:
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


CASES = {
    "444": lambda: _pil_bytes(Image.fromarray(_photo()), quality=90,
                              subsampling=0),
    "422": lambda: _pil_bytes(Image.fromarray(_photo()), quality=90,
                              subsampling=1),
    "420": lambda: _pil_bytes(Image.fromarray(_photo()), quality=75,
                              subsampling=2),
    "progressive": lambda: _pil_bytes(Image.fromarray(_photo()), quality=85,
                                      progressive=True),
    "greyscale": lambda: _pil_bytes(Image.fromarray(_photo()[..., 1]),
                                    quality=90),
    "jax_encode_image": lambda: jreaders.encode_image(_photo(48, 64, 3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_jpeg_decode_is_bit_for_bit_opencv(case, tmp_path):
    data = CASES[case]()
    got, want = readers.decode_image(data), _cv2_decode(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(readers.decode_image(bytearray(data)), want)
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(readers.read_image(path), _imread_rgb(path))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_is_applied_as_opencv_does(orientation, tmp_path):
    exif = Image.Exif()
    exif[0x0112] = orientation
    data = _pil_bytes(Image.fromarray(_photo(37, 53)), quality=92,
                      subsampling=0, exif=exif)
    got, want = readers.decode_image(data), _cv2_decode(data)
    assert got.shape == want.shape == ((37, 53, 3) if orientation < 5
                                       else (53, 37, 3))
    np.testing.assert_array_equal(got, want)
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(readers.read_image(path), _imread_rgb(path))


def test_png_named_jpg_decodes_by_content(tmp_path):
    path = str(tmp_path / "n01440764_10040.JPEG")
    Image.fromarray(_photo(29, 31)).save(path, "PNG")
    got = readers.read_image(path)
    np.testing.assert_array_equal(got, _imread_rgb(path))
    np.testing.assert_array_equal(got, _photo(29, 31))  # lossless


def test_cmyk_jpeg_within_one_grey_level(tmp_path):
    data = _pil_bytes(Image.fromarray(_photo()).convert("CMYK"), quality=90)
    got, want = readers.decode_image(data), _cv2_decode(data)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_unreadable_file_raises_file_not_found(tmp_path):
    missing = str(tmp_path / "missing.jpg")
    junk = str(tmp_path / "junk.jpg")
    with open(junk, "wb") as f:
        f.write(b"not an image at all")
    for path in (missing, junk):
        with pytest.raises(FileNotFoundError):
            _imread_rgb(path)
        with pytest.raises(FileNotFoundError):
            readers.read_image(path)


def test_jpeg_clrec_records_read_as_the_jax_reader_does(tmp_path):
    path = str(tmp_path / "coco_train_train_sbert2017.clrec")
    with jreaders.ClRecWriter(path) as w:
        for i in range(4):
            image = jreaders.encode_image(_photo(40 + 8 * i, 56, seed=i))
            rec = {"image_id": 7 + i, "image": image,
                   "captions": [f"caption {i}", "another"]}
            w.append(rec if i % 2 else (rec["image_id"], rec["image"],
                                        rec["captions"]))
    ours, theirs = (readers.CocoCaptionsRecordReader(path),
                    jreaders.CocoCaptionsRecordReader(path))
    assert len(ours) == len(theirs) == 4
    for i in range(4):
        a, b = ours[i], theirs[i]
        assert a["image_id"] == b["image_id"] and a["captions"] == b["captions"]
        assert a["image"].shape == (40 + 8 * i, 56, 3)
        np.testing.assert_array_equal(a["image"], b["image"])


def test_coco_captions_dir_reader_matches_jax(tmp_path):
    os.makedirs(tmp_path / "images" / "val2017")
    os.makedirs(tmp_path / "annotations")
    images, annotations = [], []
    for i in range(3):
        name = f"{i:012d}.jpg"
        Image.fromarray(_photo(30, 40, seed=i)).save(
            tmp_path / "images" / "val2017" / name, quality=90)
        images.append({"id": i, "file_name": name})
        annotations += [{"image_id": i, "caption": f"picture {i} take {j}"}
                        for j in range(i)]  # image 0 has no caption
    with open(tmp_path / "annotations" / "captions_val2017.json", "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    ours = readers.CocoCaptionsDirReader(str(tmp_path), "val")
    theirs = jreaders.CocoCaptionsDirReader(str(tmp_path), "val")
    assert len(ours) == len(theirs) == 2
    for i in range(2):
        a, b = ours[i], theirs[i]
        assert a["image_id"] == b["image_id"] and a["captions"] == b["captions"]
        np.testing.assert_array_equal(a["image"], b["image"])
