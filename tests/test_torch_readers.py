"""The port's CLRec files and readers (clip_lite_torch/data/readers.py)
against the JAX package's (clip_lite_tpu/data/readers.py): the same
records give the same bytes, each package reads the other's file, the
index rescan, ``percentage``, the tuple form and pickling behave alike,
and JPEG bytes decode as the JAX package decodes them (in a record, and
as COCO's directory of files; tests/test_torch_jpeg.py holds the decode
itself against OpenCV)."""

import os
import pickle

import numpy as np
import pytest

from clip_lite_tpu.data import readers as jreaders
from clip_lite_torch.data import readers


def _records(n=7, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        shape = (6, 8, 3) if i % 2 else (8, 6, 3)
        image = rng.integers(0, 256, shape, dtype=np.uint8)
        captions = [f"caption {i} number {j}" for j in range(1 + i % 3)]
        if i % 3 == 2:  # the (image_id, image, captions) form
            out.append((100 + i, image, captions))
        else:
            out.append({"image_id": 100 + i, "image": image,
                        "captions": captions})
    return out


def _write(module, path, records):
    with module.ClRecWriter(str(path)) as w:
        for r in records:
            w.append(r)


def _same_record(a, b):
    a = a if isinstance(a, dict) else dict(zip(("image_id", "image",
                                                "captions"), a))
    b = b if isinstance(b, dict) else dict(zip(("image_id", "image",
                                                "captions"), b))
    assert a["image_id"] == b["image_id"] and a["captions"] == b["captions"]
    np.testing.assert_array_equal(a["image"], b["image"])


def test_files_are_byte_equal(tmp_path):
    records = _records()
    _write(jreaders, tmp_path / "j.clrec", records)
    _write(readers, tmp_path / "t.clrec", records)
    for suffix in ("", ".idx"):
        with open(tmp_path / f"j.clrec{suffix}", "rb") as f, \
                open(tmp_path / f"t.clrec{suffix}", "rb") as g:
            assert f.read() == g.read()


@pytest.mark.parametrize("writer,reader", [(jreaders, readers),
                                           (readers, jreaders)],
                         ids=["jax_file_port_reader", "port_file_jax_reader"])
def test_each_package_reads_the_others_file(tmp_path, writer, reader):
    records = _records()
    path = str(tmp_path / "x.clrec")
    _write(writer, path, records)
    r = reader.ClRecReader(path)
    assert len(r) == len(records)
    for i, rec in enumerate(records):
        _same_record(r[i], rec)
    coco = reader.CocoCaptionsRecordReader(path)
    for i, rec in enumerate(records):
        _same_record(coco[i], rec)
        assert coco.captions(i) == _records()[i][
            "captions" if isinstance(rec, dict) else 2]
    r.close()


def test_index_rescan_when_idx_is_missing(tmp_path):
    records = _records()
    path = str(tmp_path / "x.clrec")
    _write(readers, path, records)
    with_idx = readers.ClRecReader(path)
    offsets = with_idx._offsets.copy()
    os.remove(path + ".idx")
    scanned = readers.ClRecReader(path)
    np.testing.assert_array_equal(scanned._offsets, offsets)
    np.testing.assert_array_equal(
        scanned._offsets, jreaders.ClRecReader(path)._offsets)
    for i, rec in enumerate(records):
        _same_record(scanned[i], rec)


@pytest.mark.parametrize("percentage", [100.0, 50.0, 10.0, 1.0])
def test_percentage_keeps_the_jax_records(tmp_path, percentage):
    records = _records(n=11)
    path = str(tmp_path / "x.clrec")
    _write(readers, path, records)
    ours = readers.CocoCaptionsRecordReader(path, percentage)
    theirs = jreaders.CocoCaptionsRecordReader(path, percentage)
    keep = 11 if percentage >= 100 else max(1, int(11 * percentage / 100))
    assert len(ours) == len(theirs) == keep
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert set(a) == set(b) == {"image_id", "image", "captions"}
        _same_record(a, b)


def test_tuple_form_reads_as_a_dict(tmp_path):
    path = str(tmp_path / "x.clrec")
    _write(readers, path, _records())
    rec = readers.CocoCaptionsRecordReader(path)[2]
    assert isinstance(rec, dict) and rec["image_id"] == 102
    assert rec["captions"] == ["caption 2 number 0", "caption 2 number 1",
                               "caption 2 number 2"]


def test_reader_reopens_after_pickling(tmp_path):
    records = _records()
    path = str(tmp_path / "x.clrec")
    _write(readers, path, records)
    copy = pickle.loads(pickle.dumps(readers.ClRecReader(path)))
    for i, rec in enumerate(records):
        _same_record(copy[i], rec)


def test_not_a_clrec_file_raises(tmp_path):
    path = tmp_path / "x.clrec"
    path.write_bytes(b"NOTCLREC" + bytes(8))
    with pytest.raises(ValueError, match="not a CLRec file"):
        readers.ClRecReader(str(path))


@pytest.mark.parametrize("where", ["decode_image", "record_reader",
                                   "dir_reader"])
def test_jpeg_bytes_decode_as_jax(tmp_path, where):
    """JPEG bytes decode to the JAX package's arrays: given to
    ``decode_image``, in a record, and as a file of COCO's own
    directory."""
    image = np.random.default_rng(1).integers(0, 256, (8, 12, 3), np.uint8)
    jpeg = jreaders.encode_image(image)
    want = jreaders.decode_image(jpeg)
    if where == "decode_image":
        got = readers.decode_image(jpeg)
    elif where == "record_reader":
        path = str(tmp_path / "x.clrec")
        _write(jreaders, path, [{"image_id": 1, "image": jpeg,
                                 "captions": ["a"]}])
        reader = readers.CocoCaptionsRecordReader(path)
        assert reader.captions(0) == ["a"]  # captions need no decode
        got = reader[0]["image"]
    else:
        os.makedirs(tmp_path / "images" / "train2017")
        os.makedirs(tmp_path / "annotations")
        with open(tmp_path / "images" / "train2017" / "1.jpg", "wb") as f:
            f.write(jpeg)
        with open(tmp_path / "annotations" / "captions_train2017.json",
                  "w") as f:
            f.write('{"images": [{"id": 1, "file_name": "1.jpg"}], '
                    '"annotations": [{"image_id": 1, "caption": "a"}]}')
        item = readers.CocoCaptionsDirReader(str(tmp_path), "train")[0]
        assert item["captions"] == ["a"]
        got = item["image"]
    assert got.dtype == np.uint8 and got.shape == (8, 12, 3)
    np.testing.assert_array_equal(got, want)


def test_decode_image_passes_hwc_uint8_only():
    image = np.zeros((4, 5, 3), np.uint8)
    assert readers.decode_image(image) is image
    with pytest.raises(TypeError):
        readers.decode_image(np.zeros((4, 5), np.uint8))
