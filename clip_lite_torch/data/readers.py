"""CLRec record files and the dataset-facing readers over them, the
counterpart of the JAX package's ``data/readers.py``: the same files, byte
for byte, so that either package reads what the other writes.

    name.clrec       [magic "CLREC001"][u64 count][records: u64 len + bytes]
    name.clrec.idx   [u64 x (count+1)] record byte offsets (last = EOF)

Readers mmap the file: O(1) random access, safe to share across loader
threads, reopened after pickling.  A record is a pickled dict
``{"image_id", "image", "captions", ...}`` or the
``(image_id, image, captions)`` tuple.

A record's image is an HWC uint8 ndarray or the bytes of an encoded
image (JPEG, what the JAX package's ``make_synth_data.py`` writes), which
:func:`decode_image` decodes with PIL as the JAX package's
``cv2.imdecode`` does: by content, not by name, EXIF orientation applied,
greyscale and palette images expanded to RGB.  The two decoders give the
same pixels for baseline and progressive JPEGs at every chroma
subsampling and for greyscale ones; CMYK JPEGs may differ by one grey
level (``tests/test_torch_jpeg.py``).  Records hold pickles, so read only
files this program wrote.
"""

from __future__ import annotations

import io
import json
import logging
import mmap
import os
import pickle
import struct
from typing import Any, Dict, List

import numpy as np

MAGIC = b"CLREC001"


class ClRecWriter:
    """Append-only CLRec writer; ``close()`` (or the context manager)
    writes the count and the index."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._f.write(struct.pack("<Q", 0))  # the count, written on close
        self._offsets: List[int] = [self._f.tell()]
        self._count = 0

    def append(self, record: Any) -> None:
        payload = pickle.dumps(record, protocol=4)
        self._f.write(struct.pack("<Q", len(payload)))
        self._f.write(payload)
        self._offsets.append(self._f.tell())
        self._count += 1

    def close(self) -> None:
        self._f.seek(len(MAGIC))
        self._f.write(struct.pack("<Q", self._count))
        self._f.close()
        with open(self.path + ".idx", "wb") as f:
            f.write(np.asarray(self._offsets, dtype=np.uint64).tobytes())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ClRecReader:
    """mmap-backed random-access reader; without a ``.idx`` file the
    offsets come from a scan of the records."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        if self._mm[: len(MAGIC)] != MAGIC:
            self.close()
            raise ValueError(f"{path}: not a CLRec file")
        (self._count,) = struct.unpack_from("<Q", self._mm, len(MAGIC))
        idx_path = path + ".idx"
        if os.path.exists(idx_path):
            self._offsets = np.fromfile(idx_path, dtype=np.uint64)
        else:
            offsets = [len(MAGIC) + 8]
            pos = offsets[0]
            for _ in range(self._count):
                (ln,) = struct.unpack_from("<Q", self._mm, pos)
                pos += 8 + ln
                offsets.append(pos)
            self._offsets = np.asarray(offsets, dtype=np.uint64)

    def __len__(self) -> int:
        return self._count

    def __getitem__(self, i: int) -> Any:
        off = int(self._offsets[i])
        (ln,) = struct.unpack_from("<Q", self._mm, off)
        return pickle.loads(self._mm[off + 8: off + 8 + ln])

    def close(self) -> None:
        self._mm.close()
        self._file.close()

    # An mmap does not pickle; a copy reopens the file.
    def __getstate__(self):
        return {"path": self.path}

    def __setstate__(self, state):
        self.__init__(state["path"])


def _to_rgb(image) -> np.ndarray:
    """An opened PIL image as HWC uint8 RGB: the EXIF orientation applied
    (as OpenCV's ``imread``/``imdecode`` apply it), then converted.  No
    ``draft``: its reduced-size JPEG decode changes the pixels."""
    from PIL import ImageOps

    with image:
        return np.asarray(ImageOps.exif_transpose(image).convert("RGB"),
                          dtype=np.uint8)


def decode_image(data) -> np.ndarray:
    """Encoded image bytes (JPEG, PNG, ...) or an HWC uint8 ndarray ->
    RGB HWC uint8; an ndarray passes as it is."""
    if isinstance(data, np.ndarray) and data.ndim == 3 \
            and data.dtype == np.uint8:
        return data
    if isinstance(data, (bytes, bytearray, memoryview)):
        from PIL import Image

        return _to_rgb(Image.open(io.BytesIO(bytes(data))))
    raise TypeError(f"a record image must be encoded bytes or an HWC uint8 "
                    f"ndarray, got {type(data).__name__} "
                    f"{getattr(data, 'shape', '')}")


def encode_image(image_rgb: np.ndarray, quality: int = 95) -> bytes:
    """RGB HWC uint8 -> the bytes of a JPEG at ``quality``, encoded by PIL
    with its defaults (4:2:0, baseline), as the JAX package's
    ``encode_image`` encodes with OpenCV's; the two decode to the same
    pixels (``tests/test_torch_coco_preprocess.py``)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(image_rgb, np.uint8)).save(
        buf, "JPEG", quality=int(quality))
    return buf.getvalue()


def read_image(path: str) -> np.ndarray:
    """The image file at ``path`` as RGB HWC uint8, decoded by content
    whatever its extension; a file that is missing or cannot be decoded
    raises ``FileNotFoundError``, as the JAX package's ``_imread_rgb``
    does where ``cv2.imread`` returns None."""
    from PIL import Image

    try:  # PIL's UnidentifiedImageError is an OSError
        return _to_rgb(Image.open(path))
    except (OSError, ValueError) as e:
        raise FileNotFoundError(path) from e


def _as_dict(rec) -> Dict[str, Any]:
    if isinstance(rec, tuple):  # the (image_id, image, captions) form
        return {"image_id": rec[0], "image": rec[1], "captions": rec[2]}
    return rec


class CocoCaptionsRecordReader:
    """Dataset-facing reader: a CLRec of {image_id, image, captions}, the
    first ``percentage`` % of its records."""

    def __init__(self, path: str, percentage: float = 100.0):
        self.reader = ClRecReader(path)
        n = len(self.reader)
        keep = n if percentage >= 100.0 else max(1, int(n * percentage / 100.0))
        self._indices = np.arange(n)[:keep]
        if percentage < 100.0:
            logging.getLogger("clip_lite_torch").info(
                "Keeping %d/%d records (%.1f%%)", keep, n, percentage)

    def __len__(self) -> int:
        return len(self._indices)

    def record(self, i: int) -> Dict[str, Any]:
        """Record ``i`` as stored: its image not decoded (JPEG bytes for
        the native batch path)."""
        return _as_dict(self.reader[int(self._indices[i])])

    def __getitem__(self, i: int) -> Dict[str, Any]:
        rec = self.record(i)
        rec["image"] = decode_image(rec["image"])
        return rec

    def captions(self, i: int):
        """Captions of record ``i`` without its image: the sequence-length
        bucketing scans lengths with this."""
        return self.record(i)["captions"]


class CocoCaptionsDirReader:
    """COCO's own directory: ``images/{split}2017/*.jpg`` and
    ``annotations/captions_{split}2017.json``; the images that have
    captions, in the annotation file's order."""

    def __init__(self, data_root: str, split: str):
        ann = os.path.join(data_root,
                           f"annotations/captions_{split}2017.json")
        with open(ann) as f:
            data = json.load(f)
        cap_by_img: Dict[int, List[str]] = {}
        for a in data["annotations"]:
            cap_by_img.setdefault(a["image_id"], []).append(a["caption"])
        self.items = [
            (img["id"],
             os.path.join(data_root, f"images/{split}2017", img["file_name"]),
             cap_by_img.get(img["id"], []))
            for img in data["images"] if img["id"] in cap_by_img
        ]

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        image_id, path, captions = self.items[i]
        return {"image_id": image_id, "image": read_image(path),
                "captions": captions}


__all__ = ["ClRecReader", "ClRecWriter", "CocoCaptionsDirReader",
           "CocoCaptionsRecordReader", "MAGIC", "decode_image", "encode_image",
           "read_image"]
