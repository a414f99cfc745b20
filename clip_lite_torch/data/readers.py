"""CLRec record files and the dataset-facing readers over them, the
counterpart of the JAX package's ``data/readers.py``: the same files, byte
for byte, so that either package reads what the other writes.

    name.clrec       [magic "CLREC001"][u64 count][records: u64 len + bytes]
    name.clrec.idx   [u64 x (count+1)] record byte offsets (last = EOF)

Readers mmap the file: O(1) random access, safe to share across loader
threads, reopened after pickling.  A record is a pickled dict
``{"image_id", "image", "captions", ...}`` or the
``(image_id, image, captions)`` tuple.

The port decodes no JPEG yet (ROADMAP Queue 1, item 4: JPEG decode on the
card): a record's image must be an HWC uint8 ndarray, and JPEG bytes
raise.  Records hold pickles, so read only files this program wrote.
"""

from __future__ import annotations

import logging
import mmap
import os
import pickle
import struct
from typing import Any, Dict, List

import numpy as np

MAGIC = b"CLREC001"
JPEG_PENDING = ("JPEG decode is not ported yet (ROADMAP Queue 1, item 4: JPEG "
                "decode on the card); write the records with HWC uint8 "
                "ndarray images")


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


def decode_image(data) -> np.ndarray:
    """An HWC uint8 ndarray passes as it is; JPEG bytes raise."""
    if isinstance(data, np.ndarray) and data.ndim == 3 \
            and data.dtype == np.uint8:
        return data
    if isinstance(data, (bytes, bytearray, memoryview)):
        raise NotImplementedError(JPEG_PENDING)
    raise TypeError(f"a record image must be an HWC uint8 ndarray, got "
                    f"{type(data).__name__} {getattr(data, 'shape', '')}")


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

    def __getitem__(self, i: int) -> Dict[str, Any]:
        rec = _as_dict(self.reader[int(self._indices[i])])
        rec["image"] = decode_image(rec["image"])
        return rec

    def captions(self, i: int):
        """Captions of record ``i`` without its image: the sequence-length
        bucketing scans lengths with this."""
        return _as_dict(self.reader[int(self._indices[i])])["captions"]


class CocoCaptionsDirReader:
    """COCO's own directory of JPEG files: waits for JPEG decode."""

    def __init__(self, data_root: str, split: str):
        raise NotImplementedError(
            "CocoCaptionsDirReader reads JPEG files; " + JPEG_PENDING)


__all__ = ["ClRecReader", "ClRecWriter", "CocoCaptionsDirReader",
           "CocoCaptionsRecordReader", "JPEG_PENDING", "MAGIC", "decode_image"]
