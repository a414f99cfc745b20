"""Generate a mock caption corpus for smoke runs with no data, the
counterpart of the JAX package's ``scripts/make_mock_data.py``: 42
conceptual-captions-style records (``mock_data.json``, ALBEF-style,
``[{"image": path, "caption": [str, str]}]``) and the JPEG images they
name, each a filled circle on a flat colour, drawn by ``scripts/drawing.py``
with OpenCV's rules (the JAX script draws with ``cv2.circle``) and
encoded by PIL at quality 95 (``cv2.imwrite``'s default there).  As
there, the image's array is written as OpenCV takes it, blue first, so
that the files decode to the JAX script's colours.

Usage:
    python -m clip_lite_torch.scripts.make_mock_data --output-dir /tmp/mock
    python -m clip_lite_torch.train --config-override MODEL.NAME json \\
        DATA.JSON_FILES_TRAIN "['/tmp/mock/mock_data.json']" ...
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from clip_lite_torch.data.readers import encode_image
from clip_lite_torch.scripts import drawing

parser = argparse.ArgumentParser(description=__doc__)
parser.add_argument("--output-dir", required=True)
parser.add_argument("--num-records", type=int, default=42)
parser.add_argument("--image-size", type=int, default=96)

_SUBJECTS = ["a dog", "a red truck", "two people", "a surfer", "a kitchen",
             "a plate of food", "a street sign", "a small boat"]
_SETTINGS = ["on the beach", "in the park", "at night", "near a building",
             "under a blue sky", "on a city street", "by the river"]


def main(args) -> str:
    img_dir = os.path.join(args.output_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(0)
    records = []
    for i in range(args.num_records):
        img = np.zeros((args.image_size, args.image_size, 3), np.uint8)
        img[:] = rng.randint(0, 256, 3)
        drawing.circle(img, (args.image_size // 2, args.image_size // 2),
                       args.image_size // 4,
                       tuple(int(c) for c in rng.randint(0, 256, 3)), -1)
        path = os.path.join(img_dir, f"{i:05d}.jpg")
        with open(path, "wb") as f:  # the array is BGR to OpenCV
            f.write(encode_image(img[..., ::-1]))
        captions = [
            f"{_SUBJECTS[i % len(_SUBJECTS)]} "
            f"{_SETTINGS[(i + j) % len(_SETTINGS)]}"
            for j in range(2)
        ]
        records.append({"image": path, "caption": captions})
    out = os.path.join(args.output_dir, "mock_data.json")
    with open(out, "w") as f:
        json.dump(records, f, indent=1)
    print(f"{len(records)} mock records -> {out}")
    return out


if __name__ == "__main__":
    main(parser.parse_args())
