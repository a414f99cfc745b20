"""Export COCO captions to the ALBEF-style json that ``JsonDataset``
reads, the counterpart of the JAX package's ``scripts/coco_to_json.py``:
one record per image that has captions, ``{"image": path,
"caption": [c1, ...]}``, in the annotation file's order of images.

Usage:
    python -m clip_lite_torch.scripts.coco_to_json --coco-root datasets/coco \\
        --split train --output coco_train.json
"""

from __future__ import annotations

import argparse
import json
import os

parser = argparse.ArgumentParser(description=__doc__)
parser.add_argument("--coco-root", required=True)
parser.add_argument("--split", default="train")
parser.add_argument("--output", required=True)


def main(args) -> None:
    ann = os.path.join(args.coco_root,
                       f"annotations/captions_{args.split}2017.json")
    with open(ann) as f:
        data = json.load(f)
    caps = {}
    for a in data["annotations"]:
        caps.setdefault(a["image_id"], []).append(a["caption"])
    records = [
        {"image": os.path.join(args.coco_root, f"images/{args.split}2017",
                               img["file_name"]),
         "caption": caps[img["id"]]}
        for img in data["images"] if img["id"] in caps
    ]
    with open(args.output, "w") as f:
        json.dump(records, f)
    print(f"{len(records)} records -> {args.output}")


if __name__ == "__main__":
    main(parser.parse_args())
