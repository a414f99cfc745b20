"""Build the glove text mode's ``word_dict.json`` from COCO captions.

The counterpart of the JAX package's ``scripts/generate_word_dict.py``:
counts the words (``simple_word_tokenize``) of
``{coco_root}/annotations/captions_{split}2017.json`` over ``--splits``,
keeps those seen at least ``--min-count`` times and, with
``--glove-path``, those the GloVe text file has, most frequent first, and
writes ``<pad> <start> <eos> <unk>`` as ids 0-3 before them.  The same
inputs give the JAX script's file byte for byte.

Run:
    python -m clip_lite_torch.scripts.generate_word_dict \\
        --coco-root datasets/coco --glove-path datasets/glove/glove.42B.300d.txt \\
        --output datasets/vocab/word_dict.json
"""

from __future__ import annotations

import argparse
import json
import os
from collections import Counter

from clip_lite_torch.data.tokenizers import simple_word_tokenize

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--coco-root", required=True)
parser.add_argument("--splits", nargs="*", default=["train", "val"])
parser.add_argument("--glove-path", default=None,
                    help="GloVe txt file; omit to keep every caption word.")
parser.add_argument("--min-count", type=int, default=1)
parser.add_argument("--output", required=True)


def main(args) -> dict:
    """Write the dictionary to ``args.output``; returns it."""
    counts: Counter = Counter()
    for split in args.splits:
        ann = os.path.join(args.coco_root,
                           f"annotations/captions_{split}2017.json")
        with open(ann) as f:
            data = json.load(f)
        for a in data["annotations"]:
            counts.update(simple_word_tokenize(a["caption"]))

    glove_vocab = None
    if args.glove_path:
        with open(args.glove_path) as f:
            glove_vocab = {line.split(" ", 1)[0] for line in f}

    words = [w for w, c in counts.most_common()
             if c >= args.min_count and
             (glove_vocab is None or w in glove_vocab)]
    word_dict = {"<pad>": 0, "<start>": 1, "<eos>": 2, "<unk>": 3}
    for w in words:
        word_dict[w] = len(word_dict)

    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "w") as f:
        json.dump(word_dict, f)
    print(f"word_dict: {len(word_dict)} entries -> {args.output}")
    return word_dict


if __name__ == "__main__":
    main(parser.parse_args())
