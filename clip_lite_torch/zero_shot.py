"""Zero-shot classification by prompt-engineered class captions, the
counterpart of the JAX package's ``zero_shot.py``: encode one caption per
class ("a picture of a <class>."), encode the images, predict by the
argmax of the cosine similarities.  Classes come from a
directory-per-class dataset root, a JSON prompts file, or
``--prompt-template``.

Run:
    python -m clip_lite_torch.zero_shot \
        --config <downstream.yaml> --pretrain-config <pretrain.yaml> \
        --checkpoint-path ckpt.msgpack [--prompts-file prompts.json] \
        [--device cpu]
The last line printed is ``{"zero_shot_top1": <percent>}``.
"""

from __future__ import annotations

import json

import numpy as np

from clip_lite_torch.config import Config
from clip_lite_torch.data.pipeline import DataLoader
from clip_lite_torch.eval_utils import EncoderBundle, resolve_device
from clip_lite_torch.factories import DownstreamDatasetFactory, TokenizerFactory
from clip_lite_torch.utils.common import (
    check_one_card,
    common_parser,
    common_setup,
)
from clip_lite_torch.utils.metrics import TopkAccuracy

parser = common_parser(description="Zero-shot prompt classification eval.")
parser.add_argument("--pretrain-config", required=True)
parser.add_argument("--pretrain-config-override", nargs="*", default=[])
parser.add_argument("--checkpoint-path", required=True)
parser.add_argument("--split", default="val")
parser.add_argument("--batch-size", type=int, default=128)
parser.add_argument("--prompt-template", default="a picture of a {}.")
parser.add_argument("--prompts-file", default=None,
                    help="JSON list of class captions (index = label).")


def main(_A) -> float:
    check_one_card(_A)
    device = resolve_device(_A.device)
    _C_down = Config(_A.config, list(_A.config_override))
    _C = Config(_A.pretrain_config, list(_A.pretrain_config_override))
    logger = common_setup(_C_down, _A, job_type="zero_shot")

    dataset = DownstreamDatasetFactory.from_config(_C_down, split=_A.split)
    if _A.prompts_file:
        with open(_A.prompts_file) as f:
            class_captions = json.load(f)
    else:
        class_names = [c.replace("_", " ") for c in
                       sorted(dataset.class_to_idx,
                              key=dataset.class_to_idx.get)]
        class_captions = [_A.prompt_template.format(n) for n in class_names]
    logger.info("%d class prompts, e.g. %r", len(class_captions),
                class_captions[0])

    tokenizer = TokenizerFactory.from_config(_C)
    bundle = EncoderBundle(_C, _A.checkpoint_path, batch_size=_A.batch_size,
                           device=device)
    prompt_features = bundle.encode_texts(class_captions, tokenizer)

    loader = DataLoader(dataset, _A.batch_size, shuffle=False,
                        drop_last=False, num_workers=_A.cpu_workers,
                        background=False)
    acc = TopkAccuracy(top_k=1)
    for batch in loader:
        feats = bundle.encode_images(np.asarray(batch["image"]))
        acc(feats @ prompt_features.T, np.asarray(batch["label"]))
    top1 = acc.get_metric()
    logger.info("Zero-shot top-1: %.2f%%", top1)
    print(json.dumps({"zero_shot_top1": top1}))
    return top1


__all__ = ["main", "parser"]


if __name__ == "__main__":
    main(parser.parse_args())
