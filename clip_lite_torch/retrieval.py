"""Image-text retrieval eval (COCO 5k / Flickr30k R@1/5/10), the
counterpart of the JAX package's ``retrieval.py``: encode every caption
and image with the towers and the loss's projection heads, build the
similarity matrix, and report recalls in both directions.

Run:
    python -m clip_lite_torch.retrieval \
        --config <downstream.yaml> --pretrain-config <pretrain.yaml> \
        --checkpoint-path <ckpt.msgpack> [--device cpu]
where the downstream config's DATA.ROOT is the COCO or Flickr30k
directory (``DownstreamDatasetFactory`` keys on its trailing name).  The
last line printed is the recalls as JSON.

``--weight-init clip`` (an OpenAI CLIP model from a local Hugging Face
directory, through transformers' Flax CLIP in the JAX package) raises: the
card's machine has no transformers (ROADMAP Queue 1, item 6(b)).
"""

from __future__ import annotations

import json
from typing import List, Tuple

import numpy as np

from clip_lite_torch.config import Config
from clip_lite_torch.data.pipeline import DataLoader
from clip_lite_torch.eval_utils import EncoderBundle, itm_eval, resolve_device
from clip_lite_torch.factories import DownstreamDatasetFactory, TokenizerFactory
from clip_lite_torch.utils.common import (
    check_one_card,
    common_parser,
    common_setup,
)

parser = common_parser(description="COCO/Flickr image-text retrieval eval.")
parser.add_argument("--pretrain-config", default=None,
                    help="Pretraining config YAML of the checkpoint "
                         "(required with --weight-init vlinfo).")
parser.add_argument("--pretrain-config-override", nargs="*", default=[])
parser.add_argument("--checkpoint-path", required=True,
                    help="A checkpoint of either package (msgpack).")
parser.add_argument("--weight-init", default="vlinfo",
                    choices=["vlinfo", "clip"],
                    help="vlinfo: score the checkpoint; clip: an OpenAI CLIP "
                         "model (not ported: ROADMAP Queue 1, item 6(b)).")
parser.add_argument("--split", default="val")
parser.add_argument("--batch-size", type=int, default=128)


def score_retrieval(bundle: EncoderBundle, images: np.ndarray,
                    texts: List[str], tokenizer, txt2img: dict,
                    img2txt: dict) -> Tuple[dict, np.ndarray, np.ndarray]:
    """Returns (recalls, image embeddings, text embeddings) of images
    given as one array.

    images: (N, H, W, 3) fp32; texts: captions; txt2img maps a caption
    index to its image index, img2txt an image index to its captions.
    """
    text_embeds = bundle.encode_texts(texts, tokenizer)
    image_embeds = bundle.encode_images(images)
    sims = image_embeds @ text_embeds.T
    return itm_eval(sims, sims.T, txt2img, img2txt), image_embeds, text_embeds


def main(_A) -> dict:
    check_one_card(_A)
    device = resolve_device(_A.device)
    if _A.weight_init == "clip":
        raise NotImplementedError(
            "--weight-init clip scores an OpenAI CLIP model through "
            "transformers, which the card's machine does not have (ROADMAP "
            "Queue 1, item 6(b))")
    if not _A.pretrain_config:
        parser.error("--pretrain-config is required for vlinfo")
    _C_down = Config(_A.config, list(_A.config_override))
    logger = common_setup(_C_down, _A, job_type="retrieval")

    dataset = DownstreamDatasetFactory.from_config(_C_down, split=_A.split)
    loader = DataLoader(dataset, _A.batch_size, shuffle=False,
                        drop_last=False, num_workers=_A.cpu_workers,
                        background=False)
    _C = Config(_A.pretrain_config, list(_A.pretrain_config_override))
    tokenizer = TokenizerFactory.from_config(_C)
    bundle = EncoderBundle(_C, _A.checkpoint_path, batch_size=_A.batch_size,
                           device=device)

    logger.info("Encoding %d captions...", len(dataset.text))
    text_embeds = bundle.encode_texts(dataset.text, tokenizer)
    logger.info("Encoding %d images...", len(dataset))
    image_embeds = bundle.encode_image_batches(iter(loader))

    sims = image_embeds @ text_embeds.T
    result = itm_eval(sims, sims.T, dataset.txt2img, dataset.img2txt)
    logger.info("Retrieval: %s", {k: round(v, 2) for k, v in result.items()})
    print(json.dumps(result))
    return result


__all__ = ["main", "parser", "score_retrieval"]


if __name__ == "__main__":
    main(parser.parse_args())
