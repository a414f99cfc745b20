"""Image-text retrieval scoring: encode every caption and image with the
towers and the loss's projection heads, build the similarity matrix and
report recalls in both directions.

The counterpart of the scoring in the JAX package's ``retrieval.py``.  Its
command line, with COCO/Flickr30k loading, waits for the dataset and
transform ports (ROADMAP Queue 1, Evaluation).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from clip_lite_torch.eval_utils import EncoderBundle, itm_eval


def score_retrieval(bundle: EncoderBundle, images: np.ndarray,
                    texts: List[str], tokenizer, txt2img: dict,
                    img2txt: dict) -> Tuple[dict, np.ndarray, np.ndarray]:
    """Returns (recalls, image embeddings, text embeddings).

    images: (N, H, W, 3) fp32; texts: captions; txt2img maps a caption
    index to its image index, img2txt an image index to its captions.
    """
    text_embeds = bundle.encode_texts(texts, tokenizer)
    image_embeds = bundle.encode_images(images)
    sims = image_embeds @ text_embeds.T
    return itm_eval(sims, sims.T, txt2img, img2txt), image_embeds, text_embeds
