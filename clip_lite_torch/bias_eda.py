"""Gender-bias analysis over a gender-labelled COCO subset, the counterpart
of the JAX package's ``bias_eda.py``: encode the man and woman image
subsets with the projected image tower, estimate a gender direction from
definitional prompt pairs (:mod:`clip_lite_torch.utils.we`), and score
prompts against both populations, biased and debiased.  ``--prompt``
reports the mean-similarity gap (a bias score) for one prompt;
``--interactive`` asks for prompts until ``q``.  ``--cache-dir`` keeps the
encoded subsets as ``men_data_<split>.pkl`` and ``women_data_<split>.pkl``,
the JAX package's pickles ({image_id: features}), so either package reads
the other's.

Run:
    python -m clip_lite_torch.bias_eda \
        --config <downstream.yaml>  # DATA.ROOT ending in coco_gender
        --pretrain-config <pretrain.yaml> --checkpoint-path ckpt.msgpack \
        --prompt "a photo of a doctor" [--device cpu]
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

from clip_lite_torch.config import Config
from clip_lite_torch.data.pipeline import DataLoader
from clip_lite_torch.eval_utils import EncoderBundle, resolve_device
from clip_lite_torch.factories import DownstreamDatasetFactory, TokenizerFactory
from clip_lite_torch.utils import we
from clip_lite_torch.utils.common import (
    check_one_card,
    common_parser,
    common_setup,
)

parser = common_parser(description="Gender bias analysis (EDA).")
parser.add_argument("--pretrain-config", required=True)
parser.add_argument("--pretrain-config-override", nargs="*", default=[])
parser.add_argument("--checkpoint-path", required=True)
parser.add_argument("--split", default="val")
parser.add_argument("--batch-size", type=int, default=64)
parser.add_argument("--definitional-pairs", default=None,
                    help="JSON file of [fem, masc] prompt pairs.")
parser.add_argument("--prompt", default=None,
                    help="Score one prompt non-interactively.")
parser.add_argument("--interactive", action="store_true")
parser.add_argument("--top-k", type=int, default=10)
parser.add_argument("--cache-dir", default=None,
                    help="Cache encoded gender features here.")


def encode_gender_subsets(bundle, dataset, batch_size, workers, cache_dir,
                          split, logger):
    """{image_id: features} of the men and of the women, from the cache's
    pickles when both are there, else encoded (and cached)."""
    if cache_dir:
        men_p = os.path.join(cache_dir, f"men_data_{split}.pkl")
        women_p = os.path.join(cache_dir, f"women_data_{split}.pkl")
        if os.path.exists(men_p) and os.path.exists(women_p):
            with open(men_p, "rb") as f:
                men = pickle.load(f)
            with open(women_p, "rb") as f:
                women = pickle.load(f)
            logger.info("Loaded cached gender features (%d men, %d women)",
                        len(men), len(women))
            return men, women

    loader = DataLoader(dataset, batch_size, shuffle=False, drop_last=False,
                        num_workers=workers, background=False)
    men, women = {}, {}
    for batch in loader:
        feats = bundle.encode_images(np.asarray(batch["image"]))
        for i in range(feats.shape[0]):
            target = men if int(batch["gender"][i]) == 0 else women
            target[int(batch["image_id"][i])] = feats[i]
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        with open(men_p, "wb") as f:
            pickle.dump(men, f)
        with open(women_p, "wb") as f:
            pickle.dump(women, f)
    return men, women


def _unit(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def score_prompt(prompt_feat, subset_feats, direction):
    """Mean cosine similarity of a prompt to a subset, biased and
    debiased, and the per-image similarities of each."""
    feats = np.stack(list(subset_feats.values()))
    sims = _unit(feats) @ _unit(prompt_feat.reshape(1, -1)).T
    deb_feats = we.debias(feats, direction)
    deb_prompt = we.debias(prompt_feat.reshape(1, -1), direction)
    deb_sims = _unit(deb_feats) @ _unit(deb_prompt).T
    return (float(sims.mean()), float(deb_sims.mean()), sims[:, 0],
            deb_sims[:, 0])


def report(prompt, prompt_feat, men, women, direction, top_k, logger):
    m_b, m_d, m_sims, _ = score_prompt(prompt_feat, men, direction)
    w_b, w_d, w_sims, _ = score_prompt(prompt_feat, women, direction)
    result = {
        "prompt": prompt,
        "men_mean_sim": m_b, "women_mean_sim": w_b,
        "bias_gap": m_b - w_b,
        "men_mean_sim_debiased": m_d, "women_mean_sim_debiased": w_d,
        "bias_gap_debiased": m_d - w_d,
    }
    logger.info("bias: %s", {k: round(v, 4) if isinstance(v, float) else v
                             for k, v in result.items()})
    men_ids, women_ids = list(men), list(women)
    result["top_men"] = [men_ids[i] for i in np.argsort(m_sims)[::-1][:top_k]]
    result["top_women"] = [women_ids[i] for i in
                           np.argsort(w_sims)[::-1][:top_k]]
    return result


def main(_A):
    check_one_card(_A)
    device = resolve_device(_A.device)
    _C_down = Config(_A.config, list(_A.config_override))
    _C = Config(_A.pretrain_config, list(_A.pretrain_config_override))
    logger = common_setup(_C_down, _A, job_type="bias_eda")

    dataset = DownstreamDatasetFactory.from_config(_C_down, split=_A.split)
    tokenizer = TokenizerFactory.from_config(_C)
    bundle = EncoderBundle(_C, _A.checkpoint_path, batch_size=_A.batch_size,
                           device=device)

    if _A.definitional_pairs:
        with open(_A.definitional_pairs) as f:
            pairs = json.load(f)
    else:
        pairs = we.DEFAULT_DEFINITIONAL_PAIRS

    def encode_fn(prompts):
        return bundle.encode_texts(prompts, tokenizer)

    direction = we.gender_direction(pairs, encode_fn)
    logger.info("Gender direction estimated from %d pairs", len(pairs))

    men, women = encode_gender_subsets(
        bundle, dataset, _A.batch_size, _A.cpu_workers, _A.cache_dir,
        _A.split, logger)

    if _A.prompt:
        result = report(_A.prompt, encode_fn([_A.prompt])[0], men, women,
                        direction, _A.top_k, logger)
        print(json.dumps({k: v for k, v in result.items()
                          if not k.startswith("top_")}))
        return result

    if _A.interactive:
        while True:
            prompt = input("Enter query text [type q to quit]: ")
            if prompt == "q":
                break
            report(prompt, encode_fn([prompt])[0], men, women, direction,
                   _A.top_k, logger)


__all__ = ["encode_gender_subsets", "main", "parser", "report",
           "score_prompt"]


if __name__ == "__main__":
    main(parser.parse_args())
