"""Caption clustering for the hard-negative curriculum, the counterpart of
the JAX package's ``scripts/cluster.py``: one embedding per image (the
mean of its captions' embeddings), Lloyd k-means for each k from
``--min-clusters`` to ``--max-clusters`` on the device, and the pickles
that ``CocoCaptionsClusteredDataset`` reads, with the JAX script's names
and contents:

  img_id_caption_map_{split}.pkl      image id -> its captions
  img_id_filename_map_{split}.pkl     image id -> images/{split}2017/<file>
  img_id_cluster_map_{split}_{k}.pkl  image id -> cluster, for each k

The captions are embedded by a trained checkpoint's text tower (the
port's ``EncoderBundle``, unprojected and L2-normalized, one image's
captions a call, as the JAX script does), or read from
``--embeddings-file`` (an (N, D) ``.npy`` in the order of sorted image
ids).  Without either, the JAX script falls back to sentence-transformers,
whose model the port does not ship, so this one raises, as that one does
without the package.

k-means starts from k distinct embeddings drawn with torch's generator
from ``seed`` (the JAX script draws them with ``jax.random.choice``,
which the port cannot reproduce; :func:`kmeans` takes given indices for
the comparison) and then follows the JAX script's Lloyd step exactly:
the assignment as one (N, D) x (D, k) product, argmax of x.c - |c|^2/2,
centres the means of their members, an empty cluster's centre kept.

Usage (on the card; ``--device cpu`` on the CPU):
    python -m clip_lite_torch.scripts.cluster --coco-root /tmp/synth/coco \\
        --split train --output-dir /tmp/synth/clusters \\
        --pretrain-config <run>/pretrain_config.yaml \\
        --checkpoint-path <run>/<RUN_ID>/checkpoint_7500.msgpack
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time
from typing import Optional, Sequence

import numpy as np
import torch

parser = argparse.ArgumentParser(description=__doc__)
parser.add_argument("--coco-root", required=True,
                    help="Raw COCO root (annotations/ + images/).")
parser.add_argument("--split", default="train")
parser.add_argument("--output-dir", required=True)
parser.add_argument("--min-clusters", type=int, default=2)
parser.add_argument("--max-clusters", type=int, default=10)
parser.add_argument("--iters", type=int, default=50)
parser.add_argument("--pretrain-config", default=None,
                    help="Config of a trained checkpoint to embed captions.")
parser.add_argument("--checkpoint-path", default=None)
parser.add_argument("--embeddings-file", default=None,
                    help="Precomputed (N, D) .npy of caption embeddings "
                         "(ordered by image id) to skip encoding.")
parser.add_argument("--device", default="cuda",
                    help="Where the encoder and k-means run (cuda or cpu).")


def kmeans(x, k: int, iters: int, seed: int = 0,
           init: Optional[Sequence[int]] = None, device="cuda"):
    """Plain Lloyd k-means on ``device``; returns ``(assign, centers)`` as
    numpy.  The initial centres are the rows ``init`` of ``x``, or k
    distinct rows drawn from ``seed``."""
    from clip_lite_torch.eval_utils import resolve_device

    device = resolve_device(device)
    x = torch.as_tensor(np.asarray(x, np.float32), device=device)
    n = x.shape[0]
    if init is None:
        init = torch.randperm(
            n, generator=torch.Generator().manual_seed(seed))[:k]
    centers = x[torch.as_tensor(np.asarray(init), dtype=torch.long,
                                device=device)]
    assign = None
    for _ in range(iters):
        # argmin_j |x - c_j|^2 == argmax_j (x.c_j - |c_j|^2 / 2)
        logits = x @ centers.T - 0.5 * torch.sum(centers * centers, dim=1)
        assign = torch.argmax(logits, dim=1)
        sums = torch.zeros_like(centers).index_add_(0, assign, x)
        counts = torch.bincount(assign, minlength=k).to(x.dtype)
        new_centers = sums / torch.clamp(counts, min=1.0)[:, None]
        # Keep empty clusters where they were.
        centers = torch.where((counts > 0)[:, None], new_centers, centers)
    return assign.cpu().numpy(), centers.cpu().numpy()


def load_image_captions(coco_root: str, split: str):
    ann = os.path.join(coco_root, f"annotations/captions_{split}2017.json")
    with open(ann) as f:
        data = json.load(f)
    cap_by_img, file_by_img = {}, {}
    for a in data["annotations"]:
        cap_by_img.setdefault(a["image_id"], []).append(a["caption"])
    for img in data["images"]:
        file_by_img[img["id"]] = f"images/{split}2017/{img['file_name']}"
    img_ids = sorted(i for i in cap_by_img if i in file_by_img)
    return img_ids, cap_by_img, file_by_img


def embed_captions(args, img_ids, cap_by_img) -> np.ndarray:
    """One embedding per image: the mean of its captions' embeddings."""
    if args.embeddings_file:
        return np.load(args.embeddings_file)
    if args.pretrain_config:
        from clip_lite_torch.config import Config
        from clip_lite_torch.eval_utils import EncoderBundle
        from clip_lite_torch.factories import TokenizerFactory

        cfg = Config(args.pretrain_config)
        bundle = EncoderBundle(cfg, args.checkpoint_path, project=False,
                               normalize=True, device=args.device)
        tokenizer = TokenizerFactory.from_config(cfg)
        return np.stack([bundle.encode_texts(cap_by_img[i], tokenizer).mean(0)
                         for i in img_ids])
    raise SystemExit(
        "Provide --pretrain-config/--checkpoint-path or --embeddings-file "
        "(the sentence-transformers encoder is not available)")


def main(args) -> dict:
    """Writes the pickles; returns the seconds of the embedding and of
    the k-means, and the cluster sizes for each k."""
    img_ids, cap_by_img, file_by_img = load_image_captions(
        args.coco_root, args.split)
    t0 = time.perf_counter()
    embeddings = embed_captions(args, img_ids, cap_by_img)
    embed_s = time.perf_counter() - t0
    os.makedirs(args.output_dir, exist_ok=True)

    with open(os.path.join(
            args.output_dir, f"img_id_caption_map_{args.split}.pkl"),
            "wb") as f:
        pickle.dump({i: cap_by_img[i] for i in img_ids}, f)
    with open(os.path.join(
            args.output_dir, f"img_id_filename_map_{args.split}.pkl"),
            "wb") as f:
        pickle.dump({i: file_by_img[i] for i in img_ids}, f)

    t0 = time.perf_counter()
    sizes = {}
    for k in range(args.min_clusters, args.max_clusters + 1):
        assign, _ = kmeans(embeddings, k, args.iters, device=args.device)
        out = os.path.join(
            args.output_dir, f"img_id_cluster_map_{args.split}_{k}.pkl")
        with open(out, "wb") as f:
            pickle.dump({img_id: int(c) for img_id, c in
                         zip(img_ids, assign)}, f)
        sizes[k] = np.bincount(assign, minlength=k).tolist()
        print(f"k={k}: cluster sizes {sizes[k]}")
    kmeans_s = time.perf_counter() - t0
    summary = {"split": args.split, "images": len(img_ids),
               "embed_s": embed_s, "kmeans_s": kmeans_s, "sizes": sizes}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main(parser.parse_args())
