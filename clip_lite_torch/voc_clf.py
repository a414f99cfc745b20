"""VOC07 SVM classification eval, the counterpart of the JAX package's
``voc_clf.py``: extract L2-normalised pooled features of the trainval and
test splits with the image tower, train a linear SVM per class for each
cost (default 0.01, 0.1, 1, 10) with 3-fold cross-validated AP, keep each
class's best cost, and report the test mAP.  Sweeps a glob of checkpoints
(the climax snapshots) and appends to ``voc07_mAP.txt``.

The SVM is the port's own (:mod:`clip_lite_torch.utils.svm`, the problem
sklearn's ``LinearSVC(C, class_weight={1: 2, 0: 1})`` solves, with its
``KFold`` splits and ``average_precision_score``), in float64 on the
run's device.

Run:
    python -m clip_lite_torch.voc_clf --config <downstream.yaml> \
        --pretrain-config <pretrain.yaml> --checkpoint-path ckpt.msgpack \
        [--device cpu]
where DATA.ROOT ends in ``VOC2007``.  The last line printed is
``{<checkpoint>: <mAP>}`` as JSON.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np
import torch

from clip_lite_torch.config import Config
from clip_lite_torch.data.pipeline import DataLoader
from clip_lite_torch.eval_utils import EncoderBundle, resolve_device
from clip_lite_torch.factories import DownstreamDatasetFactory
from clip_lite_torch.utils.common import (
    check_one_card,
    common_parser,
    common_setup,
)
from clip_lite_torch.utils.svm import LinearSVC, average_precision, kfold

parser = common_parser(description="VOC07 SVM classification eval.")
parser.add_argument("--pretrain-config", required=True)
parser.add_argument("--pretrain-config-override", nargs="*", default=[])
parser.add_argument("--checkpoint-path", default=None,
                    help="Single checkpoint to evaluate.")
parser.add_argument("--checkpoints-glob", default=None,
                    help="Glob of checkpoints to sweep (climax snapshots).")
parser.add_argument("--batch-size", type=int, default=128)
parser.add_argument("--costs", type=float, nargs="*",
                    default=[0.01, 0.1, 1.0, 10.0])
parser.add_argument("--num-folds", type=int, default=3)
parser.add_argument("--project", action="store_true",
                    help="Use the critic's projection head on top of the "
                         "pooled features.")

CLASS_WEIGHT = {1: 2, 0: 1}


def extract_features(bundle: EncoderBundle, dataset, batch_size: int,
                     workers: int):
    """(features (N, D), labels (N, classes)) of a dataset, in order."""
    loader = DataLoader(dataset, batch_size, shuffle=False, drop_last=False,
                        num_workers=workers, background=False)
    feats, labels = [], []
    for batch in loader:
        feats.append(bundle.encode_images(np.asarray(batch["image"])))
        labels.append(np.asarray(batch["label"]))
    return np.concatenate(feats), np.concatenate(labels)


def svm_map(train_feats, train_labels, test_feats, test_labels,
            costs, num_folds, logger, device) -> float:
    """Per class: the cost of the best mean k-fold CV AP over the
    trainval samples not marked -1, then the test AP of an SVM with that
    cost on all of them; returns the mean test AP in percent.  The SVMs
    are fitted on ``device``, which the caller names: CUDA, or the CPU
    when asked for."""
    device = resolve_device(device)
    x_train = torch.as_tensor(train_feats, dtype=torch.float64, device=device)
    x_test = torch.as_tensor(test_feats, dtype=torch.float64, device=device)

    def rows(x, index):
        return x[torch.as_tensor(index, device=device)]

    test_aps = []
    for cls in range(train_labels.shape[1]):
        y_tr = train_labels[:, cls]
        keep_tr = np.flatnonzero(y_tr != -1)  # -1 = ignore (difficult)
        x_tr, ytr = rows(x_train, keep_tr), y_tr[keep_tr]

        best_cost, best_cv = None, -1.0
        for cost in costs:
            cv_aps = []
            for tr_idx, va_idx in kfold(len(ytr), num_folds, seed=0):
                if len(set(ytr[tr_idx])) < 2:
                    continue
                clf = LinearSVC(cost, CLASS_WEIGHT).fit(rows(x_tr, tr_idx),
                                                        ytr[tr_idx])
                if len(set(ytr[va_idx])) == 2:
                    scores = clf.decision_function(rows(x_tr, va_idx))
                    cv_aps.append(average_precision(ytr[va_idx],
                                                    scores.cpu().numpy()))
            mean_ap = float(np.mean(cv_aps)) if cv_aps else 0.0
            if mean_ap > best_cv:
                best_cv, best_cost = mean_ap, cost

        clf = LinearSVC(best_cost, CLASS_WEIGHT).fit(x_tr, ytr)
        y_te = test_labels[:, cls]
        keep_te = np.flatnonzero(y_te != -1)
        scores = clf.decision_function(rows(x_test, keep_te)).cpu().numpy()
        ap = average_precision(y_te[keep_te], scores)
        test_aps.append(ap)
        logger.info("class %d: cost %s, CV AP %.4f, test AP %.4f "
                    "(|gradient| %.3g after %d Newton steps)", cls,
                    best_cost, best_cv, ap, clf.grad_norm_, clf.n_iter_)
    return 100.0 * float(np.mean(test_aps))


def main(_A) -> dict:
    check_one_card(_A)
    device = resolve_device(_A.device)
    _C_down = Config(_A.config, list(_A.config_override))
    _C = Config(_A.pretrain_config, list(_A.pretrain_config_override))
    logger = common_setup(_C_down, _A, job_type="voc_clf")

    train_ds = DownstreamDatasetFactory.from_config(_C_down, split="trainval")
    test_ds = DownstreamDatasetFactory.from_config(_C_down, split="test")

    checkpoints = []
    if _A.checkpoint_path:
        checkpoints.append(_A.checkpoint_path)
    if _A.checkpoints_glob:
        checkpoints += sorted(glob.glob(_A.checkpoints_glob))
    if not checkpoints:
        raise SystemExit("Provide --checkpoint-path or --checkpoints-glob")

    results = {}
    out_path = os.path.join(_A.serialization_dir, "voc07_mAP.txt")
    for ckpt in checkpoints:
        logger.info("Evaluating %s", ckpt)
        bundle = EncoderBundle(_C, ckpt, batch_size=_A.batch_size,
                               project=_A.project, normalize=True,
                               device=device)
        tr_f, tr_l = extract_features(bundle, train_ds, _A.batch_size,
                                      _A.cpu_workers)
        te_f, te_l = extract_features(bundle, test_ds, _A.batch_size,
                                      _A.cpu_workers)
        m = svm_map(tr_f, tr_l, te_f, te_l, _A.costs, _A.num_folds, logger,
                    device)
        results[ckpt] = m
        logger.info("%s: VOC07 mAP %.2f", ckpt, m)
        with open(out_path, "a") as f:
            f.write(f"{ckpt}\t{m:.4f}\n")

    print(json.dumps(results))
    return results


__all__ = ["extract_features", "main", "parser", "svm_map"]


if __name__ == "__main__":
    main(parser.parse_args())
