"""The port's linear SVM, k-fold splits and average precision
(clip_lite_torch/utils/svm.py) against sklearn's ``LinearSVC``, ``KFold``
and ``average_precision_score``, which the JAX package's VOC07 eval uses,
on seeded data:

* the objective at the port's solution is at most sklearn's at its own
  (the port solves to the optimum; sklearn stops at its ``tol=1e-4``),
  and the gradient there is nought to rounding;
* decision values within 1e-3 of the largest, relative;
* the k-fold indices identical;
* AP equal to 1e-12, tied scores included.
"""

import warnings

import numpy as np
import pytest
import torch
from sklearn.exceptions import ConvergenceWarning
from sklearn.metrics import average_precision_score
from sklearn.model_selection import KFold
from sklearn.svm import LinearSVC as SkLinearSVC

from clip_lite_torch.utils.svm import LinearSVC, average_precision, kfold

WEIGHT = {1: 2, 0: 1}


def _data(n, d, seed, separable=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)  # the eval's unit features
    noise = 0.0 if separable else 0.3
    y = (x[:, 0] + noise * rng.standard_normal(n) > 0.3).astype(np.int64)
    return x, y


def _objective(x, y, cost, w, b):
    c = cost * np.where(y == 1, WEIGHT[1], WEIGHT[0])
    s = np.where(y == 1, 1.0, -1.0)
    slack = np.maximum(0.0, 1.0 - s * (x @ w + b))
    return 0.5 * (w @ w + b * b) + np.sum(c * slack ** 2)


@pytest.mark.parametrize("n,d", [(60, 16), (200, 32), (40, 100)],
                         ids=["n>d", "n>>d", "n<d"])
# At cost 1000 and n < d a full Newton step overshoots: the line search
# halves it.
@pytest.mark.parametrize("cost", [0.01, 0.1, 1.0, 10.0, 1000.0])
def test_svm_is_as_optimal_as_sklearn(n, d, cost):
    x, y = _data(n, d, seed=n + d)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ConvergenceWarning)
        sk = SkLinearSVC(C=cost, class_weight=WEIGHT, max_iter=2000,
                         dual="auto").fit(x, y)
    ours = LinearSVC(cost, WEIGHT).fit(torch.from_numpy(x), y)
    w, b = ours.coef_.numpy(), float(ours.intercept_)
    mine = _objective(x, y, cost, w, b)
    theirs = _objective(x, y, cost, sk.coef_[0], float(sk.intercept_[0]))
    assert mine <= theirs * (1 + 1e-12)
    assert ours.converged_
    assert ours.grad_norm_ <= 1e-10 * max(1.0, np.sqrt(n) * cost)
    got = ours.decision_function(torch.from_numpy(x)).numpy()
    want = sk.decision_function(x)
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


def test_svm_one_sided_and_float32_features():
    x, _ = _data(30, 8, seed=3)
    ours = LinearSVC(1.0, WEIGHT).fit(torch.from_numpy(x).float(),
                                      np.zeros(30, np.int64))
    assert ours.coef_.dtype == torch.float64
    scores = ours.decision_function(torch.from_numpy(x)).numpy()
    assert (scores < 0).all() and ours.grad_norm_ < 1e-10


@pytest.mark.parametrize("n", [5, 10, 11, 12, 100, 257])
@pytest.mark.parametrize("n_splits", [2, 3, 5])
def test_kfold_indices_match_sklearn(n, n_splits):
    want = list(KFold(n_splits, shuffle=True, random_state=0).split(
        np.zeros(n)))
    got = list(kfold(n, n_splits, seed=0))
    assert len(got) == len(want) == n_splits
    for (a_tr, a_te), (b_tr, b_te) in zip(got, want):
        np.testing.assert_array_equal(a_tr, b_tr)
        np.testing.assert_array_equal(a_te, b_te)


@pytest.mark.parametrize("seed", range(6))
def test_average_precision_matches_sklearn(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 200))
    labels = rng.integers(0, 2, n)
    labels[:2] = (0, 1)
    # Half the seeds round the scores to one decimal: many ties.
    scores = rng.standard_normal(n)
    if seed % 2:
        scores = np.round(scores, 1)
    got = average_precision(labels, scores)
    assert abs(got - average_precision_score(labels, scores)) <= 1e-12
