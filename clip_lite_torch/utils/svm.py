"""A linear SVM, k-fold splits and average precision for the VOC07 eval,
without sklearn: the port's own counterparts of what the JAX package's
``voc_clf.py`` takes from it (``LinearSVC``, ``KFold``,
``average_precision_score``).

:class:`LinearSVC` solves the problem that liblinear's L2-regularised
squared-hinge primal solves for ``sklearn.svm.LinearSVC(C, class_weight)``
with an intercept of scaling 1 (the bias is a feature of constant 1, so
it is regularised too)::

    min_{w, b}  1/2 (|w|^2 + b^2)
                + sum_i C_i max(0, 1 - y_i (w . x_i + b))^2

with y_i in {-1, +1} and C_i = C * class_weight[label_i].  The objective
is strictly convex and piecewise quadratic.  The solver takes Newton steps
on its generalized Hessian I + 2 X_A^T diag(C_A) X_A over the active set A
(the margins below 1), as liblinear's primal solver does, with an Armijo
backtracking line search, in float64 on the features' device; it stops
when the gradient's norm falls to ``TOL`` times its norm at w = 0.  Once
the active set settles a full step lands on the optimum, so the solution
is the exact minimiser up to rounding, which sklearn approximates at its
``tol=1e-4``.  Each Newton system is solved by Cholesky in its (D + 1)
unknowns (2,049 for the flagship's pooled features).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

TOL = 1e-10     # the gradient's norm at the solution, over its norm at w = 0
MAX_ITER = 100  # Newton steps; a few reach the optimum


class LinearSVC:
    """``fit(x, labels)`` on {0, 1} labels; then ``coef_`` (D,) and
    ``intercept_`` (0-d), float64 tensors on ``x``'s device, and
    ``decision_function(x)``; ``n_iter_`` (Newton steps), ``grad_norm_``
    (the gradient's norm at the solution) and ``converged_`` (whether that
    norm reached ``TOL`` times its start within ``MAX_ITER`` steps)."""

    def __init__(self, C: float, class_weight: Dict[int, float]):
        self.C = C
        self.class_weight = class_weight

    @staticmethod
    def _augment(x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float64)
        return torch.cat([x, x.new_ones(x.shape[0], 1)], dim=1)

    def fit(self, x: torch.Tensor, labels) -> "LinearSVC":
        xt = self._augment(x)
        labels = torch.as_tensor(np.asarray(labels), device=xt.device)
        y = torch.where(labels == 1, 1.0, -1.0).to(xt)
        c = torch.where(labels == 1, float(self.class_weight[1]),
                        float(self.class_weight[0])).to(xt) * self.C

        def objective(w):
            slack = torch.clamp(1.0 - y * (xt @ w), min=0.0)
            return 0.5 * (w @ w) + (c * slack * slack).sum()

        def gradient(w):
            margin = y * (xt @ w)
            active = margin < 1.0
            coeff = 2.0 * c * (margin - 1.0) * y
            return w + xt[active].T @ coeff[active], active

        w = xt.new_zeros(xt.shape[1])
        g, active = gradient(w)
        target = TOL * float(torch.linalg.vector_norm(g))
        it = 0
        while float(torch.linalg.vector_norm(g)) > target and it < MAX_ITER:
            it += 1
            step = -self._newton_solve(xt[active], 2.0 * c[active], g)
            f0, slope = objective(w), float(g @ step)
            t = 1.0
            while t > 1e-12 and float(objective(w + t * step)) > \
                    float(f0) + 1e-4 * t * slope:
                t *= 0.5
            w = w + t * step
            g, active = gradient(w)
        self.coef_, self.intercept_ = w[:-1], w[-1]
        self.n_iter_ = it
        self.grad_norm_ = float(torch.linalg.vector_norm(g))
        self.converged_ = self.grad_norm_ <= target
        return self

    @staticmethod
    def _newton_solve(u: torch.Tensor, s: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
        """(I + U^T diag(s) U)^-1 g."""
        h = u.T @ (u * s[:, None])
        h.diagonal().add_(1.0)
        return torch.cholesky_solve(g[:, None], torch.linalg.cholesky(h))[:, 0]

    def decision_function(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.float64) @ self.coef_ + self.intercept_


def kfold(n: int, n_splits: int = 3, seed: int = 0
          ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """``sklearn.model_selection.KFold(n_splits, shuffle=True,
    random_state=seed).split`` of n samples: the indices shuffled by
    ``RandomState(seed)``, cut into n_splits folds (the first n % n_splits
    one larger); each (train, test) pair in ascending order."""
    if not 2 <= n_splits <= n:
        raise ValueError(f"{n_splits} folds of {n} samples")
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    sizes = np.full(n_splits, n // n_splits)
    sizes[: n % n_splits] += 1
    start = 0
    for size in sizes:
        test = np.zeros(n, bool)
        test[order[start:start + size]] = True
        start += size
        yield np.flatnonzero(~test), np.flatnonzero(test)


def average_precision(labels, scores) -> float:
    """``sklearn.metrics.average_precision_score`` of {0, 1} labels:
    sum over the distinct scores, from the highest, of (R_k - R_{k-1}) P_k,
    the recall and precision of everything scored at or above the k-th
    (tied scores enter together)."""
    labels = np.asarray(labels)
    scores = np.asarray(scores, np.float64)
    order = np.argsort(scores, kind="mergesort")[::-1]
    scores, labels = scores[order], labels[order]
    last = np.r_[np.flatnonzero(np.diff(scores)), scores.size - 1]
    tps = np.cumsum(labels == 1, dtype=np.float64)[last]
    fps = 1 + last - tps
    precision = tps / (tps + fps)
    recall = tps / tps[-1] if tps[-1] else np.ones_like(tps)
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


__all__ = ["LinearSVC", "average_precision", "kfold"]
