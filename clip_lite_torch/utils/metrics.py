"""Evaluation metrics: the streaming top-k accuracy of the classification
evals, the port's copy of the JAX package's ``utils/metrics.py``
``TopkAccuracy``.  The captioning scorers of that module (CIDEr-D, SPICE)
serve no eval of the port yet (ROADMAP Queue 1, item 6)."""

from __future__ import annotations

import numpy as np


class TopkAccuracy:
    """Streaming top-k accuracy over (logits, labels) batches, in percent."""

    def __init__(self, top_k: int = 1):
        self.top_k = top_k
        self.reset()

    def reset(self) -> None:
        self.num_correct = 0
        self.num_total = 0

    def __call__(self, predictions, labels) -> None:
        predictions = np.asarray(predictions)
        labels = np.asarray(labels)
        if self.top_k == 1:
            top = predictions.argmax(-1)[..., None]
        else:
            top = np.argpartition(-predictions, self.top_k - 1,
                                  axis=-1)[..., : self.top_k]
        correct = (top == labels[..., None]).any(-1)
        self.num_correct += int(correct.sum())
        self.num_total += int(correct.size)

    def get_metric(self, reset: bool = False) -> float:
        value = 100.0 * self.num_correct / max(1, self.num_total)
        if reset:
            self.reset()
        return value


__all__ = ["TopkAccuracy"]
