"""Experiment metrics as JSON lines: the ``metrics.jsonl`` sink of the
JAX package's ``utils/loggers.py`` ``MetricsWriter``, one record per
write.  Its TensorBoard and wandb sinks are not ported."""

from __future__ import annotations

import json
import os
from typing import Dict


class MetricsWriter:
    def __init__(self, serialization_dir: str):
        os.makedirs(serialization_dir, exist_ok=True)
        self._jsonl = open(os.path.join(serialization_dir, "metrics.jsonl"), "a")

    def write(self, step: int, metrics: Dict[str, float],
              split: str = "train") -> None:
        record = {"iteration": step, "split": split,
                  **{k: float(v) for k, v in metrics.items()}}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()
