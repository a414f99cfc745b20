"""Experiment metrics as JSON lines: the ``metrics.jsonl`` sink of the
JAX package's ``utils/loggers.py`` ``MetricsWriter``, one record per
write, written by rank 0 alone (the others' writer does nothing, as the
JAX package's does off its primary host).  Its TensorBoard and wandb
sinks are not ported."""

from __future__ import annotations

import json
import os
from typing import Dict


class MetricsWriter:
    def __init__(self, serialization_dir: str):
        from clip_lite_torch.parallel.distributed import is_primary_host

        self._jsonl = None
        if is_primary_host():
            os.makedirs(serialization_dir, exist_ok=True)
            self._jsonl = open(os.path.join(serialization_dir,
                                            "metrics.jsonl"), "a")

    def write(self, step: int, metrics: Dict[str, float],
              split: str = "train") -> None:
        if self._jsonl is None:
            return
        record = {"iteration": step, "split": split,
                  **{k: float(v) for k, v in metrics.items()}}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
