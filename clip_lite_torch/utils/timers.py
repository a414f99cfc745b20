"""Per-iteration timing with ETA, and peak device memory: the JAX
package's ``utils/timers.py`` ``Timer`` and ``device_mem_usage_mb``."""

from __future__ import annotations

import collections
import datetime
import time
from typing import Optional

import torch


class Timer:
    """Moving-window per-iteration timer with ETA."""

    def __init__(self, start_from: int = 1, total_iterations: Optional[int] = None,
                 window_size: int = 20):
        self.current_iter = start_from
        self.total = total_iterations
        self.deltas = collections.deque(maxlen=window_size)
        self._start = time.perf_counter()

    def tic(self) -> None:
        self._start = time.perf_counter()

    def toc(self) -> None:
        self.deltas.append(time.perf_counter() - self._start)
        self.current_iter += 1

    @property
    def avg_iter_time(self) -> float:
        return sum(self.deltas) / max(1, len(self.deltas))

    @property
    def eta_hhmm(self) -> str:
        if not self.total or not self.deltas:
            return "N/A"
        remaining = max(0, (self.total - self.current_iter) * self.avg_iter_time)
        return str(datetime.timedelta(seconds=int(remaining)))

    @property
    def stats(self) -> str:
        return (f"Iter {self.current_iter - 1} | Time/iter "
                f"{self.avg_iter_time:.3f}s | ETA {self.eta_hhmm}")


def device_mem_usage_mb(device) -> int:
    """Peak memory allocated on the CUDA ``device`` since its last reset,
    in MB (``torch.cuda.max_memory_allocated``); 0 for the CPU, which
    keeps no such count."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device)) // (1024 * 1024)
