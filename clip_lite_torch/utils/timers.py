"""Per-iteration timing with ETA, meters, and peak device memory: the JAX
package's ``utils/timers.py`` (``Timer``, ``AverageMeter``,
``SmoothedValue``, ``MetricLogger`` and ``device_mem_usage_mb``)."""

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


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(1, self.count)


class SmoothedValue:
    """Windowed median/average tracker (reference: utils/base.py:233-290)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    @property
    def median(self) -> float:
        vals = sorted(self.deque)
        return vals[len(vals) // 2] if vals else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / max(1, len(self.deque))

    @property
    def global_avg(self) -> float:
        return self.total / max(1, self.count)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    """Named SmoothedValues + periodic logging generator
    (reference: utils/base.py:293-395; cross-process sync is unnecessary —
    metrics are already pmean'd inside the compiled step)."""

    def __init__(self, delimiter: str = "  "):
        self.meters: dict = collections.defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, name):
        if name in self.meters:
            return self.meters[name]
        raise AttributeError(name)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable, print_freq: int, logger=None,
                  header: str = ""):
        timer = Timer(total_iterations=getattr(iterable, "__len__", lambda: None)()
                      if hasattr(iterable, "__len__") else None)
        for i, obj in enumerate(iterable):
            timer.tic()
            yield obj
            timer.toc()
            if i % print_freq == 0:
                msg = f"{header} [{i}] {self} | {timer.stats}"
                (logger.info if logger else print)(msg)


def device_mem_usage_mb(device) -> int:
    """Peak memory allocated on the CUDA ``device`` since its last reset,
    in MB (``torch.cuda.max_memory_allocated``); 0 for the CPU, which
    keeps no such count."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device)) // (1024 * 1024)
