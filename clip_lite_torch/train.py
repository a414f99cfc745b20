"""The pretraining loop, the counterpart of the loop body of the JAX
package's ``train.py`` (lines 292-337 there), as a function over a batch
iterator the caller supplies (the data loaders are not ported yet:
ROADMAP Queue 1, item 4).

Per iteration: one train step; every ``log_every`` iterations the metrics
come to the host, go to the log with the timer's stats and peak device
memory, and to the metrics writer; every ``val_every`` iterations, when
val batches are given, a validation sweep through the eval step writes
the mean loss components.  Checkpointing, resume, climax snapshots and the
cluster-negatives switch wait for ROADMAP Queue 1, items 3-4.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Iterable, Iterator, Optional

from clip_lite_torch.engine import TrainState, metrics_to_floats
from clip_lite_torch.utils.loggers import MetricsWriter
from clip_lite_torch.utils.timers import Timer, device_mem_usage_mb

logger = logging.getLogger("clip_lite_torch")


def crossed_interval(iteration: int, interval: int,
                     steps_per_call: int = 1) -> bool:
    """True iff a multiple of ``interval`` lies in the half-open window
    ``(iteration - steps_per_call, iteration]``: with one step per call,
    exactly ``iteration % interval == 0``."""
    return iteration % interval < steps_per_call


def train_loop(state: TrainState, train_step: Callable, batches: Iterator,
               num_iterations: int, *, log_every: int = 20,
               eval_step: Optional[Callable] = None,
               val_batches: Optional[Iterable] = None,
               val_every: int = 2000,
               writer: Optional[MetricsWriter] = None) -> TrainState:
    """Train from ``state.step`` up to ``num_iterations`` steps, taking one
    batch of ``batches`` per step, and return the state.

    ``val_batches`` is iterated afresh at each sweep (a list, or a loader).
    """
    timer = Timer(start_from=state.step + 1, total_iterations=num_iterations)
    iteration = state.step
    if iteration >= num_iterations:
        return state
    batch = next(batches)
    while True:
        iteration += 1
        timer.tic()
        state, metrics = train_step(state, batch)
        if iteration < num_iterations:
            batch = next(batches)  # the host fetch overlaps the device step
        log_now = crossed_interval(iteration, log_every)
        if log_now:
            metrics = metrics_to_floats(metrics)
        timer.toc()
        timer.current_iter = iteration + 1
        if log_now:
            logger.info("%s | loss %.3f (xm %.3f) | gnorm %.2f | mem %d MB",
                        timer.stats, metrics["total_loss"],
                        metrics["cross_modal_loss"], metrics["grad_norm"],
                        device_mem_usage_mb(state.device))
            if writer is not None:
                writer.write(iteration, metrics, split="train")
        if val_batches is not None and eval_step is not None \
                and crossed_interval(iteration, val_every):
            _validate(state, eval_step, val_batches, iteration, writer)
        if iteration >= num_iterations:
            return state


def _validate(state: TrainState, eval_step: Callable, val_batches: Iterable,
              iteration: int, writer: Optional[MetricsWriter]) -> None:
    sums: Dict[str, float] = {}
    n_batches = 0
    for index, val_batch in enumerate(val_batches):
        for k, v in metrics_to_floats(eval_step(state, val_batch, index)).items():
            sums[k] = sums.get(k, 0.0) + v
        n_batches += 1
    if not n_batches:
        return
    means = {k: v / n_batches for k, v in sums.items()}
    logger.info("VAL @ %d: %s", iteration,
                {k: round(v, 4) for k, v in means.items()})
    if writer is not None:
        writer.write(iteration, means, split="val")


__all__ = ["crossed_interval", "train_loop"]
