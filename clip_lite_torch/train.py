"""The pretraining loop, the counterpart of the loop of the JAX package's
``train.py`` (lines 282-371 there), as a function over a batch source the
caller supplies (the data loaders are not ported yet: ROADMAP Queue 1,
item 4).

Per iteration: one train step; every ``log_every`` iterations the metrics
come to the host, go to the log with the timer's stats and peak device
memory, and to the metrics writer; every ``checkpoint_every`` iterations a
validation sweep (when val batches are given) writes the mean loss
components, and its mean ``total_loss`` is the metric of the checkpoint
then written; in the last 20% of training a model-only climax snapshot
every ``climax_freq`` iterations; at the end a final checkpoint.  With
``resume_from`` the loop first restores the state from that checkpoint
and starts the batch source at its iteration.  The cluster-negatives
switch waits for ROADMAP Queue 1, item 4.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Iterable, Optional

from clip_lite_torch.engine import TrainState, metrics_to_floats
from clip_lite_torch.utils.checkpointing import CheckpointManager
from clip_lite_torch.utils.loggers import MetricsWriter
from clip_lite_torch.utils.timers import Timer, device_mem_usage_mb

logger = logging.getLogger("clip_lite_torch")


def crossed_interval(iteration: int, interval: int,
                     steps_per_call: int = 1) -> bool:
    """True iff a multiple of ``interval`` lies in the half-open window
    ``(iteration - steps_per_call, iteration]``: with one step per call,
    exactly ``iteration % interval == 0``."""
    return iteration % interval < steps_per_call


def train_loop(state: TrainState, train_step: Callable, batches: Iterable,
               num_iterations: int, *, log_every: int = 20,
               eval_step: Optional[Callable] = None,
               val_batches: Optional[Iterable] = None,
               writer: Optional[MetricsWriter] = None,
               checkpoint_every: int = 10000, climax_freq: int = 1000,
               manager: Optional[CheckpointManager] = None,
               resume_from: Optional[str] = None) -> TrainState:
    """Train from ``state.step`` up to ``num_iterations`` steps, taking one
    batch of ``batches`` per step, and return the state.

    ``val_batches`` is iterated afresh at each sweep (a list, or a loader).
    With a ``manager`` (whose ``state`` checkpointable becomes ``state``)
    the loop writes checkpoints and climax snapshots as the JAX driver
    does, and waits for the last write before it returns.
    ``resume_from`` (needs a manager) restores ``state`` from that
    checkpoint, in place, and starts ``batches`` at the stored iteration
    through its ``set_start`` (``DeviceDataCache`` has one); a source
    without one must already begin at that iteration.
    """
    if manager is not None:
        manager.checkpointables["state"] = state
    iteration = state.step
    if resume_from is not None:
        if manager is None:
            raise ValueError("resume_from needs a CheckpointManager")
        iteration = manager.load(resume_from)
        state = manager.restored("state")
        if hasattr(batches, "set_start"):
            batches.set_start(iteration)
        logger.info("Resumed from %s at iteration %d", resume_from, iteration)
    batches = iter(batches)
    timer = Timer(start_from=iteration + 1, total_iterations=num_iterations)
    batch = next(batches) if iteration < num_iterations else None
    while iteration < num_iterations:
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
        if crossed_interval(iteration, checkpoint_every):
            metric = None
            if val_batches is not None and eval_step is not None:
                metric = _validate(state, eval_step, val_batches, iteration,
                                   writer)
            if manager is not None:
                manager.checkpointables["state"] = state
                manager.step(iteration, metric=metric)
        # Dense climax snapshots in the last 20% of training.
        if manager is not None and iteration / num_iterations > 0.8 \
                and crossed_interval(iteration, climax_freq):
            manager.checkpointables["state"] = state
            manager.climax_step(iteration)
    if manager is not None:
        # A final checkpoint, so that a short run always leaves one.
        manager.checkpointables["state"] = state
        manager.step(num_iterations)
        manager.wait()
    return state


def _validate(state: TrainState, eval_step: Callable, val_batches: Iterable,
              iteration: int, writer: Optional[MetricsWriter]
              ) -> Optional[float]:
    """The val sweep; returns its mean ``total_loss`` (None without
    batches)."""
    sums: Dict[str, float] = {}
    n_batches = 0
    for index, val_batch in enumerate(val_batches):
        for k, v in metrics_to_floats(eval_step(state, val_batch, index)).items():
            sums[k] = sums.get(k, 0.0) + v
        n_batches += 1
    if not n_batches:
        return None
    means = {k: v / n_batches for k, v in sums.items()}
    logger.info("VAL @ %d: %s", iteration,
                {k: round(v, 4) for k, v in means.items()})
    if writer is not None:
        writer.write(iteration, means, split="val")
    return means.get("total_loss")


__all__ = ["crossed_interval", "train_loop"]
