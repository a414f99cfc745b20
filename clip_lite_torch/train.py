"""The pretraining CLI, the counterpart of the JAX package's
``train.py``: ``python -m clip_lite_torch.train --config <yaml> ...``
trains on one card (``--device cpu`` for the CPU), or on N with one
process a card (``torchrun --nproc-per-node N -m clip_lite_torch.train
...``, or ``--num-hosts``, ``--host-rank`` and ``--coordinator-address``
as the JAX CLI takes them), from CLRec records
through the host loader (with ``DATA.NATIVE_PIPELINE``, JPEG records
decoded on the card a batch at a time) or, with ``DATA.DEVICE_CACHE``,
through the device-resident cache, with val sweeps, checkpoints and
``--resume-from``, as ``python -m clip_lite_tpu.train`` does.  With
``DATA.NEGATIVE_SAMPLING clusters`` it switches to the clustered
hard-negative loaders (``data/datasets.py``, half the batch in items, each
with its negative) at ``DATA.NEGATIVE_SAMPLING_START_ITERATION``, or
starts with them when ``--resume-from`` names a checkpoint at or past it,
as the JAX CLI does (its ``train.py:71-102, 177-187, 300-308``).
Over N ranks ``OPTIM.BATCH_SIZE`` is the global batch: each rank loads
its shard of every batch (the host loaders' ``num_shards``), or samples
its rows from its block of the device cache (``DATA.CACHE_PLACEMENT``),
and ``PARALLEL.ZERO1`` shards the optimizer's state (its
``train.py:125-167, 224-260``); the val sweep's means are over all ranks.

``train_loop`` is the loop (lines 282-371 of the JAX ``train.py``) over
any batch source.  Per call: ``PARALLEL.STEPS_PER_CALL`` (K) train steps
(``engine.make_scanned_train_step``: K eager steps over K batches, the
K-step mean of the metrics), the iteration advanced by K; each cadence
fires when the call crossed one of its boundaries (``crossed_interval``),
as the JAX loop's: every ``log_every`` iterations the metrics come to
the host, go to the log with the timer's stats and peak device memory,
and to the metrics writer; with a ``profile_dir``, a trace of five calls
after the first three (``utils/trace.py``; the JAX ``train.py:294-325``);
every ``checkpoint_every`` iterations a validation sweep (when val
batches are given) writes the mean loss components, and its mean
``total_loss`` is the metric of the checkpoint then written; in the last
20% of training a model-only climax snapshot every ``climax_freq``
iterations; at the end a final checkpoint.  As in the JAX loop, a K
that does not divide ``NUM_ITERATIONS`` runs past it: the last call
takes the run to the next multiple of K, and the final checkpoint, named
``NUM_ITERATIONS``, holds that state.  With ``resume_from`` the loop
first restores the state from that checkpoint and starts the batch
source at its iteration; with ``switch`` it takes new batch sources at
an iteration (the cluster curriculum's switch).

With ``MODEL.VISUAL.PRETRAINED``/``MODEL.TEXTUAL.PRETRAINED`` and their
``PRETRAINED_PATH`` the towers start from local files
(``models/pretrained.py``), loaded after the seeded initialisation, the
optimizer built on them (the JAX ``train.py:215-220``).  Any visual tower
of the registry (ResNet, VGG, ``zoo::<name>``) and text mode (``glove``,
``sbert``, ``train_sbert``, ``finetune_sbert``) trains; the glove and
sbert modes through the host loader only.

``main`` refuses what the JAX CLI refuses (ZeRO-1, ``DATA.SEQ_BUCKETS``
and the device cache with K > 1, among others), and the SSL terms on the
native batch path without the device cache, which makes no augmented
views (ROADMAP Queue 3).

Run (synthetic smoke, on the CPU; ``--profile-dir DIR`` writes the
trace to ``DIR/trace.json.gz``, which ``utils/trace.py`` parses):
    python -m clip_lite_torch.train --device cpu \
        --config-override MODEL.NAME random OPTIM.NUM_ITERATIONS 10
"""

from __future__ import annotations

import json
import logging
from typing import Callable, Dict, Iterable, Optional, Tuple

from clip_lite_torch.config import Config
from clip_lite_torch.data.device_cache import DeviceDataCache
from clip_lite_torch.data.pipeline import DataLoader, infinite_batches
from clip_lite_torch.engine import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_scanned_train_step,
    make_train_step,
    metrics_to_floats,
)
from clip_lite_torch.factories import (
    NegativeSamplingDatasetFactory,
    OptimizerFactory,
    PretrainingDatasetFactory,
)
from clip_lite_torch.models.pretrained import (
    apply_pretrained_weights,
    pretrained_requested,
)
from clip_lite_torch.utils.checkpointing import CheckpointManager, peek_iteration
from clip_lite_torch.parallel.collectives import COUNTS
from clip_lite_torch.parallel.distributed import (
    backend,
    launched_by_torchrun,
    process_count,
    process_index,
    shutdown,
)
from clip_lite_torch.parallel.mesh import local_batch_size
from clip_lite_torch.parallel.zero1 import Zero1Optimizer
from clip_lite_torch.utils.common import (
    common_parser,
    common_setup,
    setup_ranks,
)
from clip_lite_torch.utils.loggers import MetricsWriter
from clip_lite_torch.utils.timers import Timer, device_mem_usage_mb
from clip_lite_torch.utils.trace import (
    record_trace, scope, start_trace, stop_trace)

logger = logging.getLogger("clip_lite_torch")

parser = common_parser(description="Pretrain the VLInfo two-tower model.")
group = parser.add_argument_group("Checkpointing and Logging")
group.add_argument("--resume-from", default=None,
                   help="Checkpoint path to resume from.")
group.add_argument("--checkpoint-every", type=int, default=10000)
group.add_argument("--log-every", type=int, default=500)
group.add_argument("--climax-freq", type=int, default=1000,
                   help="Checkpoint frequency in the last 20%% of training.")
group.add_argument("--keep-recent", type=int, default=100)
group.add_argument("--profile-dir", default=None,
                   help="Write a trace of five steady steps (after the "
                        "first three) to this directory.")

PROFILE_AFTER, PROFILE_STEPS = 3, 5
Sources = Tuple[Iterable, Iterable]  # train and val batches


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
               resume_from: Optional[str] = None,
               profile_dir: Optional[str] = None,
               switch: Optional[Tuple[int, Callable[[int], Sources]]] = None,
               steps_per_call: int = 1) -> TrainState:
    """Train from ``state.step`` up to ``num_iterations`` steps, taking one
    batch of ``batches`` per step, and return the state.

    With ``steps_per_call`` K > 1, ``train_step`` takes a list of K
    batches a call (``engine.make_scanned_train_step``), the iteration
    moves by K a call and the cadences go by ``crossed_interval``; the
    last call may run past ``num_iterations``, as the JAX loop does.

    ``val_batches`` is iterated afresh at each sweep (a list, or a loader).
    With a ``manager`` (whose ``state`` checkpointable becomes ``state``)
    the loop writes checkpoints and climax snapshots as the JAX driver
    does, and waits for the last write before it returns.
    ``resume_from`` (needs a manager) restores ``state`` from that
    checkpoint, in place, and starts ``batches`` at the stored iteration
    through its ``set_start`` (``DeviceDataCache`` has one); a source
    without one must already begin at that iteration.  With a
    ``profile_dir`` the calls after the first ``PROFILE_AFTER`` run under
    the profiler, ``PROFILE_STEPS`` of them (fewer where the run ends
    first), the last of the first ``PROFILE_AFTER`` in its warm-up, and
    their trace goes to ``profile_dir/trace.json.gz``.  With ``switch``,
    ``(at, sources)``, the first step at or past ``at`` replaces the train
    and val batch sources by ``sources(iteration)`` (the old train source
    closed, the batch it had made for that step dropped), as the JAX CLI
    switches to the cluster curriculum's loaders.
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
    k = steps_per_call

    def next_input():
        """The next call's input: a batch, or a list of K (the JAX
        ``next_train_input``)."""
        if k == 1:
            return next(batches)
        return [next(batches) for _ in range(k)]

    timer = Timer(start_from=iteration + 1, total_iterations=num_iterations)
    batch = next_input() if iteration < num_iterations else None
    # The iteration at the end of the first traced call.
    profiler, first_traced = None, iteration + (PROFILE_AFTER + 1) * k
    while iteration < num_iterations:
        iteration += k
        if switch is not None and iteration >= switch[0]:
            logger.info("Switching to clustered hard-negative sampling "
                        "(iteration %d)", iteration)
            if hasattr(batches, "close"):
                batches.close()
            batches, val_batches = switch[1](iteration)
            batches = iter(batches)
            batch = next_input()
            switch = None
        if profile_dir and iteration == first_traced - k \
                and first_traced - k < num_iterations:
            profiler = start_trace(state.device)  # this call is its warm-up
        if profiler is not None and iteration == first_traced:
            record_trace(profiler, state.device)
        timer.tic()
        state, metrics = train_step(state, batch)
        if iteration < num_iterations:
            with scope("next_batch"):
                batch = next_input()  # the host fetch overlaps the step
        if profiler is not None and (
                iteration == first_traced + (PROFILE_STEPS - 1) * k
                or iteration >= num_iterations):
            path = stop_trace(profiler, profile_dir, state.device)
            profiler = None
            logger.info("Profiler trace written to %s (steps %d..%d)", path,
                        first_traced, iteration)
        log_now = crossed_interval(iteration, log_every, k)
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
        if crossed_interval(iteration, checkpoint_every, k):
            metric = None
            if val_batches is not None and eval_step is not None:
                metric = _validate(state, eval_step, val_batches, iteration,
                                   writer)
            if manager is not None:
                manager.checkpointables["state"] = state
                manager.step(iteration, metric=metric)
        # Dense climax snapshots in the last 20% of training.
        if manager is not None and iteration / num_iterations > 0.8 \
                and crossed_interval(iteration, climax_freq, k):
            manager.checkpointables["state"] = state
            manager.climax_step(iteration)
    if manager is not None:
        # A final checkpoint, so that a short run always leaves one; named
        # num_iterations even where the last call ran past it (the JAX
        # loop's manager.step(NUM_ITERATIONS)).
        manager.checkpointables["state"] = state
        manager.step(num_iterations)
        manager.wait()
    return state


def kernel_launches() -> Dict[str, int]:
    """Each hand-written kernel's launches in this process so far, by the
    name of its wrapper's trace range, and K1/K2's on the tensor cores."""
    from clip_lite_torch.data import native
    from clip_lite_torch.ops.attention import (
        attention_backward, fused_short_attention)
    from clip_lite_torch.ops.normalize import augment_normalize_u8, normalize_u8

    return {"K1 attention_fwd": fused_short_attention.launches,
            "K1 tensor cores": fused_short_attention.tc_launches,
            "K2 attention_bwd": attention_backward.launches,
            "K2 tensor cores": attention_backward.tc_launches,
            "K3 normalize_u8": normalize_u8.launches,
            "K3 augment_normalize_u8": augment_normalize_u8.launches,
            "crop_resize_flip_u8": native.crop_resize_flip_u8.launches}


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


def _check_supported(_C: Config, _A) -> None:
    """The JAX CLI's refusals (its ``train.py:168-180``), then the native
    path's with the SSL terms."""
    steps_per_call = max(1, _C.PARALLEL.STEPS_PER_CALL)
    use_clusters = "clusters" in _C.DATA.NEGATIVE_SAMPLING
    if _C.PARALLEL.ZERO1 and steps_per_call > 1:
        raise ValueError("PARALLEL.ZERO1 is incompatible with "
                         "PARALLEL.STEPS_PER_CALL > 1")
    if _C.DATA.SEQ_BUCKETS and steps_per_call > 1:
        raise ValueError("DATA.SEQ_BUCKETS is incompatible with "
                         "PARALLEL.STEPS_PER_CALL > 1 (stacked batches "
                         "must share one compiled shape)")
    if _C.DATA.DEVICE_CACHE and (use_clusters or steps_per_call > 1):
        raise ValueError("DATA.DEVICE_CACHE is incompatible with cluster "
                         "negative sampling and STEPS_PER_CALL > 1")
    if _C.DATA.DEVICE_CACHE and _C.MODEL.TEXTUAL.SELF_SUPERVISED:
        raise ValueError("DATA.DEVICE_CACHE has no augmented-caption "
                         "stream (visual SSL is supported on-device; "
                         "textual SSL needs the host loader)")
    if _C.DATA.DEVICE_CACHE and \
            _C.DATA.CACHE_PLACEMENT not in ("sharded", "replicated"):
        raise ValueError(f"Unknown placement {_C.DATA.CACHE_PLACEMENT!r}")
    if _C.DATA.DEVICE_CACHE and _C.DATA.NAME != "train_sbert":
        raise ValueError(f"DATA.DEVICE_CACHE holds token ids: the "
                         f"{_C.DATA.NAME!r} mode takes the host loader")
    if _C.DATA.NATIVE_PIPELINE and not _C.DATA.DEVICE_CACHE and (
            _C.MODEL.VISUAL.SELF_SUPERVISED or _C.MODEL.TEXTUAL.SELF_SUPERVISED):
        raise NotImplementedError(
            "DATA.NATIVE_PIPELINE makes no augmented views for the SSL terms "
            "(the JAX package's native path trains without them): use "
            "DATA.DEVICE_CACHE for visual SSL, or the Python path")


def init_dataloaders(_C: Config, _A, device, kind: str = "normal") -> tuple:
    """The train and val loaders (the train one length-grouped under
    DATA.SEQ_BUCKETS), pinning their host batches for a CUDA ``device``;
    under DATA.NATIVE_PIPELINE their images are decoded on ``device``.
    ``kind`` ``clusters`` gives the clustered hard-negative loaders at half
    of OPTIM.BATCH_SIZE in items, each a pair and its negative.  Over
    more than one rank each loader yields this rank's shard of every
    global batch."""
    batch_size = _C.OPTIM.BATCH_SIZE
    if kind == "normal":
        train_ds = PretrainingDatasetFactory.from_config(_C, split="train",
                                                         device=device)
        val_ds = PretrainingDatasetFactory.from_config(_C, split="val",
                                                       device=device)
    else:
        train_ds = NegativeSamplingDatasetFactory.from_config(_C, "train")
        val_ds = NegativeSamplingDatasetFactory.from_config(_C, "val")
        batch_size //= 2
    common = dict(num_workers=_A.cpu_workers, seed=_C.RANDOM_SEED,
                  prefetch=_C.DATA.PREFETCH, drop_last=True,
                  pin_memory=device.type == "cuda",
                  num_shards=process_count(), shard_index=process_index())
    train_loader = DataLoader(
        train_ds, batch_size, shuffle=True,
        length_group_batches=(_C.DATA.LENGTH_GROUP_BATCHES
                              if _C.DATA.SEQ_BUCKETS else 0), **common)
    val_loader = DataLoader(val_ds, batch_size, shuffle=False, **common)
    return train_loader, val_loader


def main(_A) -> TrainState:
    """Train as ``_A`` (this module's ``parser``) says; returns the final
    state."""
    device = setup_ranks(_A)
    _C = Config(_A.config, list(_A.config_override))
    _check_supported(_C, _A)
    common_setup(_C, _A, job_type="pretrain")
    world = process_count()
    logger.info("Device: %s; rank %d of %d (process group: %s); global batch "
                "%d (%d a rank)", device, process_index(), world, backend(),
                _C.OPTIM.BATCH_SIZE,
                local_batch_size(_C.OPTIM.BATCH_SIZE, world))

    # The curriculum phase, from the resume point, before any loader is
    # built (the JAX CLI's train.py:177-187).
    start_iteration = peek_iteration(_A.resume_from) if _A.resume_from else 0
    switch_at = None
    kind = "normal"
    if "clusters" in _C.DATA.NEGATIVE_SAMPLING:
        switch_at = _C.DATA.NEGATIVE_SAMPLING_START_ITERATION
        if _A.resume_from and start_iteration >= switch_at:
            kind, switch_at = "clusters", None
    train_loader, val_loader = init_dataloaders(_C, _A, device, kind)
    if _C.DATA.DEVICE_CACHE:
        batches = DeviceDataCache.from_dataset(
            train_loader.dataset, _C.OPTIM.BATCH_SIZE,
            cache_size=_C.DATA.CACHE_IMAGE_SIZE,
            crop_size=_C.DATA.IMAGE_CROP_SIZE,
            seq_buckets=_C.DATA.SEQ_BUCKETS, seed=_C.RANDOM_SEED,
            ssl_aug=_C.MODEL.VISUAL.SELF_SUPERVISED,
            host_cache_dir=_C.DATA.CACHE_HOST_DIR, device=device,
            placement=_C.DATA.CACHE_PLACEMENT)
        batches.set_start(start_iteration)
        logger.info("Device-resident dataset cache: %d items, %s, %.2f GB "
                    "(%.2f GB on this card), built in %.1f s; host pipeline "
                    "out of the loop", len(train_loader.dataset),
                    batches.placement, batches.memory_bytes() / 1e9,
                    batches.memory_bytes_per_device() / 1e9,
                    batches.build_seconds)
    else:
        batches = infinite_batches(train_loader, start_iteration)

    state = create_train_state(_C, device=device)
    if pretrained_requested(_C):
        apply_pretrained_weights(state.model, _C)
        # The update's buffers start from the loaded weights, as the JAX
        # CLI's tx.init(params) after the splice.
        state.optimizer = OptimizerFactory.from_config(_C, state.model)
    n_params = sum(p.numel() for p in state.model.parameters())
    logger.info("Model: %s + %s | %.2fM params", _C.MODEL.VISUAL.NETWORK_NAME,
                _C.MODEL.TEXTUAL.NAME, n_params / 1e6)
    if isinstance(state.optimizer, Zero1Optimizer):
        logger.info("ZeRO-1 weight-update sharding: optimizer state 1/%d "
                    "a rank", world)
    manager = CheckpointManager(_A.serialization_dir + _C.RUN_ID,
                                keep_recent=_A.keep_recent, state=state)
    writer = MetricsWriter(_A.serialization_dir)
    streams = [batches]

    def clustered(iteration: int) -> tuple:
        train, val = init_dataloaders(_C, _A, device, "clusters")
        streams.append(infinite_batches(train, iteration))
        return streams[-1], val

    # The step is this module's make_train_step, which callers may wrap to
    # observe each step, K of them a call.
    try:
        state = train_loop(
            state, make_scanned_train_step(_C, make_train_step(_C)), batches,
            _C.OPTIM.NUM_ITERATIONS,
            log_every=_A.log_every, eval_step=make_eval_step(_C),
            val_batches=val_loader, writer=writer,
            checkpoint_every=_A.checkpoint_every, climax_freq=_A.climax_freq,
            manager=manager, resume_from=_A.resume_from,
            profile_dir=_A.profile_dir,
            switch=None if switch_at is None else (switch_at, clustered),
            steps_per_call=max(1, _C.PARALLEL.STEPS_PER_CALL))
    finally:
        writer.close()
        for stream in streams:  # the loaders' producer threads stop
            if hasattr(stream, "close"):
                stream.close()
    logger.info("Done: %d iterations.", _C.OPTIM.NUM_ITERATIONS)
    logger.info("Kernel launches: %s; collectives: %s",
                json.dumps(kernel_launches()), json.dumps(dict(COUNTS)))
    if launched_by_torchrun() or _A.num_hosts > 1:
        shutdown()  # the group this run joined
    return state


__all__ = ["crossed_interval", "init_dataloaders", "kernel_launches", "main",
           "parser", "train_loop"]


if __name__ == "__main__":
    main(parser.parse_args())
