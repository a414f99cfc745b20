"""Training engine: the train state and the train and eval steps, the
counterpart of the JAX package's ``engine.py``.

Each rank (one process per card, ``parallel/distributed.py``) runs its
rows of the global batch.  A step is: model in training mode, forward
(the loss dict), backward, then, over more than one rank, the mean over
the ranks of the gradients, the BatchNorm running statistics and the
loss components in one flat all-reduce (the JAX step's one ``psum``
divided by n, ``engine.py:104-130`` there; under ZeRO-1 the gradients
are reduce-scattered by the optimizer instead, ``parallel/zero1.py``),
the optimizer update (fused, or ZeRO-1's sharded one), and metrics = the
loss components + the gradients' global norm.  Every rank averages the
running statistics, as the JAX step does; none takes rank 0's.  PyTorch
runs eagerly, so there is no compiled program: the step updates the
state in place and returns it.  Under ``AMP`` the modules compute in bf16 with fp32 parameters; like
the JAX package (``engine.py:16-18`` there) there is no GradScaler, since
bf16 has fp32's exponent range.

The step's random draws (dropout masks, the attention kernels' Philox
seeds, prior noise, augmentation) are a function of (``RANDOM_SEED``,
step) alone (:class:`~clip_lite_torch.ops.layers.StepRNG`), and of the
rank over more than one rank (JAX's ``_fold_device_rng``), so a world of
one draws as a single process does.

A batch whose ``image`` is uint8 (the device-resident cache's, or a
uint8 host pipeline's) gets its augmentation on the device inside the
step, as the JAX package's ``_maybe_device_preprocess`` gives it: flip,
colour jitter and the normalize (K3) in training, the normalize alone in
eval; a uint8 ``neg_image`` (a hard negative) and ``aug_image`` (the
visual SSL view) the same, with draws of their own.

The train step opens the ``train_step``, ``device_preprocess`` and
``backward`` ranges of a trace (``utils/trace.py``) while a profiler
runs.

:func:`to_jax_tree` and :func:`load_jax_tree` give and take the state as
the JAX package's ``TrainState`` tree (``engine.py:35-41`` there),
``{step, params, batch_stats, opt_state}``, what its checkpoints hold.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from clip_lite_torch import bridge
from clip_lite_torch.config import Config
from clip_lite_torch.eval_utils import resolve_device
from clip_lite_torch.factories import OptimizerFactory, PretrainingModelFactory
from clip_lite_torch.models.model import VLInfoModel
from clip_lite_torch.ops.image_ops import AugDraws, device_preprocess
from clip_lite_torch.ops.layers import BatchNorm, StepRNG, init_weights
from clip_lite_torch.optim.fused import FusedOptimizer
from clip_lite_torch.parallel.collectives import (
    flat_all_reduce_mean_,
    world_size,
)
from clip_lite_torch.parallel.distributed import process_index
from clip_lite_torch.utils.trace import scope

Batch = Dict[str, object]
logger = logging.getLogger("clip_lite_torch")


@dataclass
class TrainState:
    """The training state: the model (its parameters and BatchNorm
    statistics), the optimizer with its buffers and counters, and the
    number of steps taken."""

    step: int
    model: VLInfoModel
    optimizer: FusedOptimizer  # or parallel.zero1.Zero1Optimizer

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def _check_supported(config: Config) -> None:
    if config.PARALLEL.STEPS_PER_CALL > 1:
        raise NotImplementedError(
            "PARALLEL.STEPS_PER_CALL > 1 folds steps into one XLA program; "
            "the port runs one step per call (ROADMAP Queue 1, item 12)")
    if config.PARALLEL.ZERO1 and world_size() == 1:
        # As the JAX package does on a one-device mesh (train.py:164-167).
        logger.warning("PARALLEL.ZERO1 on one rank shards nothing; using the "
                       "replicated update instead")


def create_train_state(config: Config, device="cuda",
                       state_dict: Optional[dict] = None) -> TrainState:
    """The pretraining model of ``config`` on ``device`` (CUDA unless the
    caller asks for the CPU), with the weights of ``state_dict`` or, by
    default, random ones drawn from ``RANDOM_SEED``, and a fresh
    optimizer at step 0."""
    _check_supported(config)
    device = resolve_device(device)
    model = PretrainingModelFactory.from_config(config)
    if state_dict is None:
        init_weights(model, torch.Generator().manual_seed(config.RANDOM_SEED))
    else:
        model.load_state_dict(state_dict)
    memory_format = (torch.channels_last if device.type == "cuda"
                     else torch.preserve_format)
    model = model.to(device, memory_format=memory_format)
    return TrainState(step=0, model=model,
                      optimizer=OptimizerFactory.from_config(config, model))


def to_jax_tree(state: TrainState) -> dict:
    """The state as the JAX package's ``TrainState`` tree: ``step`` an int32
    0-d array, ``params`` and ``batch_stats`` the flax variables,
    ``opt_state`` the ``FusedOptState``.  Its tensors are views of the live
    ones in the JAX layout (on the state's device, not necessarily
    contiguous)."""
    model = state.model

    def view(t: torch.Tensor) -> torch.Tensor:
        return t

    return dict(
        step=np.asarray(state.step, np.int32),
        **bridge.to_jax_variables(model.state_dict(), model, view),
        opt_state=state.optimizer.jax_state(
            lambda tensors: bridge.to_jax_params(tensors, model, view)))


@torch.no_grad()
def load_jax_tree(state: TrainState, tree: dict) -> None:
    """Copy the JAX package's ``TrainState`` tree into ``state``, in place
    and on its device; raises unless every tensor is filled."""
    extra = set(tree) - {"step", "params", "batch_stats", "opt_state"}
    if extra:
        raise KeyError(f"unknown TrainState fields {sorted(extra)}")
    model = state.model
    model.load_state_dict(bridge.convert(
        {"params": tree["params"], "batch_stats": tree["batch_stats"]}, model))
    state.optimizer.load_jax_state(
        tree["opt_state"], lambda t: bridge.from_jax_params(t, model))
    state.step = int(tree["step"])


def _to_device(batch: Batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """Tensors already on ``device`` pass as they are."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def _maybe_device_preprocess(batch: Dict[str, torch.Tensor], rng: StepRNG,
                             train: bool,
                             aug_draws: Optional[Dict[str, AugDraws]] = None
                             ) -> Dict[str, torch.Tensor]:
    """A uint8 ``image``, ``neg_image`` and ``aug_image`` each get flip,
    colour jitter and the normalize in training, the normalize alone in
    eval (``engine.py:69-81`` of the JAX package).  Each key's draws are
    its own: from ``aug_draws`` (:class:`AugDraws` by key) where it has
    them, else drawn from ``rng`` in that order of keys.  Keyed on the
    dtype; float32 images pass as they are."""
    out = dict(batch)
    for key in ("image", "neg_image", "aug_image"):
        image = out.get(key)
        if image is None or image.dtype != torch.uint8:
            continue
        draws = None
        if train:
            draws = (aug_draws or {}).get(key) or AugDraws.sample(
                rng, image.shape[0])
        out[key] = device_preprocess(image, draws, flip=train,
                                     color_jitter=train)
    return out


def _step_rng(seed: int, step: int, device, stream: int = 0) -> StepRNG:
    """The step's draws; the rank joins the key over more than one rank."""
    rank = process_index() if world_size() > 1 else None
    return StepRNG(seed, step, device, stream=stream, rank=rank)


def _reduce_across_ranks(state: TrainState, metrics: Dict[str, torch.Tensor]
                         ) -> None:
    """Over more than one rank, the mean over the ranks, in place, of the
    gradients (unless the optimizer reduce-scatters them itself), every
    BatchNorm's running statistics and ``metrics``: one all-reduce."""
    if world_size() == 1:
        return
    tensors = []
    if not getattr(state.optimizer, "reduces_grads", False):
        for p in state.model.parameters():
            if p.grad is None:  # a leaf the loss does not reach: zero
                p.grad = torch.zeros_like(p)
            tensors.append(p.grad)
    tensors += [t for m in state.model.modules() if isinstance(m, BatchNorm)
                for t in (m.running_mean, m.running_var)]
    names = list(metrics)
    values = [metrics[k].detach().float().clone() for k in names]
    flat_all_reduce_mean_(tensors + values)
    metrics.update(zip(names, values))


def make_train_step(config: Config) -> Callable:
    """``train_step(state, batch, prior_noise=None, aug_draws=None) ->
    (state, metrics)``.

    ``batch`` holds ``image`` (B, H, W, 3), float32 and normalized or
    uint8 (augmented and normalized in the step), and ``input_ids``,
    ``attention_mask`` (B, L), as numpy arrays or tensors, for the cluster
    curriculum ``neg_image`` and ``neg_input_ids``/``neg_attention_mask``,
    and for the SSL terms ``aug_image`` and
    ``aug_input_ids``/``aug_attention_mask``;
    ``prior_noise`` optionally replaces the prior terms' draws and
    ``aug_draws`` the uint8 images' augmentation draws (``AugDraws`` by
    key).  The metrics are 0-d device tensors (reading one waits for the
    step).  After the step the parameters'
    ``.grad`` hold its gradients, unclipped."""
    _check_supported(config)
    seed = config.RANDOM_SEED

    def train_step(state: TrainState, batch: Batch,
                   prior_noise: Optional[Dict[str, torch.Tensor]] = None,
                   aug_draws: Optional[Dict[str, AugDraws]] = None):
        with scope("train_step"):
            model = state.model
            model.train()
            model.zero_grad(set_to_none=True)
            rng = _step_rng(seed, state.step, state.device)
            with scope("device_preprocess"):
                batch = _maybe_device_preprocess(
                    _to_device(batch, state.device), rng, train=True,
                    aug_draws=aug_draws)
            out = model(batch, rng=rng, prior_noise=prior_noise)
            with scope("backward"):
                out["loss"].backward()
            metrics = dict(out["loss_components"])
            _reduce_across_ranks(state, metrics)
            metrics["grad_norm"] = state.optimizer.step()
            state.step += 1
        return state, metrics

    return train_step


def make_eval_step(config: Config) -> Callable:
    """``eval_step(state, batch, index=0, prior_noise=None) -> components``:
    the loss components under eval-mode norms and no dropout (the val
    sweep).  ``index`` (the batch's place in the sweep) varies the prior
    noise across a sweep, as the JAX loop folds it into the key."""
    seed = config.RANDOM_SEED

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch, index: int = 0,
                  prior_noise: Optional[Dict[str, torch.Tensor]] = None):
        model = state.model
        model.eval()
        rng = _step_rng(seed, state.step, state.device, stream=1 + index)
        batch = _maybe_device_preprocess(_to_device(batch, state.device), rng,
                                         train=False)
        out = model(batch, rng=rng, prior_noise=prior_noise)
        components = dict(out["loss_components"])
        flat_all_reduce_mean_(list(components.values()))  # pmean over ranks
        return components

    return eval_step


def metrics_to_floats(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Device metrics -> Python floats, with one copy to the host."""
    names = list(metrics)
    values = torch.stack([metrics[k].float() for k in names]).cpu()
    return dict(zip(names, np.asarray(values, np.float64).tolist()))


__all__ = ["TrainState", "create_train_state", "load_jax_tree",
           "make_train_step", "make_eval_step", "metrics_to_floats",
           "to_jax_tree"]
