"""Shared layers with the JAX package's precision policy.

Parameters live in float32.  A layer casts its input and its weights to
its ``compute_dtype`` (bfloat16 under AMP) for the product, as the JAX
package's modules do, so a state_dict is the same whatever the compute
type.  Normalization statistics are always taken in float32.

Weights are set by :func:`init_weights`, which walks a model and calls
each layer's ``init_weights(generator)``: every layer initialises its own
direct parameters, with the same distributions as the JAX package.

Training draws its randomness from a :class:`StepRNG`, which the step owns
and passes down; nothing draws from torch's global generator.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clip_lite_torch.parallel.collectives import pmean, world_size

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

InitFn = Callable[[torch.Tensor, torch.Generator], None]


def normal_init(std: float) -> InitFn:
    def init(t: torch.Tensor, generator: torch.Generator) -> None:
        nn.init.normal_(t, 0.0, std, generator=generator)
    return init


def zeros_init(t: torch.Tensor, generator: torch.Generator) -> None:
    nn.init.zeros_(t)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """(Re)initialise every parameter of ``model`` from ``generator``."""
    for module in model.modules():
        init = getattr(module, "init_weights", None)
        if init is not None:
            init(generator)
    return model


class StepRNG:
    """The random draws of one step, a function of (seed, step, stream)
    alone, as the JAX package folds the step into its key
    (``engine.py:88-90``).

    Dropout masks and prior noise come from a generator on the step's
    device; the attention kernels' Philox seeds come from a CPU generator,
    so drawing one never waits on the device; the augmentation draws come
    from a device generator of their own, so a uint8 batch leaves the
    other draws as they are.  ``stream`` tells apart the draws of steps
    that share a step count (the batches of a val sweep); ``rank``, where
    given, the ranks of a step across processes (JAX folds the device's
    index into its key).
    """

    def __init__(self, seed: int, step: int, device, stream: int = 0,
                 rank: Optional[int] = None):
        # The first words of a SeedSequence's state do not depend on how
        # many are asked for.
        key = (seed, step, stream) if rank is None else \
            (seed, step, stream, rank)
        words = np.random.SeedSequence(key).generate_state(3, np.uint64)
        self.device = torch.device(device)
        self.device_gen = torch.Generator(device=self.device).manual_seed(
            int(words[0]) >> 1)
        self.cpu_gen = torch.Generator().manual_seed(int(words[1]) >> 1)
        self.augment_gen = torch.Generator(device=self.device).manual_seed(
            int(words[2]) >> 1)

    def augment_uniform(self, shape: Sequence[int]) -> torch.Tensor:
        """U[0, 1) float32 of ``shape`` on the step's device, from the
        augmentation generator."""
        return torch.rand(tuple(shape), generator=self.augment_gen,
                          device=self.device)

    def kernel_seed(self) -> int:
        """A fresh 62-bit seed for an attention kernel's Philox draw."""
        return int(torch.randint(0, 2 ** 62, (), generator=self.cpu_gen))

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        """U[0, 1) float32 of ``shape`` on the step's device."""
        return torch.rand(tuple(shape), generator=self.device_gen,
                          device=self.device)

    def keep_mask(self, shape: Sequence[int], rate: float) -> torch.Tensor:
        """Bool mask, each element kept with probability 1 - ``rate``."""
        keep = torch.empty(tuple(shape), device=self.device)
        return keep.bernoulli_(1.0 - rate, generator=self.device_gen).bool()


def dropout(x: torch.Tensor, rate: float, rng: Optional[StepRNG]) -> torch.Tensor:
    """flax ``nn.Dropout``: kept values scale by 1 / (1 - rate).  A no-op
    at rate 0 (eval mode passes 0); training at a rate above 0 needs the
    step's ``rng``."""
    if rate <= 0.0:
        return x
    if rng is None:
        raise ValueError("dropout above rate 0 needs the step's StepRNG")
    return torch.where(rng.keep_mask(x.shape, rate), x / (1.0 - rate), 0.0)


class Linear(nn.Module):
    """Dense layer computing in ``compute_dtype``.

    Default init is torch's ``nn.Linear`` one: U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) for weight and bias.  ``weight_init``/``bias_init``
    replace it (BERT's N(0, 0.02) and zero bias, the projection head's
    noisy identity).
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 weight_init: Optional[InitFn] = None,
                 bias_init: Optional[InitFn] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.compute_dtype = compute_dtype
        self.weight_init = weight_init
        self.bias_init = bias_init
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def init_weights(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.in_features) if self.in_features else 0.0
        if self.weight_init is not None:
            self.weight_init(self.weight.data, generator)
        else:
            nn.init.uniform_(self.weight.data, -bound, bound, generator=generator)
        if self.bias is not None:
            if self.bias_init is not None:
                self.bias_init(self.bias.data, generator)
            else:
                nn.init.uniform_(self.bias.data, -bound, bound,
                                 generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 with torch's momentum 0.1 (flax decay 0.9) and
    eps 1e-5; statistics in float32, output in ``compute_dtype``.

    In training the running variance is updated with the biased batch
    variance, as flax does (torch's own ``F.batch_norm`` would use the
    unbiased one).

    ``sync`` (sync BatchNorm, the JAX module's ``axis_name``) takes the
    batch statistics over the ranks of ``process_group`` (the default
    group when None) when it has more than one: flax's mean and mean of
    squares, each averaged over the ranks (differentiably), and the
    biased variance max(0, E[x^2] - E[x]^2).  Over a world of one it is
    the local BatchNorm.
    """

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5,
                 compute_dtype: torch.dtype = torch.float32,
                 sync: bool = False, process_group=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.compute_dtype = compute_dtype
        self.sync = sync
        self.process_group = process_group
        self.weight = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.empty(num_features))
        self.register_buffer("running_mean", torch.empty(num_features))
        self.register_buffer("running_var", torch.empty(num_features))

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight.data)
        nn.init.zeros_(self.bias.data)
        nn.init.zeros_(self.running_mean)
        nn.init.ones_(self.running_var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Mixed types (bf16 input, fp32 parameters and statistics)
        # normalize in fp32.
        if not self.training:
            out = F.batch_norm(x, self.running_mean, self.running_var,
                               self.weight, self.bias, False, 0.0, self.eps)
            return out.to(self.compute_dtype)
        if self.sync and world_size(self.process_group) > 1:
            return self._sync_forward(x)
        # Normalize by the biased batch statistics (differentiable), then
        # move the running ones towards them.
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                           self.eps)
        with torch.no_grad():
            dims = [d for d in range(x.ndim) if d != 1]
            var, mean = torch.var_mean(x.float(), dims, unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return out.to(self.compute_dtype)

    def _sync_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Training over the ranks: flax's ``_compute_stats`` with an
        ``axis_name`` and its normalize, in float32."""
        xf = x.float()
        dims = [d for d in range(x.ndim) if d != 1]
        stats = pmean(torch.cat([xf.mean(dims), (xf * xf).mean(dims)]),
                      self.process_group)
        mean, mean2 = stats.chunk(2)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        shape = [1, -1] + [1] * (x.ndim - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        out = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return out.to(self.compute_dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the last dim, computed in float32, output in
    ``compute_dtype``.  eps 1e-5 (torch's default); BERT passes 1e-12."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.empty(num_features))

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight.data)
        nn.init.zeros_(self.bias.data)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.layer_norm(x.float(), self.weight.shape, self.weight,
                           self.bias, self.eps)
        return out.to(self.compute_dtype)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """``F.normalize(p=2)``: x / max(||x||, eps), in float32."""
    return F.normalize(x.float(), p=2.0, dim=dim, eps=eps)
