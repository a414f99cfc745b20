"""Shared layers with the JAX package's precision policy.

Parameters live in float32.  A layer casts its input and its weights to
its ``compute_dtype`` (bfloat16 under AMP) for the product, as the JAX
package's modules do, so a state_dict is the same whatever the compute
type.  Normalization statistics are always taken in float32.

Weights are set by :func:`init_weights`, which walks a model and calls
each layer's ``init_weights(generator)``: every layer initialises its own
direct parameters, with the same distributions as the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

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
    """

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.compute_dtype = compute_dtype
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
        if self.training:
            dims = [d for d in range(x.ndim) if d != 1]
            xf = x.float()
            mean = xf.mean(dims)
            var = xf.var(dims, unbiased=False)
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        # Mixed types (bf16 input, fp32 statistics) normalize in fp32.
        out = F.batch_norm(x, mean, var, self.weight, self.bias, False, 0.0,
                           self.eps)
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
