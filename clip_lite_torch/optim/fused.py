"""The fused optimizer update, the counterpart of the JAX package's
``optim/fused.py`` (``build_fused_optimizer``), for SGD and AdamW; built
by ``factories.OptimizerFactory``.

One call of :meth:`FusedOptimizer.step` runs, in the reference's order
(``optim/fused.py:106-208`` there):

1. the global norm of all gradients, and the clip scale
   min(1, CLIP_GRAD_NORM / norm);
2. per parameter group (one LR, one weight decay): SGD with coupled L2
   (g + wd * p) into the momentum buffer, or AdamW's moments with its
   decoupled decay; then p -= lr * mult * direction, where mult is the
   schedule at the step count;
3. every ``LOOKAHEAD.STEPS``-th call, the Lookahead sync
   slow += alpha * (p - slow); p = slow.

It updates the parameters and its own state in place with
``torch._foreach_*`` ops, one launch per op and group rather than per
tensor; the gradients in ``.grad`` are read and left as they are.  The
clip scale stays a device tensor, so a step never waits on the device.
The JAX package's hoisted-Lookahead and donation modes exist only to work
around XLA and have no counterpart here.

:meth:`FusedOptimizer.jax_state` and :meth:`~FusedOptimizer.load_jax_state`
give and take the state in the layout of the JAX package's
``FusedOptState`` (``optim/fused.py:34-39`` there), what its checkpoints
hold for ``OPTIM.FUSED: true``: ``{trace, nu, slow_params, count,
la_count}``, the first three following the params tree (``nu`` empty for
SGD, ``slow_params`` empty without Lookahead), the counters int32 0-d
arrays with JAX's meaning (both 0 before the first step; the sync runs
when ``la_count % k == 0`` after the increment).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from clip_lite_torch.optim import make_decays_fn, make_lr_fn
from clip_lite_torch.utils.trace import traced

_ADAM_BETAS, _ADAM_EPS = (0.9, 0.999), 1e-8
# FusedOptState's fields, and the _Group buffer behind each tree.
_BUFFERS = {"trace": "trace", "nu": "nu", "slow_params": "slow"}
_FIELDS = (*_BUFFERS, "count", "la_count")


# The CPU's norm of a float32 tensor sums its squares in one accumulator:
# 0.9% off at 1e8 elements (VGG's fc1).  Longer tensors go by chunks.
_CPU_NORM_CHUNK = 1 << 16


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of all ``tensors`` together, a 0-d tensor on their
    device: one ``_foreach_norm`` launch, the CPU's long tensors split
    into chunks first."""
    parts = []
    for t in tensors:
        if t.device.type == "cpu" and t.numel() > _CPU_NORM_CHUNK:
            parts.extend(t.reshape(-1).split(_CPU_NORM_CHUNK))
        else:
            parts.append(t)
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(parts)))


class _Group:
    def __init__(self, lr: float, wd: float):
        self.lr, self.wd = lr, wd
        self.params: List[torch.Tensor] = []
        self.trace: List[torch.Tensor] = []  # SGD momentum / Adam mu
        self.nu: List[torch.Tensor] = []     # Adam second moment
        self.slow: List[torch.Tensor] = []   # Lookahead slow weights


class FusedOptimizer:
    """The fused update over every parameter of ``model``.

    ``schedule_fn`` maps the step count (0 for the first step) to the LR
    multiplier.  Parameters are grouped by (LR, weight decay) from their
    names: see :mod:`clip_lite_torch.optim`.
    """

    def __init__(self, model: nn.Module, config,
                 schedule_fn: Callable[[int], float]):
        from clip_lite_torch.bridge import jax_path

        _O = config.OPTIM
        if _O.OPTIMIZER_NAME not in ("sgd", "adamw"):
            raise KeyError(f"Unknown optimizer {_O.OPTIMIZER_NAME!r}")
        self.adam = _O.OPTIMIZER_NAME == "adamw"
        self.momentum = _O.SGD_MOMENTUM
        self.clip_norm = _O.CLIP_GRAD_NORM
        self.lookahead = bool(_O.LOOKAHEAD.USE)
        self.la_k, self.la_alpha = _O.LOOKAHEAD.STEPS, _O.LOOKAHEAD.ALPHA
        self.schedule_fn = schedule_fn
        self.count = 0     # schedule step counter
        self.la_count = 0  # Lookahead counter
        lr_for = make_lr_fn(_O.CNN_LR, _O.TRANS_LR, _O.LR)
        decays = make_decays_fn(_O.NO_DECAY)
        groups: Dict[Tuple[float, float], _Group] = {}
        self.names: Dict[int, str] = {}
        modules = dict(model.named_modules())
        for name, p in model.named_parameters():
            wd = (_O.WEIGHT_DECAY if decays(jax_path(model, name, modules))
                  else 0.0)
            key = (lr_for(name), wd)
            group = groups.setdefault(key, _Group(*key))
            group.params.append(p)
            self.names[id(p)] = name
        with torch.no_grad():
            for group in groups.values():
                zeros = lambda: [torch.zeros_like(p, dtype=torch.float32)
                                 for p in group.params]
                group.trace = zeros()
                group.nu = zeros() if self.adam else []
                group.slow = ([p.detach().clone() for p in group.params]
                              if self.lookahead else [])
        self.groups = list(groups.values())

    def decayed_names(self) -> List[str]:
        """Names of the parameters that weight decay reaches."""
        return [self.names[id(p)] for g in self.groups if g.wd
                for p in g.params]

    @torch.no_grad()
    @traced("optimizer")
    def step(self) -> torch.Tensor:
        """Apply one update from the parameters' ``.grad`` (a missing grad
        counts as zero, as JAX's zero gradient of a frozen leaf); return
        the gradients' global norm, a 0-d device tensor.  The pass is the
        ``optimizer`` range of a trace."""
        grads = {id(p): (p.grad if p.grad is not None else torch.zeros_like(p))
                 for g in self.groups for p in g.params}
        gnorm = global_norm(list(grads.values()))
        if self.clip_norm and self.clip_norm > 0:
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-16),
                                max=1.0)
        else:
            scale = torch.ones_like(gnorm)
        mult = self.schedule_fn(self.count)
        for group in self.groups:
            g = torch._foreach_mul([grads[id(p)].float() for p in group.params],
                                   scale)
            direction = (self._adam_direction(group, g) if self.adam
                         else self._sgd_direction(group, g))
            torch._foreach_add_(group.params, direction,
                                alpha=-(group.lr * mult))
        self.count += 1
        self.la_count += 1
        if self.lookahead and self.la_count % self.la_k == 0:
            for group in self.groups:
                diff = torch._foreach_sub(group.params, group.slow)
                torch._foreach_add_(group.slow, diff, alpha=self.la_alpha)
                torch._foreach_copy_(group.params, group.slow)
        return gnorm

    def _sgd_direction(self, group: _Group, g: List[torch.Tensor]):
        if group.wd:
            torch._foreach_add_(g, group.params, alpha=group.wd)  # coupled L2
        if not self.momentum:
            return g
        torch._foreach_mul_(group.trace, self.momentum)
        torch._foreach_add_(group.trace, g)
        return group.trace

    def _adam_direction(self, group: _Group, g: List[torch.Tensor]):
        b1, b2 = _ADAM_BETAS
        torch._foreach_mul_(group.trace, b1)
        torch._foreach_add_(group.trace, g, alpha=1.0 - b1)
        torch._foreach_mul_(group.nu, b2)
        torch._foreach_addcmul_(group.nu, g, g, value=1.0 - b2)
        # The bias corrections in float32, as the JAX package reckons them
        # (1 - 0.999 is 1.3e-5 away from its float64 value there).
        c = np.float32(self.count + 1)
        mu_hat = torch._foreach_div(group.trace,
                                    float(1.0 - np.float32(b1) ** c))
        denom = torch._foreach_sqrt(torch._foreach_div(
            group.nu, float(1.0 - np.float32(b2) ** c)))
        torch._foreach_add_(denom, _ADAM_EPS)
        direction = torch._foreach_div(mu_hat, denom)
        if group.wd:
            torch._foreach_add_(direction, group.params, alpha=group.wd)
        return direction

    def slow_state(self) -> Dict[str, torch.Tensor]:
        """The Lookahead slow weights by parameter name."""
        return self._by_name("slow")

    def _by_name(self, attr: str) -> Dict[str, torch.Tensor]:
        return {self.names[id(p)]: b for g in self.groups
                for p, b in zip(g.params, getattr(g, attr))}

    def _holds(self, field: str) -> bool:
        return {"nu": self.adam, "slow_params": self.lookahead}.get(field, True)

    def jax_state(self, to_tree: Callable[[Dict[str, torch.Tensor]], dict]
                  ) -> dict:
        """The state as the JAX package's ``FusedOptState`` tree; ``to_tree``
        maps buffers keyed by parameter name onto the params tree
        (``bridge.to_jax_params``).  The buffers are the live tensors'
        views, not copies."""
        tree = {field: to_tree(self._by_name(attr)) if self._holds(field)
                else {} for field, attr in _BUFFERS.items()}
        tree["count"] = np.asarray(self.count, np.int32)
        tree["la_count"] = np.asarray(self.la_count, np.int32)
        return tree

    @torch.no_grad()
    def load_jax_state(self, tree: dict,
                       from_tree: Callable[[dict], Dict[str, torch.Tensor]]
                       ) -> None:
        """Copy a ``FusedOptState`` tree into the buffers and counters, in
        place; ``from_tree`` maps a params-like tree onto tensors keyed by
        parameter name (``bridge.from_jax_params``).  Raises for any other
        layout, among them the optax chain's state that the JAX package
        writes under ``OPTIM.FUSED: false``: the port has only the fused
        optimizer (``factories.OptimizerFactory``)."""
        if not isinstance(tree, dict) or set(tree) != set(_FIELDS):
            found = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(
                f"the optimizer state holds {found}, not the fused "
                f"optimizer's {list(_FIELDS)}; a JAX run with OPTIM.FUSED "
                "false writes the optax chain's state, which the port (fused "
                "optimizer only) cannot resume")
        for field, attr in _BUFFERS.items():
            if bool(tree[field]) != self._holds(field):
                raise ValueError(
                    f"opt_state.{field} does not fit this optimizer (AdamW "
                    f"{self.adam}, Lookahead {self.lookahead}): the checkpoint "
                    "was written under another OPTIM config")
            if tree[field]:
                values = from_tree(tree[field])
                for g in self.groups:
                    for p, b in zip(g.params, getattr(g, attr)):
                        b.copy_(values[self.names[id(p)]])
        self.count = int(tree["count"])
        self.la_count = int(tree["la_count"])


def slow_params_from_state(optimizer: FusedOptimizer
                           ) -> Optional[Dict[str, torch.Tensor]]:
    """The Lookahead slow weights by parameter name, or None without
    Lookahead: the counterpart of the JAX package's
    ``optim/lookahead.py::slow_params_from_state``.  Only callers that ask
    for the slow weights use it: evals take the fast ones
    (``eval_utils.EncoderBundle``), as the JAX package's do."""
    return optimizer.slow_state() if optimizer.lookahead else None


__all__ = ["FusedOptimizer", "slow_params_from_state"]
