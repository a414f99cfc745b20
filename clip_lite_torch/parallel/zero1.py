"""ZeRO-1: the optimizer's state sharded over the ranks, the counterpart of
the JAX package's ``parallel/zero1.py`` (arXiv 2004.13336).

All parameters, in ``model.named_parameters()`` order, form one flat
float32 vector, padded with zeros to n x K (n ranks, K = ceil(L / n));
rank r owns elements [r K, (r + 1) K) of it and holds only that slice of
the momentum (Adam's two moments) and of the Lookahead slow weights.
Per-parameter LR and weight decay become per-element vectors of the same
layout (the JAX ``build_flat_hyperparams``).  A step:

1. reduce-scatter of the flat gradients: each rank receives the sum of
   its slice, divided by n (the mean over the ranks);
2. the global gradient norm from the slices' sums of squares, summed
   over the ranks, and the clip scale min(1, CLIP_GRAD_NORM / norm);
3. on the slice, the arithmetic of :class:`~clip_lite_torch.optim.fused.
   FusedOptimizer`: SGD with coupled L2 and momentum (or AdamW), the
   step at LR x schedule(count), and every ``LOOKAHEAD.STEPS``-th step
   the Lookahead sync slow += alpha (p - slow), p = slow;
4. all-gather of the updated slices into every rank's parameters.

The traffic is an all-reduce's (a reduce-scatter and an all-gather); the
optimizer's memory and work are 1/n of the replicated update's.  Where a
process group is initialised the collectives run over it, a group of one
rank included; without one the slice is the whole vector and the update
is local.

The interface is the fused optimizer's (``step``, ``count``,
``la_count``, ``jax_state``, ``load_jax_state``, ``slow_state``), so a
:class:`~clip_lite_torch.engine.TrainState` holds either.  ``jax_state``
gathers the slices (a collective: every rank calls it) into the
replicated ``FusedOptState`` tree, which is what a checkpoint holds: it
resumes at any world size, and in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from clip_lite_torch.optim import make_decays_fn, make_lr_fn
from clip_lite_torch.optim.fused import _ADAM_BETAS, _ADAM_EPS, _BUFFERS, \
    chain_parts, chain_state, fused_fields
from clip_lite_torch.parallel.collectives import (
    all_gather,
    all_reduce_,
    reduce_scatter,
    world_size,
)
from clip_lite_torch.utils.trace import traced


class Zero1Optimizer:
    """The sharded update over every parameter of ``model``; see the
    module's docstring.  ``schedule_fn`` maps the step count to the LR
    multiplier, as for the fused optimizer."""

    reduces_grads = True  # the step's reduction leaves the gradients alone

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
        self.chain_parts = chain_parts(_O)
        self.chain_layout = not _O.FUSED
        self.schedule_fn = schedule_fn
        self.count = 0
        self.la_count = 0
        self.collective = dist.is_available() and dist.is_initialized()
        self.world = world_size()
        self.rank = dist.get_rank() if self.collective else 0

        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.sizes = [p.numel() for p in self.params]
        self.length = sum(self.sizes)
        self.shard = -(-self.length // self.world)  # K
        lr_for = make_lr_fn(_O.CNN_LR, _O.TRANS_LR, _O.LR)
        decays = make_decays_fn(_O.NO_DECAY)
        modules = dict(model.named_modules())
        wds = [_O.WEIGHT_DECAY if decays(jax_path(model, name, modules))
               else 0.0 for name in self.names]
        lr = np.concatenate([np.full(n, lr_for(name), np.float32)
                             for name, n in zip(self.names, self.sizes)])
        wd = np.concatenate([np.full(n, w, np.float32)
                             for w, n in zip(wds, self.sizes)])
        device = self.params[0].device
        self.lr = self._mine(torch.from_numpy(lr).to(device))
        self.wd = self._mine(torch.from_numpy(wd).to(device))
        with torch.no_grad():
            self.trace = torch.zeros(self.shard, device=device)
            self.nu = torch.zeros_like(self.trace) if self.adam else None
            self.slow = self._mine(self._flat_params()) if self.lookahead \
                else None

    # -- layout --------------------------------------------------------
    def _padded(self, flat: torch.Tensor) -> torch.Tensor:
        pad = self.world * self.shard - flat.numel()
        return torch.nn.functional.pad(flat, (0, pad)) if pad else flat

    def _mine(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a flat (unpadded or padded) vector, a copy."""
        lo = self.rank * self.shard
        return self._padded(flat)[lo:lo + self.shard].clone()

    def _flat_params(self) -> torch.Tensor:
        return torch.cat([p.detach().reshape(-1).float() for p in self.params])

    def _gather(self, shard: torch.Tensor) -> torch.Tensor:
        """Every rank's slice, in rank order: the padded flat vector."""
        if not self.collective:
            return shard
        out = torch.empty(self.world * self.shard, dtype=shard.dtype,
                          device=shard.device)
        return all_gather(out, shard.contiguous())

    def _by_name(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        out, offset = {}, 0
        for name, p, n in zip(self.names, self.params, self.sizes):
            out[name] = flat[offset:offset + n].view(p.shape)
            offset += n
        return out

    # -- the update ----------------------------------------------------
    @torch.no_grad()
    @traced("optimizer")
    def step(self) -> torch.Tensor:
        """One update from the parameters' ``.grad`` (each rank's own, not
        yet averaged; a missing one counts as zero); returns the mean
        gradient's global norm, a 0-d device tensor."""
        flat = self._padded(torch.cat([
            (p.grad if p.grad is not None else torch.zeros_like(p))
            .reshape(-1).float() for p in self.params]))
        if self.collective:
            g = reduce_scatter(torch.empty_like(self.trace), flat)
            g.div_(self.world)
            sq = all_reduce_(torch.sum(g * g).reshape(1)).reshape(())
        else:
            g = flat
            sq = torch.sum(g * g)
        gnorm = torch.sqrt(sq)
        if self.clip_norm and self.clip_norm > 0:
            g.mul_(torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-16),
                               max=1.0))
        p = self._mine(self._flat_params())
        mult = self.schedule_fn(self.count)
        if self.adam:
            b1, b2 = _ADAM_BETAS
            self.trace.mul_(b1).add_(g, alpha=1.0 - b1)
            self.nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            c = np.float32(self.count + 1)
            direction = (self.trace / float(1.0 - np.float32(b1) ** c)) / (
                torch.sqrt(self.nu / float(1.0 - np.float32(b2) ** c))
                + _ADAM_EPS)
            direction.addcmul_(self.wd, p)
        else:
            g.addcmul_(self.wd, p)  # coupled L2
            if self.momentum:
                self.trace.mul_(self.momentum).add_(g)
                direction = self.trace
            else:
                direction = g
        p.sub_(self.lr * mult * direction)
        self.count += 1
        self.la_count += 1
        if self.lookahead and self.la_count % self.la_k == 0:
            self.slow.add_(p - self.slow, alpha=self.la_alpha)
            p.copy_(self.slow)
        full = self._gather(p)
        torch._foreach_copy_(self.params, [
            t.to(q.dtype) for t, q in zip(
                self._by_name(full).values(), self.params)])
        return gnorm

    # -- state ---------------------------------------------------------
    def _buffer(self, attr: str):
        return {"trace": self.trace, "nu": self.nu, "slow": self.slow}[attr]

    def _holds(self, field: str) -> bool:
        return {"nu": self.adam, "slow_params": self.lookahead}.get(field, True)

    def slow_state(self) -> Dict[str, torch.Tensor]:
        """The Lookahead slow weights by parameter name, gathered (every
        rank calls it)."""
        return self._by_name(self._gather(self.slow))

    def jax_state(self, to_tree: Callable[[Dict[str, torch.Tensor]], dict]
                  ) -> dict:
        """The replicated ``FusedOptState`` tree of the fused optimizer (the
        optax chain's layout under ``OPTIM.FUSED: false``, as the fused
        optimizer's), from the gathered slices (a collective)."""
        tree = {field: to_tree(self._by_name(self._gather(self._buffer(attr))))
                if self._holds(field) else {}
                for field, attr in _BUFFERS.items()}
        tree["count"] = np.asarray(self.count, np.int32)
        tree["la_count"] = np.asarray(self.la_count, np.int32)
        if not self.chain_layout:
            return tree
        return chain_state(tree, self.chain_parts, self.lookahead)

    @torch.no_grad()
    def load_jax_state(self, tree: dict,
                       from_tree: Callable[[dict], Dict[str, torch.Tensor]]
                       ) -> None:
        """Take this rank's slices of a ``FusedOptState`` tree or the optax
        chain's (``optim.fused.fused_fields``), written at any world
        size."""
        tree = fused_fields(tree, self.chain_parts, self.adam, self.lookahead)
        for field, attr in _BUFFERS.items():
            if tree[field]:
                values = from_tree(tree[field])
                flat = torch.cat([torch.as_tensor(values[n]).reshape(-1)
                                  .float().to(self.trace.device)
                                  for n in self.names])
                self._buffer(attr).copy_(self._mine(flat))
        self.count = int(tree["count"])
        self.la_count = int(tree["la_count"])


__all__ = ["Zero1Optimizer"]
