"""Collectives across ranks, the counterpart of the JAX package's
``parallel/collectives.py``: the batch roll that pairs each positive with
a negative, across the global batch for ``global`` negatives, and the
mean over ranks (``pmean``) that the step and sync BatchNorm take.

Each function here is a no-op over a world of one (no process group, or
a group of one rank), as the JAX functions are with the data axis
unbound.  Every collective call adds one to ``COUNTS`` under its name, so
a caller can read how many a step ran.
"""

from __future__ import annotations

from collections import Counter
from typing import List

import torch
import torch.distributed as dist

COUNTS: Counter = Counter()  # collective calls by kind


def world_size(group=None) -> int:
    """Ranks in ``group`` (the default one); 1 without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def all_reduce_(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """Reduce ``t`` over the ranks (a sum by default), in place."""
    COUNTS["all_reduce"] += 1
    dist.all_reduce(t, op=op, group=group)
    return t


def reduce_scatter(out: torch.Tensor, t: torch.Tensor, group=None
                   ) -> torch.Tensor:
    """``out`` becomes this rank's slice of the sum of ``t`` over the
    ranks (``t`` holds world x ``out``'s elements)."""
    COUNTS["reduce_scatter"] += 1
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, t, group=group)
    return out


def all_gather(out: torch.Tensor, t: torch.Tensor, group=None
               ) -> torch.Tensor:
    """``out`` becomes every rank's ``t`` in rank order."""
    COUNTS["all_gather"] += 1
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, t, group=group)
    return out


def _exchange(send: torch.Tensor, to: int, frm: int, group=None
              ) -> torch.Tensor:
    """Send ``send`` to rank ``to`` and return what rank ``frm`` sent."""
    COUNTS["send_recv"] += 1
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send.contiguous(), to, group),
           dist.P2POp(dist.irecv, recv, frm, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its gradient is the sum of the ranks' gradients
    (the transpose of ``psum``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the ranks, differentiable: the JAX package's
    ``pmean_if_bound`` (``collectives.py:31``).  ``x`` itself over a world
    of one."""
    n = world_size(group)
    if n == 1:
        return x
    return _AllReduceSum.apply(x, group) / n


class _RollAcrossRanks(torch.autograd.Function):
    """out = x[1:] then the next rank's first row; the gradient of that
    last row goes back to its owner, as JAX's ``ppermute`` transposes."""

    @staticmethod
    def forward(ctx, x, group):
        n, rank = world_size(group), dist.get_rank(group)
        ctx.group, ctx.prev, ctx.next = group, (rank - 1) % n, (rank + 1) % n
        incoming = _exchange(x[:1], ctx.prev, ctx.next, group)
        return torch.cat([x[1:], incoming], dim=0)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        # Our last row came from the next rank: its gradient goes there,
        # and the previous rank sends back the gradient of our first row.
        first = _exchange(grad[-1:], ctx.next, ctx.prev, ctx.group)
        return torch.cat([first, grad[:-1]], dim=0), None


def roll_shifted_left(x: torch.Tensor, scope: str = "local",
                      group=None) -> torch.Tensor:
    """out[i] = x[i + 1 mod B], the JSD loss's negatives
    (``parallel/collectives.py:45-74`` of the JAX package).

    ``local`` rolls within this rank's rows; ``global`` rolls the global
    batch across the ranks of ``group``: each rank shifts its rows and
    takes the next rank's first row as its last, so rank r's last
    positive meets rank r + 1's first caption."""
    if scope not in ("local", "global"):
        raise ValueError(f"Unknown negatives scope {scope!r}")
    if x.shape[0] < 1:
        return x
    if scope == "global" and world_size(group) > 1:
        return _RollAcrossRanks.apply(x, group)
    return torch.cat([x[1:], x[:1]], dim=0)


def flat_all_reduce_mean_(tensors: List[torch.Tensor], group=None) -> None:
    """The mean over ranks of every tensor of ``tensors`` through one
    all-reduce of their float32 concatenation, written back in place: the
    JAX step's one ``psum`` of grads, BatchNorm statistics and metrics,
    divided by n."""
    n = world_size(group)
    if n == 1 or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    all_reduce_(flat, group).div_(n)
    offset = 0
    for t in tensors:
        k = t.numel()
        t.copy_(flat[offset:offset + k].view(t.shape))
        offset += k


__all__ = ["COUNTS", "all_gather", "all_reduce_", "flat_all_reduce_mean_",
           "pmean", "reduce_scatter", "roll_shifted_left", "world_size"]
