"""The batch roll that pairs each positive with a negative, the
counterpart of the JAX package's ``parallel/collectives.py``.

One process only: the JAX package rolls across the device mesh when its
data axis is bound, and the port's multi-GPU training (ROADMAP Queue 1,
item 5) has not landed, so ``global`` negatives refuse a process group of
more than one rank instead of rolling inside the shard silently.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def roll_shifted_left(x: torch.Tensor, scope: str = "local") -> torch.Tensor:
    """out[i] = x[i + 1 mod B], the JSD loss's negatives
    (``parallel/collectives.py:45-74`` of the JAX package).

    ``local`` rolls within this process's batch; ``global`` is the same
    roll while one process holds the whole batch, as in the JAX package
    when the data axis is unbound."""
    if scope not in ("local", "global"):
        raise ValueError(f"Unknown negatives scope {scope!r}")
    if scope == "global" and dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            "global negatives across ranks land with multi-GPU training "
            "(ROADMAP Queue 1, item 5)")
    if x.shape[0] < 1:
        return x
    return torch.cat([x[1:], x[:1]], dim=0)
