"""The process group: one process per card, the counterpart of the JAX
package's ``parallel/distributed.py``.

The JAX package runs one controller over a device mesh and reaches other
hosts through ``jax.distributed.initialize``.  The port runs one process
per card and joins them with ``torch.distributed``: NCCL when the ranks
run on CUDA, gloo on the CPU (the backend follows the device; nothing
falls back from one to the other).  The group comes from torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) or from the JAX CLI's flags, ``--coordinator-address
host:port``, ``--num-hosts`` and ``--host-rank`` (one process each).

Without either, nothing is initialised and the process is a world of
one: ``process_count()`` is 1 and every collective of the port is skipped.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger("clip_lite_torch")

TIMEOUT = timedelta(minutes=10)  # a rank that never arrives raises


def backend_for(device) -> str:
    """NCCL for CUDA ranks, gloo for CPU ones."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def launched_by_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def local_rank() -> int:
    """This process's card on its host: torchrun's ``LOCAL_RANK``, else
    0."""
    return int(os.environ.get("LOCAL_RANK", 0))


def initialize(device="cuda", coordinator_address: Optional[str] = None,
               num_hosts: int = 1, host_rank: Optional[int] = None
               ) -> torch.device:
    """Join the process group, if the run has more than this process, and
    return the rank's device (``cuda:LOCAL_RANK`` for a CUDA ``device``).

    Under torchrun the group comes from its environment (a world of one
    included); else with ``num_hosts`` above 1 from
    ``tcp://coordinator_address`` with ``host_rank``.  A rendezvous that
    fails raises.  A group already initialised is kept."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        device = torch.device("cuda", local_rank())
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    kwargs = dict(backend=backend_for(device), timeout=TIMEOUT)
    if launched_by_torchrun():
        dist.init_process_group(init_method="env://", **kwargs)
    elif num_hosts > 1:
        if coordinator_address is None or host_rank is None:
            raise ValueError("--num-hosts above 1 needs --coordinator-address "
                             "and --host-rank")
        dist.init_process_group(init_method=f"tcp://{coordinator_address}",
                                world_size=num_hosts, rank=host_rank,
                                **kwargs)
    else:
        return device
    logger.info("Process group (%s): rank %d of %d on %s",
                dist.get_backend(), dist.get_rank(), dist.get_world_size(),
                device)
    return device


def process_index() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of ranks; 1 without a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary_host() -> bool:
    """Whether this is rank 0, the one that writes checkpoints, metrics
    and the config dump."""
    return process_index() == 0


def backend() -> Optional[str]:
    """The group's backend (``nccl``, ``gloo``); None without a group."""
    return dist.get_backend() if dist.is_initialized() else None


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


__all__ = ["backend", "backend_for", "initialize", "is_primary_host",
           "launched_by_torchrun", "local_rank", "process_count",
           "process_index", "shutdown"]
