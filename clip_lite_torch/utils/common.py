"""Command-line plumbing shared by the entry points, the counterpart of
the JAX package's ``utils/common.py``: the common arguments (``common_parser``)
and the run's setup (``common_setup``: seeds, the serialization
directory, the config dump, logging to stdout and to a file).

One process per card: ``--device`` takes the place of the JAX package's
``--platform``; a run over several cards starts one process each under
torchrun (``torchrun --nproc-per-node N -m clip_lite_torch.train ...``)
or through the JAX flags ``--coordinator-address``, ``--num-hosts`` and
``--host-rank`` (``setup_ranks``).  ``--num-devices``, if given, must be
the world size.  The eval CLIs run on one card (``check_one_card``).
``--virtual-devices`` (the JAX package's virtual CPU devices) has no
counterpart and raises.
"""

from __future__ import annotations

import argparse
import logging
import os
import random
import sys
import tempfile

import numpy as np
import torch


def common_parser(description: str = "") -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config", default=None,
                        help="Path to a config YAML (merged over defaults).")
    parser.add_argument(
        "--config-override", nargs="*", default=[],
        help="Dotted key-value pairs to override, e.g. OPTIM.BATCH_SIZE 512")
    parser.add_argument("--serialization-dir",
                        default=os.path.join(tempfile.gettempdir(),
                                             "clip_lite_torch"),
                        help="Directory for checkpoints, logs, config dump.")
    parser.add_argument("--checkpoints-dir", default=None,
                        help="Alias of --serialization-dir.")
    parser.add_argument("--cpu-workers", type=int, default=4,
                        help="Host threads that load and augment items.")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on: cuda (default) or cpu.")
    parser.add_argument("--num-devices", type=int, default=0,
                        help="Cards to train on: 0 for the world size (one "
                             "process a card), else equal to it.")
    parser.add_argument("--num-hosts", type=int, default=1,
                        help="Processes, one a card, when started without "
                             "torchrun; above 1 joins them at "
                             "--coordinator-address.")
    parser.add_argument("--host-rank", "--process-id", type=int, default=None,
                        help="This process's rank in [0, num_hosts).")
    parser.add_argument("--coordinator-address", default=None,
                        help="host:port of rank 0 for the rendezvous.")
    parser.add_argument("--virtual-devices", type=int, default=0,
                        help="The JAX package's virtual CPU devices; 0.")
    return parser


def check_one_card(args) -> None:
    """The eval CLIs run on one card, as the JAX package's run on one
    device: refuse the flags' multi-card values."""
    if args.num_devices not in (0, 1) or args.num_hosts != 1 \
            or args.virtual_devices:
        raise ValueError("the eval CLIs run on one card: --num-devices 0 or "
                         "1, --num-hosts 1, no --virtual-devices")


def setup_ranks(args) -> torch.device:
    """Join the process group the flags or torchrun's environment describe
    (``parallel/distributed.py``) and return this rank's device; raises
    for ``--virtual-devices``, and for a ``--num-devices`` other than the
    world size."""
    from clip_lite_torch.parallel.distributed import initialize, process_count

    if args.virtual_devices:
        raise NotImplementedError(
            "--virtual-devices is the JAX package's virtual CPU mesh; the "
            "port runs one process a card (ROADMAP, deliberate differences)")
    device = initialize(args.device, args.coordinator_address,
                        args.num_hosts, args.host_rank)
    world = process_count()
    if args.num_devices not in (0, world):
        raise ValueError(f"--num-devices {args.num_devices} is not the world "
                         f"size {world} (one process a card)")
    return device


def common_setup(config, args, job_type: str = "pretrain") -> logging.Logger:
    """Seed Python, numpy and torch with RANDOM_SEED, set cuDNN's
    ``deterministic`` and ``benchmark`` from CUDNN_DETERMINISTIC and
    CUDNN_BENCHMARK (CUDNN_DETERMINISTIC true also turns on torch's
    deterministic algorithms, warning where an op has none, so that two
    runs of a config give the same bits), create the serialization directory
    (``--checkpoints-dir`` wins over ``--serialization-dir``, and
    ``args.serialization_dir`` becomes it), write
    ``{job_type}_config.yaml`` there (rank 0 only), and log to stdout and
    to ``log_{job_type}.txt`` (``log_{job_type}_h{rank}.txt`` on every
    rank over more than one, as the JAX package names its hosts' logs).
    Returns the ``clip_lite_torch`` logger."""
    from clip_lite_torch.parallel.distributed import (
        is_primary_host,
        process_count,
        process_index,
    )

    random.seed(config.RANDOM_SEED)
    np.random.seed(config.RANDOM_SEED)
    torch.manual_seed(config.RANDOM_SEED)
    torch.backends.cudnn.deterministic = bool(config.CUDNN_DETERMINISTIC)
    torch.backends.cudnn.benchmark = bool(config.CUDNN_BENCHMARK)
    if config.CUDNN_DETERMINISTIC:
        torch.use_deterministic_algorithms(True, warn_only=True)

    ser_dir = args.checkpoints_dir or args.serialization_dir
    args.serialization_dir = ser_dir
    os.makedirs(ser_dir, exist_ok=True)
    if is_primary_host():
        config.dump(os.path.join(ser_dir, f"{job_type}_config.yaml"))

    logger = logging.getLogger("clip_lite_torch")
    logger.setLevel(logging.INFO)
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    fmt = logging.Formatter(
        "%(asctime)s | %(levelname)s | %(message)s", "%Y-%m-%d %H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    suffix = f"_h{process_index()}" if process_count() > 1 else ""
    fh = logging.FileHandler(os.path.join(ser_dir,
                                          f"log_{job_type}{suffix}.txt"))
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.propagate = False
    return logger


__all__ = ["check_one_card", "common_parser", "common_setup", "setup_ranks"]
