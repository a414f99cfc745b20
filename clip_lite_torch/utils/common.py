"""Command-line plumbing shared by the entry points, the counterpart of
the JAX package's ``utils/common.py``: the common arguments (``common_parser``)
and the run's setup (``common_setup``: seeds, the serialization
directory, the config dump, logging to stdout and to a file).

One card, one process: ``--device`` takes the place of the JAX package's
``--platform``, and the JAX flags that spread a run over devices or hosts
are accepted only at their one-card values (more raises: ROADMAP Queue 1,
item 5).
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
                        help="Devices to train on; 0 or 1 (one card).")
    parser.add_argument("--num-hosts", type=int, default=1,
                        help="Host processes; 1.")
    parser.add_argument("--virtual-devices", type=int, default=0,
                        help="The JAX package's virtual CPU devices; 0.")
    return parser


def check_one_card(args) -> None:
    """Refuse the multi-device values of the JAX package's flags."""
    if args.num_devices not in (0, 1) or args.num_hosts != 1 \
            or args.virtual_devices:
        raise NotImplementedError(
            "--num-devices above 1, --num-hosts above 1 and --virtual-devices "
            "land with multi-GPU training (ROADMAP Queue 1, item 5)")


def common_setup(config, args, job_type: str = "pretrain") -> logging.Logger:
    """Seed Python, numpy and torch with RANDOM_SEED, set cuDNN's
    ``deterministic`` and ``benchmark`` from CUDNN_DETERMINISTIC and
    CUDNN_BENCHMARK, create the serialization directory
    (``--checkpoints-dir`` wins over ``--serialization-dir``, and
    ``args.serialization_dir`` becomes it), write
    ``{job_type}_config.yaml`` there, and log to stdout and to
    ``log_{job_type}.txt``.  Returns the ``clip_lite_torch`` logger."""
    random.seed(config.RANDOM_SEED)
    np.random.seed(config.RANDOM_SEED)
    torch.manual_seed(config.RANDOM_SEED)
    torch.backends.cudnn.deterministic = bool(config.CUDNN_DETERMINISTIC)
    torch.backends.cudnn.benchmark = bool(config.CUDNN_BENCHMARK)

    ser_dir = args.checkpoints_dir or args.serialization_dir
    args.serialization_dir = ser_dir
    os.makedirs(ser_dir, exist_ok=True)
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
    fh = logging.FileHandler(os.path.join(ser_dir, f"log_{job_type}.txt"))
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.propagate = False
    return logger


__all__ = ["check_one_card", "common_parser", "common_setup"]
