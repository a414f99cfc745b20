"""Rank processes for ``tests/test_torch_distributed.py``: each function
here runs in a spawned process that joined a gloo group on the CPU, and
writes what it saw with ``torch.save`` for the test to read.  This module
imports torch and the port only (no JAX), so a rank starts quickly.

``spawn(fn, world, workdir)`` starts ``world`` ranks of ``fn(rank, world,
workdir)`` at ``tcp://localhost:<free port>``, with torch on one thread
each, and raises if any rank fails.
"""

from __future__ import annotations

import os
import socket
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "configs", "fs_bs1024_ni250k.yaml")
# The step cases' config: tests/test_torch_train.py's TRAIN (ResNet-18 at
# width 8, two BERT layers of 128, dropout off, fp32) with a Lookahead
# sync every second step, so that three steps cross one.
TRAIN = ["AMP", False, "MODEL.VISUAL.NETWORK_NAME", "resnet18",
         "MODEL.VISUAL.FEATURE_SIZE", 512,
         "MODEL.VISUAL.WIDTH", 8, "DATA.IMAGE_CROP_SIZE", 32,
         "MODEL.TEXTUAL.NUM_HIDDEN_LAYERS", 2, "MODEL.TEXTUAL.HIDDEN_SIZE", 128,
         "DATA.MAX_CAPTION_LENGTH", 8, "MODEL.TEXTUAL.VOCAB_SIZE", 128,
         "MODEL.TEXTUAL.DROPOUT", 0.0, "OPTIM.WARMUP_STEPS", 2,
         "OPTIM.NUM_ITERATIONS", 20, "OPTIM.LOOKAHEAD.STEPS", 2,
         "OPTIM.CNN_LR", 0.002]
# The step cases: (BatchNorm mode, ZeRO-1).
VARIANTS = [("local", False), ("sync", False), ("local", True),
            ("sync", True)]
CHECKPOINT_AT = 2  # the sync ZeRO-1 run's checkpoint


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, fn, workdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        fn(rank, world, workdir)
    except BaseException:
        with open(os.path.join(workdir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, workdir: str) -> None:
    os.makedirs(workdir, exist_ok=True)
    try:
        mp.spawn(_entry, args=(world, _free_port(), fn, workdir),
                 nprocs=world, join=True)
    except Exception as e:
        errors = [open(os.path.join(workdir, f)).read()
                  for f in sorted(os.listdir(workdir))
                  if f.startswith("error_")]
        raise RuntimeError("\n".join(errors) or str(e)) from e


def _save(workdir, name, rank, value):
    torch.save(value, os.path.join(workdir, f"{name}_{rank}.pt"))


def load(workdir, name, world):
    return [torch.load(os.path.join(workdir, f"{name}_{r}.pt"),
                       weights_only=False)
            for r in range(world)]


# -- four ranks: the global roll and the loss ---------------------------
def roll_and_loss(rank, world, workdir):
    from clip_lite_torch.ops.loss import JSDInfoMaxLoss
    from clip_lite_torch.parallel.collectives import COUNTS, roll_shifted_left

    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    b = inputs["x"].shape[0] // world
    rows = slice(rank * b, (rank + 1) * b)
    x = inputs["x"][rows].clone().requires_grad_(True)
    out = roll_shifted_left(x, "global")
    (out * inputs["w"][rows]).sum().backward()
    counts = dict(COUNTS)  # the roll's, forward and backward
    local = roll_shifted_left(inputs["x"][rows], "local")

    loss = JSDInfoMaxLoss(image_dim=64, text_dim=48, image_prior=False,
                          text_prior=False, negatives="global")
    loss.load_state_dict(inputs["loss_state"])
    loss.eval()
    with torch.no_grad():
        total = loss(inputs["img"][rank * 8:(rank + 1) * 8],
                     inputs["txt"][rank * 8:(rank + 1) * 8])["total_loss"]
    mean = total.clone()
    dist.all_reduce(mean)
    _save(workdir, "roll", rank, dict(
        out=out.detach(), grad=x.grad, local=local, loss=total,
        loss_mean=mean / world, counts=counts))


# -- two ranks: the steps, sync BatchNorm, input and checkpoints --------
def _state(overrides, inputs):
    from clip_lite_torch.config import Config
    from clip_lite_torch.engine import create_train_state

    cfg = Config(FLAGSHIP, TRAIN + overrides)
    return cfg, create_train_state(cfg, device="cpu",
                                   state_dict=inputs["state_dict"])


def _steps(rank, world, workdir, inputs, bn, zero1):
    from clip_lite_torch.engine import make_train_step, metrics_to_floats
    from clip_lite_torch.parallel.collectives import COUNTS
    from clip_lite_torch.parallel.mesh import shard_batch
    from clip_lite_torch.utils.checkpointing import CheckpointManager

    cfg, state = _state(["MODEL.VISUAL.BN_MODE", bn, "PARALLEL.ZERO1", zero1],
                        inputs)
    step = make_train_step(cfg)
    name = f"{bn}_{'zero1' if zero1 else 'replicated'}"
    manager = None
    if bn == "sync" and zero1:
        manager = CheckpointManager(os.path.join(workdir, f"ckpt_rank{rank}"),
                                    state=state)
    metrics, collectives, after = [], [], {}
    for i, batch in enumerate(inputs["batches"]):
        COUNTS.clear()
        state, m = step(state, shard_batch(batch), prior_noise=inputs["noise"])
        collectives.append(dict(COUNTS))
        metrics.append(metrics_to_floats(m))
        if not zero1:  # .grad holds the mean gradient: its norm in float64
            metrics[-1]["grad_norm64"] = float(torch.sqrt(sum(
                torch.sum(p.grad.double() ** 2)
                for p in state.model.parameters() if p.grad is not None)))
        if manager is not None and i + 1 == CHECKPOINT_AT:
            manager.step(i + 1)
            manager.wait()
            after = dict(
                model={k: v.clone() for k, v in
                       state.model.state_dict().items()},
                optimizer=state.optimizer.jax_state(  # gathered, by name
                    lambda d: {k: v.clone() for k, v in d.items()}))
    if manager is not None:
        manager.wait()
    _save(workdir, name, rank, dict(
        metrics=metrics, collectives=collectives,
        state_dict={k: v.clone() for k, v in state.model.state_dict().items()},
        slow=state.optimizer.slow_state(), after=after,
        optimizer=type(state.optimizer).__name__))


def _sync_batchnorm(rank, world, workdir, inputs):
    from clip_lite_torch.ops.layers import BatchNorm

    x_all, w_all = inputs["bn_x"], inputs["bn_w"]
    b = x_all.shape[0] // world
    bn = BatchNorm(x_all.shape[1], sync=True)
    with torch.no_grad():
        bn.weight.copy_(inputs["bn_scale"])
        bn.bias.copy_(inputs["bn_bias"])
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0)
    x = x_all[rank * b:(rank + 1) * b].clone().requires_grad_(True)
    out = bn(x)
    (out * w_all[rank * b:(rank + 1) * b]).sum().backward()
    grads = torch.cat([bn.weight.grad, bn.bias.grad])
    dist.all_reduce(grads)  # the parameters' gradient of the summed loss
    _save(workdir, "bn", rank, dict(
        out=out.detach(), dx=x.grad, dscale=grads[:x_all.shape[1]],
        dbias=grads[x_all.shape[1]:], running_mean=bn.running_mean.clone(),
        running_var=bn.running_var.clone()))


def _input_shards(rank, world, workdir, inputs):
    from clip_lite_torch.data.device_cache import DecodedCorpus, \
        DeviceDataCache, rows_held
    from clip_lite_torch.data.pipeline import DataLoader, infinite_batches

    ds = IdDataset()
    loader = DataLoader(ds, 8, shuffle=True, drop_last=True, num_workers=1,
                        seed=7, background=False, num_shards=world,
                        shard_index=rank)
    stream = infinite_batches(loader)
    loader_ids = [next(stream)["image_id"].numpy() for _ in range(6)]
    stream.close()

    corpus = inputs["corpus"]
    n = len(corpus["ids"])
    caches = {}
    for placement in ("sharded", "replicated"):
        rows = rows_held(n, 3, placement)
        held = DecodedCorpus(corpus["images"][rows],
                             [corpus["ids"][i] for i in rows],
                             [corpus["mask"][i] for i in rows],
                             corpus["n_caps"][rows], corpus["image_ids"][rows])
        cache = DeviceDataCache(held, 8, cache_size=12, crop_size=8,
                                seq_buckets=[4, 6], seed=3, device="cpu",
                                placement=placement, n_items=n)
        cache.set_start(5)
        it = iter(cache)
        caches[placement] = dict(
            rows=rows, batches=[next(it) for _ in range(3)],
            bytes=cache.memory_bytes_per_device())
    _save(workdir, "input", rank, dict(loader=loader_ids, caches=caches))


def _host_files(rank, world, workdir):
    import argparse
    import logging

    from clip_lite_torch.config import Config
    from clip_lite_torch.utils.common import common_setup
    from clip_lite_torch.utils.loggers import MetricsWriter

    out = os.path.join(workdir, f"files_rank{rank}")
    writer = MetricsWriter(out)
    writer.write(1, {"loss": 1.0})
    writer.close()
    logger = common_setup(Config(), argparse.Namespace(
        checkpoints_dir=None, serialization_dir=out), job_type="pretrain")
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    logging.getLogger("clip_lite_torch").propagate = True


def two_ranks(rank, world, workdir):
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    for bn, zero1 in VARIANTS:
        _steps(rank, world, workdir, inputs, bn, zero1)
    _sync_batchnorm(rank, world, workdir, inputs)
    _input_shards(rank, world, workdir, inputs)
    _host_files(rank, world, workdir)


class IdDataset:
    """32 items, each its index as ``image_id`` and a few pixels."""

    def __len__(self):
        return 32

    def __getitem__(self, idx):
        return {"image_id": np.int64(idx),
                "image": np.full((2, 2, 3), idx, np.uint8)}

    @staticmethod
    def collate_fn(items):
        return {k: np.stack([it[k] for it in items]) for k in items[0]}


def synthetic_corpus(n=13, size=12, seed=0) -> dict:
    """A decoded corpus of ``n`` items with 1-3 captions each."""
    rng = np.random.RandomState(seed)
    n_caps = rng.randint(1, 4, n).astype(np.int32)
    ids, mask = [], []
    for c in n_caps:
        lengths = rng.randint(1, 7, c)
        mask.append((np.arange(8)[None, :] < lengths[:, None]).astype(np.int32))
        ids.append(rng.randint(1, 100, (c, 8)).astype(np.int32) * mask[-1])
    return dict(images=rng.randint(0, 256, (n, size, size, 3)).astype(np.uint8),
                ids=ids, mask=mask, n_caps=n_caps,
                image_ids=np.arange(100, 100 + n, dtype=np.int64))
