"""Checkpoints in the JAX package's own format, the counterpart of its
``utils/checkpointing.py``, function for function.

A file is flax msgpack (:mod:`clip_lite_torch.utils.msgpack_io`) of
``{<name>: <tree>, "iteration": int64}`` for every registered
checkpointable; a :class:`~clip_lite_torch.engine.TrainState` goes in as
the JAX package's ``TrainState`` tree (:func:`engine.to_jax_tree`).  So a
checkpoint that either package writes resumes training in the other and
loads into either's ``EncoderBundle``.  Names as there:
``checkpoint_{it}.msgpack`` (rotated past ``keep_recent``),
``checkpoint_best.msgpack`` (the same bytes, on a better metric: a hard
link to the checkpoint, where the JAX package writes them again) and the
model-only ``climax_model_{it}.msgpack``.

Asynchronous writes.  The optimizer updates the parameters and its
buffers in place (``torch._foreach_*``), so a worker that read the live
tensors would write a torn state, part of step n and part of step n + 1.
``step()`` and ``climax_step()`` therefore copy every tensor leaf on its
device, on the current stream, into kept buffers (views of one flat
buffer, one ``torch._foreach_copy_``), record an event and return; the
one worker thread waits on that event from a side stream, copies the flat
buffer into pinned host memory in one transfer, then serializes and
writes, saves in order.  The buffers (the state's size on the device and
in pinned memory) are made with the manager: pinning 2 GB takes about
half a second and holds up the card meanwhile, so not during a step.  (The JAX package snapshots on the device too,
because its next step donates the state's buffers.)  At most one save is
in flight: each save first waits for the one before, and ``wait()``
re-raises whatever the worker raised.  ``async_writes`` defaults to on
when the state lives on CUDA and off on the CPU, as the JAX driver
chooses by platform.

Across ranks (the JAX ``_globalize`` and ``_is_writer``): every rank
builds the state's tree at each save, which under ZeRO-1 gathers the
optimizer's slices (``parallel/zero1.py``, a collective), and rank 0
alone writes; the others keep no buffers and write nothing.  The file is
the one-rank one, so it resumes at any world size and in the JAX
package; on a load every rank reads it and takes its own slices.
"""

from __future__ import annotations

import glob
import logging
import os
import re
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from clip_lite_torch.engine import TrainState, load_jax_tree, to_jax_tree
from clip_lite_torch.parallel.distributed import is_primary_host
from clip_lite_torch.utils import msgpack_io

logger = logging.getLogger("clip_lite_torch")

_ALIGN = 256  # bytes between the starts of two leaves in a flat buffer
Path = Tuple[str, ...]


def _flatten(tree, path: Path = ()) -> List[Tuple[Path, Any]]:
    """(path, leaf) pairs; an empty dict is a leaf (flax writes ``nu: {}``)."""
    if isinstance(tree, dict) and tree:
        return [item for k, v in tree.items()
                for item in _flatten(v, path + (k,))]
    return [(path, tree)]


def _unflatten(items: List[Tuple[Path, Any]]):
    if len(items) == 1 and items[0][0] == ():
        return items[0][1]
    tree: dict = {}
    for path, leaf in items:
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf
    return tree


class _Staging:
    """Kept buffers for one list of tensor leaves: views of one flat
    buffer on their device and, on CUDA, of one flat pinned host buffer."""

    def __init__(self, tensors: List[torch.Tensor]):
        self.spec = [(tuple(t.shape), t.dtype, t.device) for t in tensors]
        self.device = tensors[0].device
        self.offsets, total = [], 0
        for t in tensors:
            if t.device != self.device:
                raise ValueError(f"checkpoint leaves on {t.device} and "
                                 f"{self.device}")
            self.offsets.append(total)
            total += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
        self.flat = torch.empty(total, dtype=torch.uint8, device=self.device)
        self.views = self._views(self.flat)
        self.ready: Optional[torch.cuda.Event] = None
        if self.device.type == "cuda":
            self._pinned = torch.empty(total, dtype=torch.uint8,
                                       pin_memory=True)
            self.host = self._views(self._pinned)
            self._stream = torch.cuda.Stream(self.device)

    def _views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        return [flat[o: o + _nbytes(shape, dtype)].view(dtype).view(shape)
                for o, (shape, dtype, _) in zip(self.offsets, self.spec)]

    def fits(self, tensors: List[torch.Tensor]) -> bool:
        return self.spec == [(tuple(t.shape), t.dtype, t.device)
                             for t in tensors]

    def copy_in(self, tensors: List[torch.Tensor]) -> None:
        """On the caller's thread and current stream."""
        torch._foreach_copy_(self.views, tensors)
        if self.device.type == "cuda":
            self.ready = torch.cuda.Event()
            self.ready.record()

    def to_host(self) -> List[torch.Tensor]:
        """The copies on the host (on CUDA: one transfer into pinned
        memory on a side stream, after the copy-in's event)."""
        if self.device.type != "cuda":
            return self.views
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(self.ready)
            self._pinned.copy_(self.flat, non_blocking=True)
        self._stream.synchronize()
        return self.host


def _nbytes(shape: tuple, dtype: torch.dtype) -> int:
    return int(np.prod(shape, dtype=np.int64)) * dtype.itemsize


def _tree_of(obj):
    """What a checkpointable is written as: a TrainState as the JAX
    ``TrainState`` tree, anything else (nested dicts of tensors or numpy,
    scalars) as it is."""
    return to_jax_tree(obj) if isinstance(obj, TrainState) else obj


def _restore(target, stored):
    """``stored`` into ``target``: a TrainState and tensors in place, other
    leaves replaced; returns the restored object."""
    if isinstance(target, TrainState):
        load_jax_tree(target, stored)
        return target
    if isinstance(target, dict):
        missing = set(map(str, target)) - set(stored)
        if missing:
            raise KeyError(f"keys {sorted(missing)} are not in the checkpoint")
        return {k: _restore(v, stored[str(k)]) for k, v in target.items()}
    if isinstance(target, torch.Tensor):
        with torch.no_grad():
            target.copy_(torch.as_tensor(stored))
        return target
    return stored


class CheckpointManager:
    """Saves and loads msgpack checkpoints named ``checkpoint_{it}.msgpack``.

    ``checkpointables`` are written under their keyword names (the JAX
    driver registers its TrainState as ``state``).  ``written`` records
    every file written: its ``path``, ``bytes``, the seconds of the copy
    to the host (``host_s``) and of the serialization and write
    (``write_s``), and ``time.perf_counter()`` when it was ``done``."""

    def __init__(self, serialization_dir: str, keep_recent: int = 100,
                 async_writes: Optional[bool] = None, **checkpointables: Any):
        self.serialization_dir = serialization_dir
        self.keep_recent = keep_recent
        self.checkpointables = dict(checkpointables)
        tensors = self._tensors(_flatten(self._trees()))  # every rank
        if async_writes is None:
            async_writes = any(t.device.type == "cuda" for t in tensors)
        async_writes = async_writes and self._is_writer()
        self._executor = (ThreadPoolExecutor(max_workers=1)
                          if async_writes else None)
        self._staging = _Staging(tensors) if async_writes and tensors else None
        self._pending: Optional[Future] = None
        self._best_metric: Optional[float] = None
        self._recent: List[str] = []
        self.written: List[Dict[str, Any]] = []
        if self._is_writer():
            os.makedirs(serialization_dir, exist_ok=True)

    @staticmethod
    def _is_writer() -> bool:
        """Rank 0 writes; the other ranks only take part in the gathers."""
        return is_primary_host()

    @property
    def async_writes(self) -> bool:
        return self._executor is not None

    @property
    def in_flight(self) -> bool:
        """Whether an asynchronous save is still being written."""
        return self._pending is not None and not self._pending.done()

    # -- saving ------------------------------------------------------------
    def step(self, iteration: int, metric: Optional[float] = None,
             mode: str = "min") -> str:
        """Write every checkpointable and the iteration; keep the best
        metric and the ``keep_recent`` newest files.  Asynchronously, this
        returns once the state is copied on its device (see the module's
        docstring)."""
        path = os.path.join(self.serialization_dir,
                            f"checkpoint_{iteration}.msgpack")
        host_tree = self._snapshot()
        if host_tree is not None:
            self._submit(self._write_step, host_tree, iteration, path,
                         metric, mode)
        return path

    def climax_step(self, iteration: int, model_key: str = "state") -> str:
        """Model-only snapshot (params and batch_stats, no optimizer
        state): the dense end-of-training sweep's artifact.  (The whole
        state is copied, into the same buffers as a checkpoint's.)"""
        path = os.path.join(self.serialization_dir,
                            f"climax_model_{iteration}.msgpack")
        host_tree = self._snapshot()
        if host_tree is None:
            return path

        def variables() -> dict:
            tree = host_tree()[model_key]
            return {"params": tree["params"],
                    "batch_stats": tree["batch_stats"]}

        self._submit(self._write, path, variables, iteration)
        return path

    def _submit(self, fn: Callable, *args) -> None:
        if self._executor is None:
            fn(*args)
        else:
            self._pending = self._executor.submit(fn, *args)

    def _trees(self) -> dict:
        return {name: _tree_of(obj)
                for name, obj in self.checkpointables.items()}

    @staticmethod
    def _tensors(items: List[Tuple[Path, Any]]) -> List[torch.Tensor]:
        return [leaf.detach() for _, leaf in items
                if isinstance(leaf, torch.Tensor)]

    def _snapshot(self) -> Optional[Callable[[], dict]]:
        """Copy the checkpointables' tensors into the kept buffers now
        (after waiting for the save in flight, which may still read them),
        and return the function that gives their trees on the host; None
        off rank 0, which only takes part in building the trees."""
        self.wait()
        items = _flatten(self._trees())
        if not self._is_writer():
            return None
        tensors = self._tensors(items)
        staging = self._staging
        if tensors and (staging is None or not staging.fits(tensors)):
            self._staging = staging = None  # the old buffers go first
            self._staging = staging = _Staging(tensors)
        if staging is not None:
            staging.copy_in(tensors)
        # Host leaves are copied too: the caller may change them in place.
        kept = [leaf if isinstance(leaf, torch.Tensor) else
                np.array(leaf) if isinstance(leaf, np.ndarray) else leaf
                for _, leaf in items]

        def host_tree() -> dict:
            host = iter(staging.to_host() if staging is not None else ())
            return _unflatten([
                (path, next(host) if isinstance(leaf, torch.Tensor) else leaf)
                for (path, _), leaf in zip(items, kept)])

        return host_tree

    def _write(self, path: str, host_tree: Callable[[], dict],
               iteration: int) -> None:
        start = time.perf_counter()
        payload = host_tree()
        payload["iteration"] = np.int64(iteration)
        copied = time.perf_counter()
        size = msgpack_io.write(path, payload)
        done = time.perf_counter()
        self.written.append(dict(path=path, bytes=size, host_s=copied - start,
                                 write_s=done - copied, done=done))
        logger.info("wrote %s: %d bytes (to the host %.3f s, written in "
                    "%.3f s)", path, size, copied - start, done - copied)

    def _write_step(self, host_tree, iteration, path, metric, mode) -> None:
        self._write(path, host_tree, iteration)
        if metric is not None:
            better = (self._best_metric is None
                      or (mode == "min" and metric < self._best_metric)
                      or (mode == "max" and metric > self._best_metric))
            if better:
                self._best_metric = float(metric)
                best = os.path.join(self.serialization_dir,
                                    "checkpoint_best.msgpack")
                _atomic_link(path, best)  # the same bytes
        self._recent.append(path)
        while len(self._recent) > self.keep_recent:
            old = self._recent.pop(0)
            # Never the file just written: a path written twice (the final
            # save at a checkpoint iteration) would otherwise go when
            # keep_recent is 1, as it does in the JAX package.
            if old != path and os.path.exists(old):
                os.remove(old)

    def wait(self) -> None:
        """Wait for the save in flight (none in sync mode); re-raise what
        it raised, so that a failed write is never silent."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    # -- loading -----------------------------------------------------------
    def load(self, path: str) -> int:
        """Restore the checkpointables from ``path``, in place and on their
        devices; names in the file that are not registered are skipped.
        Returns the stored iteration."""
        self.wait()
        payload = msgpack_io.read(path)
        iteration = int(payload.pop("iteration", 0))
        for name, stored in payload.items():
            if name in self.checkpointables:
                self.checkpointables[name] = _restore(
                    self.checkpointables[name], stored)
        return iteration

    def restored(self, name: str):
        return self.checkpointables[name]


def _atomic_link(src: str, dst: str) -> None:
    """``dst`` becomes another name of the file ``src``, atomically; a later
    rotation that removes ``src`` leaves ``dst`` whole."""
    tmp = dst + ".tmp"
    if os.path.lexists(tmp):
        os.remove(tmp)
    os.link(src, tmp)
    os.replace(tmp, dst)


def peek_iteration(path: str) -> int:
    """The stored iteration alone (the file is mapped, its arrays not
    read), so that a driver can place its data stream before it builds
    anything."""
    return int(msgpack_io.read(path).get("iteration", 0))


def load_model_variables(path: str) -> Dict[str, Any]:
    """``{params, batch_stats}`` (the fast weights, ``state.params``) from a
    full checkpoint or a climax snapshot of either package: what evals
    take."""
    payload = msgpack_io.read(path)
    if "params" in payload:  # climax snapshot
        return {"params": payload["params"],
                "batch_stats": payload.get("batch_stats", {})}
    state = payload.get("state", {})
    return {"params": state["params"],
            "batch_stats": state.get("batch_stats", {})}


def latest_checkpoint(serialization_dir: str) -> Optional[str]:
    """The full checkpoint of the highest iteration in a directory."""
    paths = glob.glob(os.path.join(serialization_dir, "checkpoint_*.msgpack"))
    best_it, best_path = -1, None
    for p in paths:
        m = re.search(r"checkpoint_(\d+)\.msgpack$", p)
        if m and int(m.group(1)) > best_it:
            best_it, best_path = int(m.group(1)), p
    return best_path


__all__ = ["CheckpointManager", "latest_checkpoint", "load_model_variables",
           "peek_iteration"]
