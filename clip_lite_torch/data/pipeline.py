"""The input pipeline: batching, shuffling, threaded decode and
augmentation, prefetch; the counterpart of the JAX package's
``data/pipeline.py``.

The batch order is a pure function of (seed, epoch), as there, so the
port's loader gives the JAX package's batches for the same seed, and
``infinite_batches`` resumed at iteration N replays the stream from its
N-th batch.  Items load in a thread pool (numpy releases the GIL in its
array work), and finished batches wait in a ``prefetch``-deep queue
filled by a background thread, so host work overlaps the device's step.

Where the JAX loader places batches on the devices (``device_put_fn``),
the port yields torch tensors on the host, in page-locked memory with
``pin_memory``: each batch is copied into its own pinned buffers once, on
the producer thread, and the step's ``_to_device`` copies them to the
card with ``non_blocking=True``.  A batch owns its buffers, so no later
batch writes into memory that a copy may still be reading.

A dataset with ``native_pipeline`` gives whole batches (``load_batch``,
as the JAX loader takes them), their images already uint8 on its device.
On a card the producer decodes on a CUDA stream of its own, so that the
decode overlaps the step; the batch is handed over with an event
recorded after its kernel, which the consumer's stream waits on, and its
tensors are marked as used on the consumer's stream (``record_stream``),
so that the caching allocator does not give their memory to the next
decode while the step still reads it.

Across ranks each loader is one shard (``num_shards``, ``shard_index``,
the JAX loader's arguments and the reference's DistributedSampler): every
rank computes the same (seed, epoch) order of global batches and loads
its contiguous rows of each, so the shards in rank order make up the
global batch.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch


class _ProducerError:
    """An exception raised on the producer thread, for the consumer to
    re-raise (not to take as the end of the stream)."""

    def __init__(self, error: BaseException):
        self.error = error


class _ConsumerGone(Exception):
    """Raised inside a producer's emit() when the consumer has left."""


def _background_batches(produce: Callable, prefetch: int) -> Iterator[Any]:
    """Run ``produce(emit)`` on a daemon thread and yield what it emits,
    through a queue of ``prefetch`` batches.  A producer's exception is
    re-raised here; when the consumer leaves (break, ``close()``, or the
    generator is collected), ``emit`` raises ``_ConsumerGone`` in the
    producer within half a second, which ends it, and the consumer waits
    for that: after ``close()`` the producer launches nothing more.
    ``produce`` returning ends the stream."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
    stop = threading.Event()
    done = object()

    def emit(batch) -> None:
        while not stop.is_set():
            try:
                q.put(batch, timeout=0.5)
                return
            except queue.Full:
                continue
        raise _ConsumerGone

    def runner():
        try:
            produce(emit)
            emit(done)
        except _ConsumerGone:
            pass
        except BaseException as e:
            try:
                emit(_ProducerError(e))
            except _ConsumerGone:
                pass

    thread = threading.Thread(target=runner, daemon=True,
                              name="batch_producer")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                break
            if isinstance(item, _ProducerError):
                raise item.error
            yield item
    finally:
        stop.set()
        while True:  # drain, so that a producer blocked in put() wakes
            try:
                q.get_nowait()
            except queue.Empty:
                break
        thread.join()


class _Batch(dict):
    """A batch on its way from the producer, with the CUDA event after
    which its device tensors are ready (``ready``; None for host ones)."""

    ready: Optional[torch.cuda.Event] = None


def _handed_over(batches: Iterator[_Batch]) -> Iterator[Dict[str, Any]]:
    """``batches`` as plain dicts, each made safe to use on the consumer's
    current stream: it waits for the batch's ``ready`` event, and the
    batch's device tensors are recorded as used on it."""
    try:
        for batch in batches:
            if batch.ready is not None:
                stream = torch.cuda.current_stream(batch["image"].device)
                stream.wait_event(batch.ready)
                for v in batch.values():
                    if v.is_cuda:
                        v.record_stream(stream)
            yield dict(batch)
    finally:
        batches.close()


class DataLoader:
    """Epoch-based loader over a dataset with ``collate_fn``; yields dicts
    of CPU tensors (pinned with ``pin_memory``)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 4,
                 seed: int = 0, prefetch: int = 2,
                 pin_memory: bool = False, background: bool = True,
                 length_group_batches: int = 0,
                 num_shards: int = 1, shard_index: int = 0):
        if batch_size % num_shards:
            raise ValueError(f"batch_size {batch_size} must divide across "
                             f"{num_shards} shards")
        if num_shards > 1 and not drop_last:
            raise ValueError("sharded loading needs drop_last (a ragged "
                             "last batch does not split evenly)")
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} out of range for "
                             f"{num_shards} shards")
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        # DATA.LENGTH_GROUP_BATCHES: shuffle in length-sorted windows of
        # this many batches, so that collate trims each batch to a short
        # bucket.  0 = a plain shuffle.
        self.length_group_batches = length_group_batches
        self._item_lengths: Optional[np.ndarray] = None
        if length_group_batches and shuffle:
            lengths = getattr(dataset, "caption_max_token_lengths",
                              lambda: None)()
            if lengths is not None:
                self._item_lengths = np.asarray(lengths)
        self.background = background
        self.epoch = 0
        self._decode_streams = threading.local()

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def set_iteration(self, iteration: int) -> None:
        """Tell the dataset (one with ``set_iteration``, as the clustered
        one's curriculum needs) which training iteration the next batch
        is for."""
        if hasattr(self.dataset, "set_iteration"):
            self.dataset.set_iteration(iteration)

    def _epoch_order(self) -> np.ndarray:
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch]))
        order = rng.permutation(n)
        if self._item_lengths is None:
            return order
        # Length-grouped: sort each window of G batches by caption length
        # (stably), then shuffle whole batches, so that short batches do
        # not always lead.  With drop_last the ragged tail stays out of
        # the sort, so that the dropped items stay a uniform sample.
        window = self.batch_size * self.length_group_batches
        n_full = n // self.batch_size
        limit = n_full * self.batch_size if self.drop_last else n
        for start in range(0, limit, window):
            w = order[start:min(start + window, limit)]
            order[start:start + len(w)] = w[np.argsort(
                self._item_lengths[w], kind="stable")]
        full = order[:n_full * self.batch_size].reshape(
            n_full, self.batch_size)
        order[:n_full * self.batch_size] = full[
            rng.permutation(n_full)].reshape(-1)
        return order

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def _batches(self, start_batch: int = 0) -> Iterator[np.ndarray]:
        """This shard's index arrays of the epoch's batches from
        ``start_batch``."""
        order = self._epoch_order()
        n_full = len(order) // self.batch_size
        end = n_full * self.batch_size if self.drop_last else len(order)
        local = self.batch_size // self.num_shards
        for b in range(start_batch, -(-end // self.batch_size)):
            idxs = order[b * self.batch_size: (b + 1) * self.batch_size]
            yield idxs[self.shard_index * local:
                       (self.shard_index + 1) * local]

    def _native_device(self) -> Optional[torch.device]:
        """The card that a native-path dataset decodes on, else None."""
        device = getattr(self.dataset, "device", None)
        if getattr(self.dataset, "native_pipeline", False) and \
                device is not None and device.type == "cuda":
            return device
        return None

    def _decode_stream(self, device: torch.device) -> torch.cuda.Stream:
        """This thread's CUDA stream for the native decode."""
        stream = getattr(self._decode_streams, "stream", None)
        if stream is None:
            stream = self._decode_streams.stream = torch.cuda.Stream(device)
        return stream

    def _load_batch(self, idxs: np.ndarray,
                    pool: ThreadPoolExecutor) -> Dict[str, torch.Tensor]:
        """The batch of ``idxs``: a native-path dataset's ``load_batch``
        (on a card, on this thread's decode stream, with the event that
        ends it as ``ready``), else the items through ``pool``, collated;
        trimmed, as tensors, host ones pinned with ``pin_memory``."""
        device = self._native_device()
        ready = None
        if getattr(self.dataset, "native_pipeline", False):
            with torch.cuda.stream(self._decode_stream(device) if device
                                   else None):
                batch = self.dataset.load_batch(idxs)
                if device is not None:
                    ready = torch.cuda.Event()
                    ready.record()
        else:
            items = list(pool.map(self.dataset.__getitem__, idxs))
            batch = self.dataset.collate_fn(items)
        trim = getattr(self.dataset, "trim_batch", None)
        if trim is not None:
            batch = trim(batch)
        out = _Batch((k, torch.from_numpy(np.ascontiguousarray(v))
                      if isinstance(v, np.ndarray) else v)
                     for k, v in batch.items())
        if self.pin_memory:
            out = _Batch((k, v.pin_memory() if v.device.type == "cpu" else v)
                         for k, v in out.items())
        out.ready = ready
        return out

    def __iter__(self):
        return _stream(self, self.background, endless=False)


def _stream(loader: DataLoader, background: bool, endless: bool,
            start_iteration: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
    """The loader's batches: this epoch's, or with ``endless`` those of
    every epoch from ``start_iteration`` on (each epoch set before its
    first batch loads), made in the calling thread or, with
    ``background``, on a producer thread ``loader.prefetch`` ahead."""
    per_epoch = len(loader)
    if endless and per_epoch == 0:
        raise ValueError(f"{len(loader.dataset)} items make no batch of "
                         f"{loader.batch_size}")

    def batches():
        iteration = start_iteration
        with ThreadPoolExecutor(max_workers=loader.num_workers) as pool:
            while True:
                if endless:
                    loader.set_epoch(iteration // per_epoch)
                for idxs in loader._batches(iteration % per_epoch
                                            if endless else 0):
                    if endless:
                        loader.set_iteration(iteration)
                    yield loader._load_batch(idxs, pool)
                    iteration += 1
                if not endless:
                    return

    if not background:
        return _handed_over(batches())

    def produce(emit):
        for batch in batches():
            emit(batch)

    return _handed_over(_background_batches(produce, loader.prefetch))


def infinite_batches(loader: DataLoader,
                     start_iteration: int = 0) -> Iterator[Dict[str, Any]]:
    """An endless stream of batches, exact at any start: iteration N is
    epoch N // len(loader), batch N % len(loader).  With
    ``loader.background`` a background thread fills a
    ``loader.prefetch``-deep queue, so that batches N+1 .. N+prefetch load
    while the card runs step N.  Before it loads each batch, the producer
    calls ``loader.set_iteration`` with the iteration the batch is for
    (the clustered dataset's curriculum reads it), in both modes."""
    return _stream(loader, loader.background, endless=True,
                   start_iteration=start_iteration)


__all__ = ["DataLoader", "infinite_batches"]
