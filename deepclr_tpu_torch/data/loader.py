"""Data loader: dataset -> transforms -> fixed-shape batches -> prefetch.

A worker map plus a producer thread feeding a bounded queue, so host
preprocessing overlaps the card's work.  Two worker modes
(``data_loader.worker_type``), used on the training split only:

  * ``thread`` (default): a thread pool.  numpy releases the GIL in its
    array work, and samples never cross a pickle boundary.  The workers
    share one transform ``Generator``, so with workers the draw order is
    not deterministic.
  * ``process``: spawned worker processes, for transform chains that hold
    the GIL (the O(n * k) host FPS on large clouds).  Each worker reseeds
    its copy of the transforms, so the augmentation streams differ across
    workers; each worker imports this package, and with it torch.

Per epoch e the seed is ``cfg.seed * 100003 + e``: the dataset's shuffle
draws from it, the transforms from +1, the batcher's subsamples from +2
and the process workers' reseeding from +3.
"""
from __future__ import annotations

import itertools
import multiprocessing
import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import numpy as np

from ..geometry import LabelType
from ..utils.profiling import span
from .batching import BatchBuilder
from .datasets import build_dataset
from .transforms import build_transform

__all__ = ["DataLoader", "make_dataflow", "make_data_loader"]

DEFAULT_NUM_POINTS = 16384


def _model_presorted(cfg) -> bool:
    """model.params.presorted: the host Morton-sorts each padded cloud
    exactly when the model skips its first stage's device sort."""
    params = getattr(getattr(cfg, "model", None), "params", None)
    if params is None:
        return False
    if hasattr(params, "to_dict"):
        params = params.to_dict()
    if isinstance(params, dict):
        return bool(params.get("presorted", False))
    return bool(getattr(params, "presorted", False))


def _map_iter(it: Iterator, fn: Callable, workers: int, buffer: int) -> Iterator:
    """Map fn over an iterator with a thread pool, keeping the order."""
    if workers <= 0:
        for x in it:
            yield fn(x)
        return
    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending = []
        depth = max(buffer, workers * 2)
        for x in it:
            pending.append(pool.submit(fn, x))
            if len(pending) >= depth:
                yield pending.pop(0).result()
        for f in pending:
            yield f.result()


_WORKER_FN: Optional[Callable] = None


def _reseed_transform(fn: Callable, seed: int) -> None:
    """Give every rng-carrying member of a Compose its own fresh stream."""
    members = getattr(fn, "transforms", [fn])
    for i, t in enumerate(members):
        if hasattr(t, "rng"):
            t.rng = np.random.default_rng(seed + 7919 * (i + 1))


def _proc_init(fn: Callable, seed: int) -> None:
    global _WORKER_FN
    _WORKER_FN = fn
    _reseed_transform(fn, seed ^ os.getpid())


def _proc_apply(x):
    return _WORKER_FN(x)


def _map_iter_proc(it: Iterator, fn: Callable, workers: int, buffer: int,
                   seed: int) -> Iterator:
    """Map fn over an iterator with spawned worker processes, keeping the
    order, with a bounded number of submissions in flight (Pool.imap's
    feeder thread would drain the whole epoch into its task queue).  spawn,
    not fork: the parent holds threads (torch's pools, the prefetcher), and
    forking them can deadlock."""
    ctx = multiprocessing.get_context("spawn")
    pool = ctx.Pool(workers, initializer=_proc_init, initargs=(fn, seed))
    try:
        pending: deque = deque()
        depth = max(buffer, workers * 2)
        for x in it:
            pending.append(pool.apply_async(_proc_apply, (x,)))
            if len(pending) >= depth:
                yield pending.popleft().get()
        while pending:
            yield pending.popleft().get()
    finally:
        pool.terminate()
        pool.join()


class _Prefetcher:
    """Producer thread + bounded queue; the producer's exception is raised
    in the consumer.  A consumer that stops early (the trainer at its last
    iteration) stops the producer, which closes its iterator, and with it
    any worker pool.  The consumer's wait for each batch is a
    ``loader.wait`` span (``utils.profiling.span``; its id the batch's
    index in the epoch), one a batch handed out."""

    def __init__(self, make_iter: Callable[[], Iterator], buffer_size: int):
        self._make_iter = make_iter
        self._buffer_size = max(1, buffer_size)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(self._buffer_size)
        stop = object()
        gone = threading.Event()
        err: List[BaseException] = []

        def put(item) -> bool:
            while not gone.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            it = self._make_iter()
            try:
                for item in it:
                    if not put(item):
                        break
            except BaseException as e:  # handed to the consumer, which raises it
                err.append(e)
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()
                put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            for i in itertools.count():
                with span("loader.wait", i) as wait:
                    item = q.get()
                    if item is stop and wait is not None:
                        wait.discard()   # the end of the epoch, not a batch
                if item is stop:
                    break
                yield item
        finally:
            gone.set()
            t.join()
        if err:
            raise err[0]


class DataLoader:
    """Iterable of fixed-shape batch dicts with a length; each iteration is
    a new epoch with its own seeds."""

    def __init__(self, cfg, is_train: bool,
                 source: Optional[Union[str, List]] = None,
                 batch_size: Optional[int] = None,
                 shard_index: int = 0, num_shards: int = 1):
        self._cfg = cfg
        self._is_train = is_train
        self._source = source
        self._batch_size = batch_size or cfg.data_loader.batch_size
        self._num_points = cfg.data_loader.num_points or DEFAULT_NUM_POINTS
        # data-parallel: each process takes a disjoint sample slice
        self._shard_index = shard_index
        self._num_shards = num_shards
        self._epoch = 0
        self._len: Optional[int] = None

    def _dataset(self, seed: int):
        source = self._source
        if source is None:
            source = self._cfg.data.training if self._is_train else self._cfg.data.validation
        return build_dataset(self._cfg.data.dataset_type, source, shuffle=self._is_train, seed=seed)

    def __len__(self) -> int:
        if self._len is None:
            n = len(self._dataset(seed=0))
            if self._num_shards > 1:
                # every process runs the same number of steps: all shards
                # take the smallest shard's count of full batches
                self._len = (n // self._num_shards) // self._batch_size
            elif self._is_train:
                self._len = n // self._batch_size  # the remainder is dropped: fixed shapes
            else:
                bs = self._batch_size
                self._len = (n + bs - 1) // bs
        return self._len

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        self._epoch += 1
        seed = self._cfg.seed * 100003 + self._epoch
        ds = self._dataset(seed=seed)
        transform = build_transform(self._cfg, is_training=self._is_train,
                                    rng=np.random.default_rng(seed + 1))
        batcher = BatchBuilder(
            self._batch_size,
            LabelType.create(self._cfg.model.label_type),
            self._num_points,
            remainder=not self._is_train,
            seed=seed + 2,
            morton=_model_presorted(self._cfg),
        )
        workers = self._cfg.data_loader.num_workers if self._is_train else 0
        buffer = self._cfg.data_loader.buffer_size
        worker_type = getattr(self._cfg.data_loader, "worker_type", "thread")

        def sharded():
            if self._num_shards <= 1:
                yield from ds
                return
            for i, sample in enumerate(ds):
                if i % self._num_shards == self._shard_index:
                    yield sample

        def make_iter():
            if workers > 0 and worker_type == "process":
                mapped = _map_iter_proc(sharded(), transform, workers, buffer, seed + 3)
            else:
                mapped = _map_iter(sharded(), transform, workers, buffer)
            return batcher(mapped)

        batches = _Prefetcher(make_iter, buffer) if buffer > 0 else make_iter()
        if self._num_shards > 1:
            # at most the common length of __len__, so every batch is full
            limit = len(self)
            for i, b in enumerate(batches):
                if i >= limit:
                    break
                yield b
        else:
            yield from batches


def make_dataflow(cfg, is_train: bool, source=None, batch_size=None):
    """The full dataflow is the DataLoader itself (the reference's name)."""
    return DataLoader(cfg, is_train, source=source, batch_size=batch_size)


def make_data_loader(cfg, is_train: bool, **kwargs) -> Optional[DataLoader]:
    """A loader over the configured split; None when the split has no data."""
    source = kwargs.pop("source", None)
    if source is None:
        configured = cfg.data.training if is_train else cfg.data.validation
        if configured is None:
            return None
    return DataLoader(cfg, is_train, source=source, **kwargs)
