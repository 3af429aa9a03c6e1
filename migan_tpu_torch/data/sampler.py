"""The training sampler and a threaded prefetching batch loader: the
port's own copy of `migan_tpu/data/sampler.py` (`InfiniteSampler`,
`_item_rng`, `DataLoader` with `start_position`) and of
`migan_tpu/data/factory.py::collate` (numpy only), as single-process
training and evaluation use them. The shard sampler and the loader's
multi-process item positions (`position_stride`, `position_block`) come
with data parallelism.

  - The loader is a thread pool with a bounded queue; PIL decode and numpy
    release the GIL in their hot parts.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator, List, Sequence

import numpy as np


def collate(items: Sequence[Any]):
    """Stack a list of per-item tuples into batched numpy arrays; list
    fields are concatenated and other fields kept as a list
    (reference ds_base.py:95-129)."""
    if not items:
        return items
    first = items[0]
    if isinstance(first, tuple):
        return tuple(collate([it[i] for it in items])
                     for i in range(len(first)))
    if isinstance(first, np.ndarray):
        return np.stack(items)
    if isinstance(first, (int, float)):
        return np.asarray(items)
    if isinstance(first, list):
        out = []
        for it in items:
            out.extend(it)
        return out
    return list(items)


class InfiniteSampler:
    """Endless shuffled index stream for training: pass after pass of
    `np.random.RandomState(seed + epoch).permutation(dataset_len)`
    (reference misc.py:109-140, with seed-derived reshuffling), the
    single-process stream of the JAX package's block-sharded sampler."""

    def __init__(self, dataset_len: int, seed: int = 0):
        self.n = dataset_len
        self.seed = seed

    def __iter__(self) -> Iterator[int]:
        epoch = 0
        while True:
            yield from (int(i) for i in np.random.RandomState(
                self.seed + epoch).permutation(self.n))
            epoch += 1


def _item_rng(seed: int, position: int) -> np.random.RandomState:
    """Per-item RandomState from (loader seed, global item position):
    the same stream whatever the worker count or thread scheduling."""
    return np.random.RandomState(
        np.array([seed, position], np.uint64).view(np.uint32))


class DataLoader:
    """Threaded prefetching batch loader over (dataset, indices).

    seed: when set (the dataset must advertise ``supports_rng``), each item
    is made with its own RandomState from (seed, global item position), so
    any RNG the dataset consumes is deterministic at any worker count.
    When None, the dataset draws from the global ``np.random`` stream,
    which is deterministic only at num_workers=1. The t-th item this
    loader yields sits at position start_position + t of the stream: a
    resumed run passes the items already consumed, so the per-item RNG
    continues where it stopped (the caller fast-forwards `indices` to
    match).
    """

    def __init__(self, dataset, batch_size: int, indices=None,
                 num_workers: int = 4, prefetch: int = 4,
                 drop_last: bool = True, seed=None, start_position: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.indices = indices
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        if seed is not None and not getattr(dataset, "supports_rng", False):
            raise ValueError(
                f"seed given but {type(dataset).__name__} does not "
                "support per-item RNG (set supports_rng = True and "
                "accept __getitem__(idx, rng=...))")
        self.seed = seed
        self.start_position = start_position

    def _index_batches(self):
        """Yields (t0, [dataset indices]); t0 is the local ordinal of the
        batch's first item."""
        it = iter(self.indices if self.indices is not None
                  else range(len(self.dataset)))
        batch: List[int] = []
        t0 = 0
        for idx in it:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield t0, batch
                t0 += len(batch)
                batch = []
        if batch and not self.drop_last:
            yield t0, batch

    def __iter__(self):
        """Yields batches in index order whatever the worker scheduling:
        workers tag each batch with its sequence number and the consumer
        reorders them through a small pending buffer."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        batch_iter = enumerate(self._index_batches())
        lock = threading.Lock()

        def next_batch():
            with lock:
                return next(batch_iter, None)

        def worker():
            while not stop.is_set():
                job = next_batch()
                if job is None:
                    q.put(None)
                    return
                seq, (t0, idxs) = job
                if self.seed is None:
                    items = [self.dataset[i] for i in idxs]
                else:
                    items = [self.dataset.__getitem__(
                        i, rng=_item_rng(self.seed,
                                         self.start_position + t0 + j))
                        for j, i in enumerate(idxs)]
                q.put((seq, collate(items)))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        finished = 0
        next_seq = 0
        pending = {}
        try:
            while True:
                while next_seq in pending:
                    yield pending.pop(next_seq)
                    next_seq += 1
                if finished == self.num_workers:
                    break
                item = q.get()
                if item is None:
                    finished += 1
                    continue
                seq, batch = item
                pending[seq] = batch
        finally:
            stop.set()
            # drain so workers blocked on put() can exit
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
