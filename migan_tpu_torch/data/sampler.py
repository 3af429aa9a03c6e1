"""Deterministic shard-aware samplers and a threaded prefetching batch
loader: the port's own copy of `migan_tpu/data/sampler.py`
(`ShardSampler`, `InfiniteSampler`, `_item_rng`, `DataLoader`) and of
`migan_tpu/data/factory.py::collate` (numpy only). Reference: lib/
data_factory/common/ds_sampler.py:7-85.

  - Every rank derives the same permutation from the same integer seed,
    where the reference broadcasts a rank-0 randperm (ds_sampler.py:77-85).
  - `extend=True` pads to an equal per-shard length for evaluation
    (ds_sampler.py:49-52).
  - The loader is a thread pool with a bounded queue; PIL decode and numpy
    release the GIL in their hot parts.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator, List, Optional, Sequence

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


class ShardSampler:
    """Rank-strided sampler with a seed-derived global permutation."""

    def __init__(self, dataset_len: int, num_shards: int = 1, shard: int = 0,
                 shuffle: bool = True, seed: int = 0, extend: bool = False):
        if not 0 <= shard < num_shards:
            raise ValueError(f"shard {shard} of {num_shards}")
        self.n = dataset_len
        self.num_shards = num_shards
        self.shard = shard
        self.shuffle = shuffle
        self.seed = seed
        self.extend = extend

    def epoch_indices(self, epoch: int = 0) -> np.ndarray:
        if self.shuffle:
            order = np.random.RandomState(self.seed + epoch).permutation(
                self.n)
        else:
            order = np.arange(self.n)
        if self.extend:
            # pad so that every shard sees the same count (evaluation's
            # re-interleaving)
            pad = (-len(order)) % self.num_shards
            if pad:
                order = np.concatenate([order, order[:pad]])
        else:
            usable = (len(order) // self.num_shards) * self.num_shards
            order = order[:usable]
        return order[self.shard::self.num_shards]


class InfiniteSampler:
    """Endless shuffled index stream for training: pass after pass of
    `np.random.RandomState(seed + epoch).permutation(dataset_len)`
    (reference misc.py:109-140, with seed-derived reshuffling).

    block: block-contiguous sharding. With ``block=b``, shard p of P
    yields exactly the positions t of the single-process stream
    (``InfiniteSampler(n, seed=seed)``) for which ``(t // b) % P == p``:
    it owns the rows [p*b, (p+1)*b) of every P*b items, and the union of
    the shards, re-interleaved block by block, is the single-process
    stream. ``block=None`` strides item by item (`ShardSampler`)."""

    def __init__(self, dataset_len: int, num_shards: int = 1, shard: int = 0,
                 seed: int = 0, block: Optional[int] = None):
        if block is not None and block < 1:
            raise ValueError(f"block {block}")
        self.inner = ShardSampler(dataset_len, num_shards, shard,
                                  shuffle=True, seed=seed)
        self.block = block
        # the global (single-process) stream a block shard filters
        self._global = ShardSampler(dataset_len, 1, 0, shuffle=True,
                                    seed=seed)

    def __iter__(self) -> Iterator[int]:
        epoch = 0
        if self.block is None:
            while True:
                yield from (int(i) for i in self.inner.epoch_indices(epoch))
                epoch += 1
        b, P, p = self.block, self.inner.num_shards, self.inner.shard
        t = 0      # the global stream position, continuous across epochs
        while True:
            for idx in self._global.epoch_indices(epoch):
                if (t // b) % P == p:
                    yield int(idx)
                t += 1
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
    which is deterministic only at num_workers=1.

    start_position / position_stride / position_block: where this
    loader's items sit in the global item stream. Its t-th item sits at
    ``start_position + (t // position_block) * position_stride *
    position_block + (t % position_block)``: blocks of `position_block`
    items, `position_stride` blocks apart (with the default block of 1,
    ``start_position + t * position_stride``). A resumed run passes the
    items already consumed, so the per-item RNG continues where it
    stopped (the caller fast-forwards `indices` to match). Rank p of P of
    a block-sharded training run passes ``start_position = step *
    global_batch + p * b``, ``position_stride = P``, ``position_block =
    b``, so that its items take the positions the single-process run
    gives them.
    """

    def __init__(self, dataset, batch_size: int, indices=None,
                 num_workers: int = 4, prefetch: int = 4,
                 drop_last: bool = True, seed=None, start_position: int = 0,
                 position_stride: int = 1, position_block: int = 1):
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
        self.position_stride = position_stride
        self.position_block = position_block

    def _position(self, t: int) -> int:
        """The global item-stream position of this loader's t-th item."""
        b = self.position_block
        return (self.start_position
                + (t // b) * self.position_stride * b + (t % b))

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
                try:
                    if self.seed is None:
                        items = [self.dataset[i] for i in idxs]
                    else:
                        items = [self.dataset.__getitem__(
                            i, rng=_item_rng(self.seed,
                                             self._position(t0 + j)))
                            for j, i in enumerate(idxs)]
                    q.put((seq, collate(items)))
                except Exception as e:      # re-raised by the consumer
                    q.put(e)
                    return

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
                if isinstance(item, Exception):
                    raise item
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
