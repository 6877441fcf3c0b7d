"""Host data loader: sharded, shuffled batches of same-shaped arrays
(counterpart of ``minddet_tpu/data/loader.py``: ``DistributedSampler``,
``GroupSampler``, ``aspect_flags``, ``stack_collate`` and ``DataLoader``).

The loader is the reference's threaded pipeline as the segmentation and
COCO paths use it: deterministic per-epoch shuffling (or batches drawn
from one aspect group at a time), host sharding, stack-collate
to static shapes, whole batches only, and worker threads that fill
batches ahead of the consumer, handed out in order. The shard of this
process is ``torch.distributed``'s rank among its world size where a
process group is initialised, else the only one (``process_shard``).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Sequence, Tuple

import numpy as np
import torch


def process_shard() -> Tuple[int, int]:
    """(shard id, number of shards) of this process: its
    ``torch.distributed`` rank and world size, (0, 1) without a process
    group (the reference's ``jax.process_index`` / ``process_count``)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class DistributedSampler:
    """Deterministic epoch shuffling (``RandomState(seed + epoch)``), padded
    to equal shards by repeating the head; shard ``shard_id`` takes every
    ``num_shards``-th index."""

    def __init__(self, num_examples: int, num_shards: int = 1,
                 shard_id: int = 0, seed: int = 0):
        self.n = num_examples
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.seed = seed

    def epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(self.n)
        np.random.RandomState(self.seed + epoch).shuffle(idx)
        pad = (-len(idx)) % self.num_shards
        if pad:
            idx = np.concatenate([idx, idx[:pad]])
        return idx[self.shard_id::self.num_shards]


class GroupSampler:
    """Group-pure batches with host sharding (the reference's aspect-ratio
    ``GroupSampler``): ``flags`` holds one int per example; each group is
    shuffled, padded to a multiple of ``batch_size`` by repeating its head
    and cut into batches, the batches are permuted, and the shards take
    whole batches round-robin (the list of batches padded by repeating its
    head to a multiple of the shards). One ``RandomState(seed + epoch)``
    draws it all, group by group in flag order."""

    def __init__(self, flags: Sequence[int], batch_size: int,
                 num_shards: int = 1, shard_id: int = 0, seed: int = 0):
        self.flags = np.asarray(flags, np.int64)
        self.batch_size = batch_size
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.seed = seed

    def epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.RandomState(self.seed + epoch)
        batches = []
        for flag in np.unique(self.flags):
            idx = np.nonzero(self.flags == flag)[0]
            rng.shuffle(idx)
            pad = (-len(idx)) % self.batch_size
            if pad:
                idx = np.concatenate([idx, idx[:pad]])
            batches.extend(idx.reshape(-1, self.batch_size))
        order = rng.permutation(len(batches))
        pad_b = (-len(batches)) % self.num_shards
        if pad_b:
            order = np.concatenate([order, order[:pad_b]])
        mine = order[self.shard_id::self.num_shards]
        if not len(mine):
            return np.zeros(0, np.int64)
        return np.concatenate([batches[i] for i in mine])


def aspect_flags(hws: Sequence[Sequence[int]]) -> np.ndarray:
    """Image sizes (h, w) -> ``GroupSampler`` flags: 1 where the image is
    taller than wide, else 0."""
    hw = np.asarray(hws)
    return (hw[:, 0] > hw[:, 1]).astype(np.int64)


def stack_collate(examples: Sequence[Dict[str, np.ndarray]]
                  ) -> Dict[str, np.ndarray]:
    """Stack same-shaped example dicts into batch arrays."""
    return {k: np.stack([e[k] for e in examples]) for k in examples[0]}


class DataLoader:
    """dataset[int] -> ``stack_collate``, by ``num_workers`` threads; the
    whole batches come out in the sampler's order (the last partial one
    dropped), epoch after epoch when iterated. ``dataset`` is anything with
    ``__len__`` and ``__getitem__``; ``sampler`` anything with
    ``epoch_indices(epoch)`` (``DistributedSampler`` where not given,
    ``GroupSampler``)."""

    def __init__(self, dataset, batch_size: int, sampler=None,
                 num_workers: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or DistributedSampler(len(dataset))
        self.num_workers = max(1, num_workers)

    def steps_per_epoch(self) -> int:
        return len(self.sampler.epoch_indices(0)) // self.batch_size

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Yield the collated batches of one epoch; a worker's exception is
        raised at its batch."""
        indices = self.sampler.epoch_indices(epoch)
        n_batches = self.steps_per_epoch()
        if n_batches == 0:
            raise ValueError(
                f"dataset shard yields {len(indices)} examples — fewer than "
                f"batch_size={self.batch_size}; shrink the batch or add "
                "data")
        tasks: "queue.Queue" = queue.Queue()
        for bi in range(n_batches):
            tasks.put((bi, indices[bi * self.batch_size:
                                   (bi + 1) * self.batch_size]))
        results: Dict[int, Any] = {}
        ready = threading.Condition()
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                try:
                    bi, b = tasks.get_nowait()
                except queue.Empty:
                    return
                try:
                    batch = stack_collate([self.dataset[int(i)] for i in b])
                except Exception as e:  # raised to the consumer
                    batch = e
                with ready:
                    results[bi] = batch
                    ready.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for bi in range(n_batches):
                with ready:
                    ready.wait_for(lambda: bi in results)
                    batch = results.pop(bi)
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()

    def __iter__(self):
        epoch = 0
        while True:
            yield from self.epoch(epoch)
            epoch += 1
