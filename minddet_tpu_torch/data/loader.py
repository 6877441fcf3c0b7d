"""Host data loader: sharded, shuffled batches of same-shaped arrays
(counterpart of ``minddet_tpu/data/loader.py``: ``DistributedSampler``,
``stack_collate`` and ``DataLoader``).

The loader is the reference's threaded pipeline as the segmentation path
uses it: deterministic per-epoch shuffling, host sharding, stack-collate
to static shapes, whole batches only, and worker threads that fill
batches ahead of the consumer, handed out in order. The shard of this
process is ``torch.distributed``'s rank among its world size where a
process group is initialised, else the only one (``process_shard``).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

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


def stack_collate(examples: Sequence[Dict[str, np.ndarray]]
                  ) -> Dict[str, np.ndarray]:
    """Stack same-shaped example dicts into batch arrays."""
    return {k: np.stack([e[k] for e in examples]) for k in examples[0]}


class DataLoader:
    """dataset[int] -> ``stack_collate``, by ``num_workers`` threads; the
    whole batches come out in the sampler's order (the last partial one
    dropped), epoch after epoch when iterated."""

    def __init__(self, dataset, batch_size: int,
                 sampler: Optional[DistributedSampler] = None,
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
