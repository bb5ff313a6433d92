"""Host-side batching + device prefetch (port of `ccdm_tpu/data/loader.py`).

`EpochLoader` is a copy of the JAX package's, held equal to it by
`tests/test_torch_trainer.py`: a seeded, shardable epoch iterator with
per-epoch shuffling from `default_rng((seed, epoch))`, per-sample
augmentation draws from `default_rng((seed, epoch, index))` (the stream is
the same for any worker count), `start_batch` for a mid-epoch resume, and a
thread pool of `num_workers` building batches ahead of the consumer.

`device_prefetch` stages numpy batches onto a torch device a batch or two
ahead: on a CUDA device each array is copied into pinned host memory and
sent with a `non_blocking` copy, so the upload overlaps the step in flight.
"""

from __future__ import annotations

import collections
import concurrent.futures
from typing import Dict, Iterator

import numpy as np
import torch


class EpochLoader:
    """Deterministic, shardable epoch iterator over an indexed dataset.

    `dataset` must expose `__len__` and `get(index, rng) -> dict[str, np.ndarray]`.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        process_index: int = 0,
        process_count: int = 1,
        num_workers: int = 0,
    ):
        if batch_size % process_count:
            raise ValueError(f"global batch {batch_size} not divisible by {process_count} processes")
        self.dataset = dataset
        self.batch_size = batch_size
        self.local_batch = batch_size // process_count
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.num_workers = num_workers

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if (not self.drop_last and self.process_count == 1
                and len(self.dataset) % self.batch_size):
            n += 1  # multi-process always trims to whole global batches
        return n

    def _load_batch(self, idx: np.ndarray, epoch: int) -> Dict[str, np.ndarray]:
        # per-sample generator keyed by (seed, epoch, index): the augmentation
        # stream is independent of batching order and worker count
        samples = [
            self.dataset.get(int(i), np.random.default_rng((self.seed, epoch, int(i))))
            for i in idx
        ]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def _batch_indices(self, epoch: int):
        rng = np.random.default_rng((self.seed, epoch))
        order = rng.permutation(len(self.dataset)) if self.shuffle else np.arange(len(self.dataset))
        if self.process_count > 1:
            # every process must see the SAME number of batches — a
            # data-parallel step is a collective and a straggler with one fewer batch
            # deadlocks the all-reduce. Truncate to whole GLOBAL batches
            # before striding (DistributedSampler-style even split).
            usable = (len(order) // self.batch_size) * self.batch_size
            order = order[:usable]
        order = order[self.process_index::self.process_count]
        nb = len(order) // self.local_batch
        rem = len(order) % self.local_batch
        return [order[b * self.local_batch:(b + 1) * self.local_batch]
                for b in range(nb + (0 if self.drop_last or rem == 0 else 1))]

    def epoch(self, epoch: int, start_batch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Iterate epoch `epoch`, optionally skipping the first `start_batch`
        batches (mid-epoch resume: the skipped batches are never loaded, but
        the permutation and per-sample augmentation streams are unchanged, so
        a resumed run sees exactly the batches an uninterrupted run would)."""
        batches = self._batch_indices(epoch)
        if start_batch:
            batches = batches[start_batch:]
        if self.num_workers <= 0:
            for idx in batches:
                yield self._load_batch(idx, epoch)
            return
        # thread pool with a bounded look-ahead window: host augmentation for
        # batch N+1..N+W proceeds while the device consumes batch N
        with concurrent.futures.ThreadPoolExecutor(self.num_workers) as pool:
            pending = collections.deque()
            it = iter(batches)
            for idx in it:
                pending.append(pool.submit(self._load_batch, idx, epoch))
                if len(pending) > self.num_workers:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()


def device_prefetch(it: Iterator, device, buffer_size: int = 2) -> Iterator:
    """Yield the batches of `it` (dicts of numpy arrays) as dicts of tensors
    on `device`, with up to `buffer_size` batches in flight."""
    device = torch.device(device)
    queue = collections.deque()

    def put(batch):
        staged = {}
        for key, value in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(value))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            else:
                t = t.to(device)
            staged[key] = t
        queue.append(staged)

    for batch in it:
        put(batch)
        if len(queue) >= buffer_size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
