"""Host-side batching data loader with threaded decode and prefetch (a
copy of ``semseg_tpu/data/loader.py``).

Replaces the reference's ``torch.utils.data.DataLoader`` +
``DistributedSampler`` (``tool/train.py:204-207``): per-host sharding of a
globally shuffled index stream, a cv2-friendly thread pool (cv2 releases
the GIL; ``cv2.setNumThreads(0)`` avoids oversubscription), and a bounded
prefetch queue so augmentation overlaps device execution.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

import numpy as np


def _stack_batch(samples: Sequence):
    images = np.stack([s[0] for s in samples])
    labels = np.stack([s[1] for s in samples])
    return images, labels


class EpochSampler:
    """Deterministic per-epoch shuffling + contiguous host sharding.

    Matches DistributedSampler semantics: every shard sees
    ``ceil(N / num_shards)`` indices (wrapping around when N is not
    divisible) so all hosts run the same number of steps.
    """

    def __init__(
        self,
        num_samples: int,
        shuffle: bool = True,
        seed: int = 0,
        shard_index: int = 0,
        num_shards: int = 1,
    ):
        self.num_samples = num_samples
        self.shuffle = shuffle
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            order = rng.permutation(self.num_samples)
        else:
            order = np.arange(self.num_samples)
        per_shard = -(-self.num_samples // self.num_shards)
        total = per_shard * self.num_shards
        if total > self.num_samples:  # wrap-around padding
            order = np.concatenate([order, order[: total - self.num_samples]])
        return order[self.shard_index::self.num_shards]


class DataLoader:
    """Iterates (images, labels) numpy batches.

    Args:
      dataset: map-style dataset yielding (image HWC, label HW) numpy pairs
        of a uniform shape (train/val pipelines crop to fixed size).
      batch_size: per-host batch size.
      drop_last: drop the trailing partial batch.
      num_workers: decode/augment thread count (0 = synchronous).
      prefetch: number of batches to stage ahead.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        num_workers: int = 8,
        drop_last: bool = False,
        seed: int = 0,
        shard_index: int = 0,
        num_shards: int = 1,
        prefetch: int = 2,
        deterministic_augment: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed
        # Seed transform randomness per (seed, epoch, sample index) so
        # augmentation is reproducible for any worker count/scheduling
        # (fixes the reference's unwired worker_init_fn).
        self.deterministic_augment = deterministic_augment
        self.sampler = EpochSampler(
            len(dataset), shuffle, seed, shard_index, num_shards
        )
        self._start_batch = 0

    def _fetch(self, index: int):
        if not self.deterministic_augment:
            return self.dataset[index]
        from semseg_torch.data.transform import per_sample_rng

        with per_sample_rng(self.seed, self.sampler.epoch, int(index)):
            return self.dataset[index]

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        """Position the loader at ``epoch`` (DistributedSampler.set_epoch
        analog), optionally skipping the first ``start_batch`` batches —
        the fast-forward used for exact mid-epoch resume after preemption
        (indices are skipped without decoding; determinism is preserved
        because augmentation RNG is keyed per (seed, epoch, sample))."""
        self.sampler.set_epoch(epoch)
        self._start_batch = start_batch

    def __len__(self) -> int:
        n = len(self.sampler.indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self) -> Iterator[np.ndarray]:
        idx = self.sampler.indices()
        limit = (
            len(idx) - len(idx) % self.batch_size
            if self.drop_last
            else len(idx)
        )
        for start in range(
            self._start_batch * self.batch_size, limit, self.batch_size
        ):
            yield idx[start : start + self.batch_size]

    def __iter__(self):
        if self.num_workers <= 0:
            for batch_idx in self._batches():
                yield _stack_batch([self._fetch(i) for i in batch_idx])
            return

        out_q: "queue.Queue" = queue.Queue(maxsize=max(1, self.prefetch))
        stop = threading.Event()
        sentinel = object()

        def producer():
            with ThreadPoolExecutor(self.num_workers) as pool:
                try:
                    for batch_idx in self._batches():
                        if stop.is_set():
                            return
                        samples = list(pool.map(self._fetch, batch_idx))
                        out_q.put(_stack_batch(samples))
                except BaseException as exc:  # propagate to consumer
                    out_q.put(exc)
                    return
                out_q.put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # Drain so the producer can exit promptly.
            while True:
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=5)
