"""Prefetching host loader: keeps the card fed.

The port's copy of ``spalign_tpu/data/loader.py`` (numpy and threads
only; for the same seed it yields the same batches in the same order).
It replaces the reference's MultithreadIterator + forkserver machinery
(train_segnet.py:195-200): a thread pool decodes/augments examples ahead
of the training step, with a bounded queue of assembled batches.  Under
data parallelism every rank draws the same global-batch order from the
same seed and loads only its own rows of each batch."""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

import numpy as np

from spalign_tpu_torch.parallel.dist import rank_slice
from spalign_tpu_torch.utils.timers import count, span


class PrefetchLoader:
    """Iterate (images, labels) batches with background prefetch.

    Args:
      dataset: indexable returning (img, label) host arrays.
      batch_size: GLOBAL batch size.
      shuffle: reshuffle indices every epoch (seeded).
      num_workers: decode threads.
      prefetch: max batches queued ahead.
      epochs: None = loop forever (training); 1 = one pass (eval).
      drop_last: drop the ragged final batch (training keeps one
        batch shape).
      rank, world: yield rows [rank*B/world, (rank+1)*B/world) of each
        global batch (``parallel/dist.py::rank_slice``).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 8, prefetch: int = 4,
                 epochs: Optional[int] = None, seed: int = 0,
                 drop_last: bool = True,
                 indices: Optional[Sequence[int]] = None,
                 rank: int = 0, world: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.epochs = epochs
        self.seed = seed
        self.drop_last = drop_last
        self.rank, self.world = rank, world
        self.indices = (np.arange(len(dataset)) if indices is None
                        else np.asarray(indices))

    def _batches(self) -> Iterator[np.ndarray]:
        rng = np.random.RandomState(self.seed)
        epoch = 0
        while self.epochs is None or epoch < self.epochs:
            idx = self.indices.copy()
            if self.shuffle:
                rng.shuffle(idx)
            end = len(idx) - (len(idx) % self.batch_size
                              if self.drop_last else 0)
            for i in range(0, end, self.batch_size):
                yield rank_slice(idx[i: i + self.batch_size], self.rank,
                                 self.world)
            epoch += 1

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx in self._batches():
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__,
                                              batch_idx))
                        imgs = np.stack([it[0] for it in items])
                        labels = (np.stack([it[1] for it in items])
                                  if items[0][1] is not None else None)
                        q.put((imgs, labels))
            except RuntimeError:
                # interpreter/executor shutdown race during teardown
                import sys

                if not (stop.is_set() or sys.is_finalizing()):
                    raise
            finally:
                # ensure the consumer always sees the end sentinel, even
                # if the queue is full at teardown
                while True:
                    try:
                        q.put_nowait(None)
                        break
                    except queue.Full:
                        try:
                            q.get_nowait()
                        except queue.Empty:
                            pass

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                count("loader.takes")
                count("loader.ready", q.qsize())  # batches waiting
                with span("train.loader_wait"):
                    item = q.get()
                if item is None:
                    break
                yield item
        finally:
            stop.set()
            # drain so the producer can exit
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
