"""Batch iteration: shuffled epochs over map-style datasets, or epoch-less
streaming, yielding padded `GraphBatch`es (counterpart of
`jamun_tpu/data/datamodule.py`).

Batches are grouped by node bucket, so an epoch has a few distinct shapes.
A background thread collates the next `prefetch` batches (in page-locked
host memory where a card is present, `data/batching.collate`) while the
caller trains on the current one.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np

from jamun_tpu_torch.data.batching import BucketSpec, collate
from jamun_tpu_torch.data.datasets import StreamingRandomChainDataset
from jamun_tpu_torch.ops.graph import GraphBatch

__all__ = ["DataModule"]


def _prefetched(it: Iterator[GraphBatch], depth: int) -> Iterator[GraphBatch]:
    """`it`, run `depth` batches ahead in a daemon thread. An error in the
    thread is raised to the consumer; a consumer that stops early (closes or
    drops the generator) stops the thread."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    return
        except BaseException as e:  # handed to the consumer, which raises it
            put(e)
            return
        put(end)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


@dataclasses.dataclass
class DataModule:
    datasets: Sequence  # train datasets (map-style or iterable)
    val_datasets: Sequence = ()
    batch_size: int = 32
    shuffle: bool = True
    bucket_spec: BucketSpec = dataclasses.field(default_factory=BucketSpec)
    seed: int = 0
    streaming: bool = False
    stream_weights: Optional[Sequence[float]] = None  # per-dataset interleave weights
    prefetch: int = 2  # background-thread prefetch depth (0 = synchronous)

    def _index(self, datasets) -> List:
        idx = []
        for d_i, ds in enumerate(datasets):
            for f_i in range(len(ds)):
                idx.append((d_i, f_i))
        return idx

    def _iter_batches(self, datasets, shuffle: bool, seed: int) -> Iterator[GraphBatch]:
        if self.streaming:
            stream = iter(
                StreamingRandomChainDataset(datasets, weights=self.stream_weights, seed=seed)
            )
            while True:
                items = [next(stream) for _ in range(self.batch_size)]
                yield collate(items, self.bucket_spec, num_graphs=self.batch_size)

        index = self._index(datasets)
        if shuffle:
            rng = np.random.default_rng(seed)
            rng.shuffle(index)
        # group into batches of the same node bucket, so that an epoch has few shapes
        buckets: dict = {}
        for d_i, f_i in index:
            ds = datasets[d_i]
            b = self.bucket_spec.node_bucket(ds.template.num_atoms)
            buckets.setdefault(b, []).append((d_i, f_i))
            if len(buckets[b]) == self.batch_size:
                items = [datasets[d][f] for d, f in buckets.pop(b)]
                yield collate(items, self.bucket_spec, num_graphs=self.batch_size)
        for b, rest in buckets.items():
            items = [datasets[d][f] for d, f in rest]
            yield collate(items, self.bucket_spec, num_graphs=self.batch_size)

    def train_batches(self, epoch: int = 0) -> Iterator[GraphBatch]:
        it = self._iter_batches(self.datasets, self.shuffle and not self.streaming, self.seed + epoch)
        return _prefetched(it, self.prefetch) if self.prefetch > 0 else it

    def val_batches(self) -> Iterator[GraphBatch]:
        ds = self.val_datasets or self.datasets
        return self._iter_batches(ds, shuffle=False, seed=self.seed)

    def num_train_frames(self) -> Optional[int]:
        if self.streaming:
            return None
        return sum(len(d) for d in self.datasets)
