"""Asynchronous host-side input pipeline (mirrors
``ufvideo_tpu/train/prefetch.py``).

A thread pool decodes and collates ahead of the step loop
(``PrefetchLoader``), and ``device_prefetch`` keeps a few batches in flight
to the card: ``to_device`` copies a collated batch through pinned host
memory with non-blocking copies, so the copy of batch n + 1 overlaps the
step on batch n.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch


class PrefetchLoader:
    """Background-thread batch producer.

    worker_fn(index) must be thread-safe (our dataset decode path is pure
    numpy/cv2 which releases the GIL during the heavy work).
    """

    def __init__(
        self,
        sample_indices: Sequence[int],
        load_fn: Callable[[int], Any],
        collate_fn: Callable[[List[Any]], Any],
        batch_size: int,
        num_workers: int = 2,
        prefetch_batches: int = 2,
    ):
        self.indices = list(sample_indices)
        self.load_fn = load_fn
        self.collate_fn = collate_fn
        self.batch_size = batch_size
        self.num_workers = max(num_workers, 1)
        self.prefetch_batches = prefetch_batches
        # per-iteration state: each __iter__ gets its OWN queue + stop flag
        # so a broken-off epoch's producer can never interleave stale
        # batches (or its end sentinel) into the next iteration
        self._stop = threading.Event()
        self._q: Optional["queue.Queue"] = None
        self._thread: Optional[threading.Thread] = None

    def __len__(self) -> int:
        return len(self.indices) // self.batch_size

    def _produce(self, q: "queue.Queue", stop: threading.Event) -> None:
        from concurrent.futures import ThreadPoolExecutor

        def put(item) -> bool:
            # bounded put that keeps observing the stop flag: a plain
            # blocking put() can never be interrupted once the consumer is
            # gone, pinning decoded batches + the pool forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            with ThreadPoolExecutor(self.num_workers) as pool:
                batch_idx = [
                    self.indices[i : i + self.batch_size]
                    for i in range(0, len(self.indices), self.batch_size)
                ]
                for idxs in batch_idx:
                    if len(idxs) < self.batch_size or stop.is_set():
                        break
                    samples = list(pool.map(self.load_fn, idxs))
                    if not put(self.collate_fn(samples)):
                        return
        except BaseException as e:  # surface worker failures to the consumer
            put(e)
            return
        put(None)

    def __iter__(self) -> Iterator[Any]:
        self.close()  # stop any previous iteration's producer
        self._stop = threading.Event()
        self._q = queue.Queue(maxsize=self.prefetch_batches)
        self._thread = threading.Thread(
            target=self._produce, args=(self._q, self._stop), daemon=True
        )
        self._thread.start()
        while True:
            item = self._q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item

    def close(self) -> None:
        """Stop the producer (unblocks a full-queue put) and join it."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def device_prefetch(batches: Iterable, to_device: Callable, depth: int = 2):
    """Keep ``depth`` batches in flight on device ahead of consumption."""
    import collections

    buf = collections.deque()
    it = iter(batches)
    try:
        for _ in range(depth):
            buf.append(to_device(next(it)))
    except StopIteration:
        pass
    while buf:
        out = buf.popleft()
        try:
            buf.append(to_device(next(it)))
        except StopIteration:
            pass
        yield out


def to_device(batch: dict, device, batch_cls=None):
    """A collated batch (numpy arrays by field) → tensors on ``device``:
    pinned host copies and non-blocking transfers on a CUDA device. With
    ``batch_cls`` (``Batch`` / ``SegBatch``) the fields it names become one
    of those; else ``SegBatch`` when the batch has a SAM branch, ``Batch``
    when not."""
    from .seg_step import SegBatch
    from .train_step import Batch

    device = torch.device(device)
    cuda = device.type == "cuda"

    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if cuda:
            t = t.pin_memory()
        return t.to(device, non_blocking=cuda)

    cls = batch_cls or (SegBatch if "images_sam" in batch else Batch)
    return cls(**{k: put(batch[k]) for k in cls._fields if k in batch})
