"""Host-side input-pipeline parallelism: thread-backed prefetch.

The port's own copy of ``multilingual_kws_tpu/data/pipeline.py`` (it imports
nothing of the JAX package). A single background thread assembles batches
into a bounded queue (double buffering by default) while the main thread
keeps the device busy. One producer thread keeps the dataset's host RNG draw
order, so prefetched runs are identical to synchronous ones. When
``AudioDataset.train_batches`` prefetches, the producer thread also copies
the batch to the device, so the upload overlaps the train step.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch(it: Iterator[T], size: int = 2) -> Iterator[T]:
    """Iterate `it` on a daemon thread, `size` items ahead.

    Exceptions raised by the producer re-raise at the consumer's next
    pull. Abandoning the returned generator (break / close) stops the
    producer promptly: the queue put uses a timeout and checks a stop
    event, so the thread never blocks forever on a full queue.
    """
    if size <= 0:
        yield from it
        return

    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()

    def producer():
        try:
            for item in it:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            item = _SENTINEL
        except BaseException as e:  # propagate to consumer
            item = _Failure(e)
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, _Failure):
                raise item.exc
            yield item
    finally:
        stop.set()
