"""Host-IO overlap utilities for the inference CLIs (the JAX package's
``renderformer_tpu/utils/prefetch.py``).

A prefetch thread feeds a bounded queue (H5 + gzip decode release the
GIL) and a small writer pool encodes batch i-1's EXR/PNG while the device
renders batch i, as the reference overlaps H5 loading with the GPU through
DataLoader workers.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, List


def prefetch(iterable: Iterable, depth: int = 2) -> Iterator:
    """Iterate ``iterable`` on a background thread, ``depth`` items ahead.

    Exceptions raised by the source propagate to the consumer at the
    point of the failing item.
    """
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    _END = object()

    def worker():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 - reraised on the consumer
            q.put((_END, e))
            return
        q.put((_END, None))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if isinstance(item, tuple) and len(item) == 2 and item[0] is _END:
            if item[1] is not None:
                raise item[1]
            return
        yield item


class AsyncWriter:
    """Bounded thread pool for image writes; ``drain()`` re-raises the
    first failure so IO errors aren't silently dropped."""

    def __init__(self, max_workers: int = 2, max_pending: int = 32):
        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        self._sem = threading.Semaphore(max_pending)
        self._futures: List = []

    def submit(self, fn: Callable, *args, **kwargs):
        self._sem.acquire()
        fut = self._pool.submit(fn, *args, **kwargs)
        fut.add_done_callback(lambda _: self._sem.release())
        self._futures.append(fut)
        return fut

    def drain(self):
        """Wait for all pending writes; raise the first error."""
        for fut in self._futures:
            fut.result()
        self._futures.clear()

    def close(self):
        self.drain()
        self._pool.shutdown(wait=True)
