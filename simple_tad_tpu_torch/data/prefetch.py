"""Batches made on host threads and handed over in order.

The loaders of the JAX package (train/engine.py:TrainLoader,
data/pretrain_datasets.py:PretrainLoader) share one queue among their
decode threads, so with more than one thread the batches come in the order
the threads finish them.  The port's loaders hand them over in the order
of the epoch instead: thread i makes batches i, i + n, i + 2n, ... into a
queue of its own, and batch k is read from thread k mod n's queue.  A
data-parallel run needs this: every rank's k-th batch must be its rows of
the same global batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Sequence


def ordered_batches(rows: Sequence, make: Callable, num_threads: int,
                    prefetch: int) -> Iterator:
    """``make(row)`` for each of ``rows``, in order, on ``num_threads``
    threads with about ``prefetch`` batches made ahead; a thread's
    exception is raised here."""
    n = max(1, min(int(num_threads), len(rows)))
    queues = [queue.Queue(maxsize=max(1, prefetch // n)) for _ in range(n)]
    stop = threading.Event()

    def worker(i):
        try:
            for row in rows[i::n]:
                if stop.is_set():
                    return
                queues[i].put(make(row))
        except BaseException as e:  # noqa: BLE001
            # surface the failure; a silent death would leave the consumer
            # blocked on its queue forever
            queues[i].put(e)

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    try:
        for k in range(len(rows)):
            item = queues[k % n].get()
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        for q in queues:
            while not q.empty():
                q.get_nowait()
