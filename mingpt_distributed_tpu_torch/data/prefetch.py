"""Background batch prefetching: one daemon thread with a bounded queue
assembles batch N+k on the host while the card runs batch N.

Counterpart of ``mingpt_distributed_tpu/data/prefetch.py``.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional


class PrefetchIterator:
    """Wrap a batch iterator with a depth-bounded background prefetch
    thread. Exceptions of the source re-raise on the consumer's side."""

    _DONE = object()

    def __init__(self, source: Iterator, depth: int = 2):
        self._source = source
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Put unless stopped; False once a close() asked to stop."""
        while not self._stopped.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        try:
            for item in self._source:
                if not self._put(item):
                    return
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            # deliver the end marker, or the consumer blocks forever
            self._put(self._DONE)

    def close(self) -> None:
        """Stop and join the producer thread. Call before touching state the
        source also mutates (the batch iterator's position): the producer
        runs ahead of consumption."""
        self._stopped.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10.0)
        if self._thread.is_alive():
            raise RuntimeError(
                "prefetch producer thread failed to stop within 10s "
                "(source iterator blocked?)")

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
