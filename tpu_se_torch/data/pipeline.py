"""Background prefetch: the reference's producer thread + double buffer
(``BPtrain.cc:15-54``), as a copy of ``tpu_se/data/pipeline.py``'s
``PrefetchIterator``.  numpy releases the GIL for the heavy read and
normalize work, so the overlap with the training loop is real.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


class PrefetchIterator(Iterator[T]):
    """Iterate ``producers`` on a background thread, ``depth`` items ahead.

    An exception raised by the producer is re-raised on the consumer side
    when the iterator reaches it.
    """

    def __init__(self, producers: Iterable[Callable[[], T]] | Iterator[T],
                 depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._thread = threading.Thread(
            target=self._run, args=(iter(producers),), daemon=True)
        self._thread.start()

    def _run(self, it) -> None:
        try:
            for item in it:
                self._q.put(item() if callable(item) else item)
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            self._q.put(_SENTINEL)

    def __iter__(self):
        return self

    def __next__(self) -> T:
        item = self._q.get()
        if item is _SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
