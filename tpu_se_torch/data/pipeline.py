"""Background prefetch: the reference's producer thread + double buffer
(``BPtrain.cc:15-54``), as a copy of ``tpu_se/data/pipeline.py``'s
``PrefetchIterator``.  numpy releases the GIL for the heavy read and
normalize work, so the overlap with the training loop is real.
``shard_for_host`` is the same module's split of a work list over the
ranks of a data-parallel run.
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


def shard_for_host(n_items: int, process_index: int, process_count: int
                   ) -> slice:
    """Contiguous per-rank shard of a global work list, as
    ``tpu_se.data.pipeline.shard_for_host`` cuts it: the first
    ``n_items % process_count`` ranks take one item more.

    Data-parallel input: each rank reads only its slice of the rows from
    storage; the collectives see the global bunch.
    """
    per = n_items // process_count
    extra = n_items % process_count
    lo = process_index * per + min(process_index, extra)
    hi = lo + per + (1 if process_index < extra else 0)
    return slice(lo, hi)
