"""Bounded, order-preserving parallel read-ahead.

Copy of ``tpu_se/io/readahead.py``.  The reference's dataset packers fork
across scp shards (``tools_pfile/pfile_noisy.pl:28-36``); here one
in-order consumer takes the items while their reads run ahead on a thread
pool (file reads and numpy decoding release the GIL).  The window keeps
memory at O(jobs) items whatever the corpus size.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
R = TypeVar("R")


def ordered_readahead(items: Iterable[T], fn: Callable[[T], R],
                      jobs: int) -> Iterator[R]:
    """Yield ``fn(item)`` in input order with up to ``2*jobs`` items being
    read ahead concurrently.  ``jobs <= 1`` is a plain map; an exception
    from ``fn`` is raised where its item would have been yielded."""
    items = list(items)
    if jobs <= 1:
        for it in items:
            yield fn(it)
        return
    with ThreadPoolExecutor(max_workers=jobs) as pool:
        window = 2 * jobs
        pending: dict[int, object] = {}
        try:
            for i in range(len(items)):
                for j in range(i, min(i + window, len(items))):
                    if j not in pending:
                        pending[j] = pool.submit(fn, items[j])
                yield pending.pop(i).result()
        finally:
            for fut in pending.values():
                fut.cancel()
