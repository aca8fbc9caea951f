"""Capturing a program as a CUDA graph, the way every replayed path of the
port does it (training bunches, the CV pass, the decoder, the streaming
step).

- ``capture`` runs the program once eagerly on a side stream (which builds
  the cuBLAS handles, the cuFFT plans and, under a mesh, the NCCL
  communicators, none of which a capture can), then captures it on that
  stream in the ``thread_local`` mode: only the capturing thread's calls
  are checked, so another thread of the process (the process group's
  watchdog, a prefetch thread) cannot invalidate the capture.  A program
  that fails under capture raises its own error, not the one that ending
  an invalidated capture adds to it.  Unlike ``torch.cuda.graph``, no
  synchronise and no ``empty_cache`` precede the capture.
- A capture launches and sends nothing, so what it added to the launch
  counters and to ``Mesh.traffic`` is taken back (``read_counts`` /
  ``add_counts``) and each replay adds it once.
- ``Releasable.release`` destroys a captured graph whose collectives'
  process group is going (``parallel/distributed.py:release_on_shutdown``).
- ``replays`` is where a program replays at all: on a card, without a mesh
  or under an NCCL one.  gloo's collectives run on the host and cannot be
  captured, so gloo, the CPU and ``graph=False`` run the same programs
  eagerly.
"""

from __future__ import annotations

import contextlib

import torch


def replays(device: torch.device, mesh) -> bool:
    """Whether a program on ``device`` under ``mesh`` (or None) replays a
    captured graph: on a card, without a mesh or under an NCCL one."""
    return device.type == "cuda" and (mesh is None or mesh.backend == "nccl")


def read_counts(kernels: tuple, traffic: dict | None) -> tuple[int, ...]:
    """The counters a program advances, as one tuple: each ``(module,
    name)`` of ``kernels``, then ``traffic``'s (``Mesh.traffic``, or None
    without a mesh) calls and bytes per axis and op, in its order."""
    return (*(getattr(module, name) for module, name in kernels),
            *(n for ops in (traffic or {}).values()
              for entry in ops.values() for n in entry))


def add_counts(kernels: tuple, traffic: dict | None, delta: tuple,
               times: int = 1) -> None:
    """Add ``times`` x ``delta`` (ordered as ``read_counts``) to the
    counters: ``times=-1`` takes a capture's counts back, ``times=n`` adds
    n replays'."""
    values = iter(delta)
    for (module, name), d in zip(kernels, values):
        setattr(module, name, getattr(module, name) + times * d)
    for ops in (traffic or {}).values():
        for entry in ops.values():
            for i in range(len(entry)):
                entry[i] += times * next(values)


def capture(body, stream: torch.cuda.Stream, warm=None, pool=None,
            graph: torch.cuda.CUDAGraph | None = None,
            counts: tuple | None = None):
    """Run ``warm()`` (``body()`` by default) eagerly on ``stream``, then
    capture ``body()`` there into ``graph`` (a new one by default), its
    memory drawn from ``pool`` (a new private pool by default) -> (the
    graph, ``warm``'s result, ``body``'s captured result, what one replay
    adds to ``counts``).

    ``stream`` first waits for the current stream's work, and the current
    stream waits for ``stream`` at the end.  ``counts`` is ``(kernels,
    traffic)`` as ``read_counts`` takes them: what the capture added is
    taken back, also when it fails.  Runs with the caller's card current."""
    current = torch.cuda.current_stream()
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        warmed = (warm or body)()
    graph = torch.cuda.CUDAGraph() if graph is None else graph
    before = read_counts(*counts) if counts else ()
    moved = ()
    try:
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = body()
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()
    finally:
        if counts:
            moved = tuple(b - a for a, b in zip(before, read_counts(*counts)))
            add_counts(*counts, moved, -1)
    current.wait_stream(stream)
    return graph, warmed, out, moved


class Releasable:
    """A captured graph held with its ``graph``, the ``stream`` it was
    captured on and its ``key`` (None once released)."""

    def release(self) -> None:
        """Destroy the captured graph (its collectives' process group is
        going: ``shutdown_distributed``); its owner captures anew if it
        runs again."""
        torch.cuda.synchronize(self.stream.device)
        self.graph.reset()
        self.key = None
