"""Host-side pipeline parallelism.

The reference decouples reader / mappers / writer with two bounded ring
buffers and pthreads (src/input_queue.c, src/output_queue.c,
src/FEM_map.c:174-198). Here the same three-stage overlap is:

  parse thread -> bounded queue -> [device dispatch N+1 || host emit N] -> writer

`ThreadedBatchSource` is the input_queue equivalent (bounded, EOF-signaled);
`MappingEngine.map_stream` keeps one batch in flight on the device while
the host drains the previous batch's hits (double buffering).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_EOF = object()


class ThreadedBatchSource:
    """Runs an iterator on a background thread into a bounded queue
    (capacity default 4 batches ~ the reference's 100-slot ring scaled to
    our much larger batches)."""

    def __init__(self, it: Iterable[T], capacity: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=capacity)
        self._exc: BaseException | None = None
        self._thread = threading.Thread(target=self._run, args=(iter(it),), daemon=True)
        self._thread.start()

    def _run(self, it: Iterator[T]) -> None:
        try:
            for item in it:
                self._q.put(item)
        except BaseException as exc:  # propagate parse errors to consumer
            self._exc = exc
        finally:
            self._q.put(_EOF)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is _EOF:
                if self._exc is not None:
                    raise self._exc
                return
            yield item
