"""Host-side batch prefetch (the port's copy of the JAX package's
``data/prefetch.py``).

One background thread runs the host's batch assembly (numpy and the
``NativeCSR`` engine) ahead of the training loop, bounded by a small queue.
Device copies stay on the caller's thread; only the host work moves. Order
is kept exactly, so training is bit-identical with prefetch on or off.
The consumer's wait for each item, the end of the stream's included, is
the span ``gdmcf.prefetch.wait`` (``utils.profiling.span``).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

from gdmcf_torch.utils.profiling import span

T = TypeVar("T")

_SENTINEL = object()


def prefetched(it: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Iterate ``it`` on a daemon thread, keeping up to ``depth`` items
    ready. An exception of the producer re-raises at the consumer's next
    item. ``depth <= 0`` returns ``iter(it)`` unchanged.

    An abandoned consumer (an exception or a break mid-epoch, the
    generator collected) stops the producer: the generator's ``finally``
    sets a stop event that the producer polls while it puts, so no thread
    stays blocked holding assembled batches."""
    if depth <= 0:
        return iter(it)

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(item) -> bool:
        """put() that gives up when the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not _put(item):
                    return
        except BaseException as e:  # noqa: BLE001 (re-raised at the consumer)
            _put((_SENTINEL, e))
            return
        _put((_SENTINEL, None))

    def gen():
        # the producer starts at the first item, not at the call: a
        # generator never started has no frame, so its finally would never
        # run and an eagerly started thread would block forever holding up
        # to ``depth`` batches
        threading.Thread(target=worker, daemon=True).start()
        try:
            while True:
                with span("gdmcf.prefetch.wait"):
                    item = q.get()
                if isinstance(item, tuple) and len(item) == 2 \
                        and item[0] is _SENTINEL:
                    if item[1] is not None:
                        raise item[1]
                    return
                yield item
        finally:
            stop.set()

    return gen()
