"""Background batch prefetching (a copy of
``fastspeech2_tpu/data/prefetch.py``).

A small thread pipelines host-side loading/collation and the host->device
copy behind the device step, so the card does not wait on numpy work.
"""

import queue
import threading


class PrefetchIterator:
    """Wrap a batch iterator; keep up to `depth` prepared batches ahead."""

    _END = object()

    def __init__(self, iterator, depth=2, transform=None):
        self._queue = queue.Queue(maxsize=depth)
        self._transform = transform
        self._error = None

        def worker():
            try:
                for item in iterator:
                    if self._transform is not None:
                        item = self._transform(item)
                    self._queue.put(item)
            except BaseException as e:  # surfaced on next()
                self._error = e
            finally:
                self._queue.put(self._END)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._END:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item
