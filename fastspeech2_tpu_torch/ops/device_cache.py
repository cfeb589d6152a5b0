"""Constants made once on a device and cached: the position tables, the
iSTFT's bases and window-sum-square, MelGAN's scalars.

A copy from the host in every forward would make the host wait for the
card, and cannot be captured in a CUDA graph, so each such constant is
made once and handed out again.  A captured graph reads it by its address
at every replay, long after the capture, so the graph must own it: a
cache that evicts the tensor would free memory the graph goes on reading.
Inside :func:`keep_read`, every constant handed out is added to the list
it yields, which the graph then keeps (``synthesis/graphs.py``); an
eviction from the cache drops only the cache's reference.
"""

import contextlib
import functools

# one list per open keep_read(): the constants handed out meanwhile
_readers = []


def cached_constant(maxsize):
    """``functools.lru_cache(maxsize)`` for a function that returns a
    device tensor, which also reports the tensor to every open
    :func:`keep_read`."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def get(*args):
            value = cached(*args)
            for read in _readers:
                read.append(value)
            return value

        get.cache_clear = cached.cache_clear
        get.cache_info = cached.cache_info
        return get
    return wrap


@contextlib.contextmanager
def keep_read():
    """Yield a list that collects every cached constant handed out until
    the block ends (from any thread: a constant kept too many is harmless)."""
    read = []
    _readers.append(read)
    try:
        yield read
    finally:
        _readers.remove(read)
