"""Caches of device tensors that a captured CUDA graph may read.

A CUDA graph reads every tensor outside its own memory pool by the address
that tensor had at capture: the resize matrices (ops/resize.py) and the
SW-MSA region ids and masks (ops/window.py) among them. A cache eviction or
`cache_clear()` would free memory that a later replay still reads.

`device_cache(maxsize)` is functools.lru_cache for the builders of such
tensors. Inside `retained()` every value such a cache returns, hit or miss,
is also appended to the list the context yields, so the code that captures
a graph (pipeline.make_infer_fn) holds a reference to each of them for as
long as it keeps the graph.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, List

_active: List[list] = []


def device_cache(maxsize):
    """functools.lru_cache(maxsize) whose returned values are also handed to
    every active `retained()` list; cache_clear and cache_info pass through."""
    def wrap(fn: Callable) -> Callable:
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def lookup(*args, **kw):
            value = cached(*args, **kw)
            for held in tuple(_active):
                held.append(value)
            return value

        lookup.cache_clear = cached.cache_clear
        lookup.cache_info = cached.cache_info
        return lookup
    return wrap


@contextlib.contextmanager
def retained():
    """Collect every value a `device_cache` returns while inside."""
    held: list = []
    _active.append(held)
    try:
        yield held
    finally:
        _active.remove(held)
