"""Named spans at the layer boundaries of the train step and the predict
call, recorded only while a ``torch.profiler`` is active.

``span(name)`` is a context manager.  With no profiler active it is one
shared null context: the cost is one read of the profiler's flag, and
nothing is recorded.  With a profiler active it enters
``torch.profiler.record_function(name)``, so the profiler's trace shows
the span on the timeline of the kernels, and appends ``(name, start_ns,
end_ns, depth)`` to a bounded store: unix nanoseconds
(``time.time_ns()``, the profiler's own host clock), read outside the
``record_function``'s enter and exit so that the record encloses the
exported event; ``depth`` counts the recorded spans open around it.

A span's layer is the part of its name before the dot (``harness``,
``step``, ``embedding``, ``model``).  There is no switch: tracing is on
exactly while a profiler is.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import List, Tuple

import torch
from torch.autograd import profiler as _profiler

BOUND = 65536

_store: collections.deque = collections.deque(maxlen=BOUND)
_NULL = contextlib.nullcontext()
_open = 0


class _Span:
    __slots__ = ("name", "depth", "start", "record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _open
        self.depth = _open
        _open += 1
        self.start = time.time_ns()
        self.record = torch.profiler.record_function(self.name)
        self.record.__enter__()
        return self

    def __exit__(self, *exc):
        global _open
        self.record.__exit__(*exc)
        _store.append((self.name, self.start, time.time_ns(), self.depth))
        _open -= 1
        return False


def span(name: str):
    """A recorded span while a profiler is active, else the null context."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def recorded() -> List[Tuple[str, int, int, int]]:
    """A copy of the store, oldest first (at most ``BOUND`` records)."""
    return list(_store)


def clear() -> None:
    _store.clear()
