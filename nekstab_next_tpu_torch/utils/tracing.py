"""Spans and counters of the port's layers, kept in memory.

Off by default; ``enable()`` turns tracing on for the whole process and
``disable()`` off again.  Off, :func:`span` returns one shared no-op
context (no allocation, no clock read).  On, each span records
``(id, parent, root, name, t0, t1)`` on ``time.perf_counter_ns()``; its
parent is the innermost span open in the process (one stack for every
thread: autograd runs a CUDA backward on its own thread while the caller
waits, and the solves of that backward belong to the caller's step), and
its root the outermost (an analysis: ``krylov.eigs``, ``krylov.svds``).
A span that an exception leaves is recorded too.  While a
``torch.profiler`` is recording, a span also opens
``torch.profiler.record_function(name)``, so it sits in the device trace
on the kernels' clock.

Counters: each CG kernel's iterations a launch (:class:`IterationLog`),
written by ``ops/fused_cg.py`` while tracing is on; named counts
(:func:`count`), such as the tangent steps that ``stepper/graphs.py``
replays from CUDA graphs, runs eagerly and captures (``graph.replayed``,
``graph.eager``, ``graph.captures``).

``take()`` returns what was recorded and clears it; nothing is written
anywhere else: the caller writes out what it reads.
"""

from __future__ import annotations

import collections
import functools
import itertools
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

# each kernel's log holds this many launches; more are counted, not kept
CAPACITY = 1 << 16

Span = collections.namedtuple("Span", "id parent root name t0 t1")


class Records(NamedTuple):
    spans: List[Span]  # in the order they closed
    iterations: Dict[str, List[int]]  # kernel -> CG iterations of each launch
    overflow: Dict[str, int]  # kernel -> launches a full log did not keep
    counters: Dict[str, int]  # name -> count (:func:`count`)


_on = False
_stack: list = []  # the open spans, innermost last
_spans: List[Span] = []
_logs: Dict[str, "IterationLog"] = {}
_counts: Dict[str, int] = collections.Counter()
_ids = itertools.count(1)


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("name", "id", "parent", "root", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        up = _stack[-1] if _stack else None
        self.id = next(_ids)
        self.parent, self.root = (up.id, up.root) if up else (0, self.id)
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        _stack.append(self)
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _stack.remove(self)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _spans.append(Span(self.id, self.parent, self.root, self.name, self.t0, t1))
        return False


def span(name: str):
    """A context recording one span of ``name`` while tracing is on."""
    return _Open(name) if _on else _OFF


def spanned(name: str):
    """Decorator: every call of the function is a span of ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


class IterationLog:
    """One kernel's CG iterations a launch.  A CUDA launch copies its
    grid-barrier counter into a preallocated device int32 buffer (one small
    copy, no host synchronisation) and the host keeps its grid and the
    barriers outside the iterations; a CPU solve records its count."""

    def __init__(self):
        self._buf: Optional[torch.Tensor] = None
        self._launches: list = []  # (grid, fixed barriers) of each launch
        self._solves: List[int] = []
        self.overflow = 0

    def _full(self) -> bool:
        if len(self._launches) + len(self._solves) < CAPACITY:
            return False
        self.overflow += 1
        return True

    def launch(self, counter: torch.Tensor, grid: int, fixed: int) -> None:
        """A launch of ``grid`` blocks whose barrier counter (int32, one a
        block and barrier) is ``counter``: ``fixed`` + 4 k barriers a block."""
        if self._full():
            return
        if self._buf is None or self._buf.device != counter.device:
            self._buf = torch.zeros(CAPACITY, dtype=torch.int32, device=counter.device)
        n = len(self._launches)
        self._buf[n:n + 1].copy_(counter)
        self._launches.append((grid, fixed))

    def solve(self, iters: int) -> None:
        if not self._full():
            self._solves.append(int(iters))

    def read(self) -> List[int]:
        """The iterations of every launch and solve (one device read), then
        an empty log."""
        totals = self._buf[:len(self._launches)].tolist() if self._launches else []
        its = [max((t // g - f) // 4, 0) for t, (g, f) in zip(totals, self._launches)]
        its += self._solves
        self._launches, self._solves, self.overflow = [], [], 0
        return its


def iteration_log(kernel: str) -> Optional[IterationLog]:
    """The log of ``kernel`` ('k1', 'k2') while tracing is on, else None."""
    return _logs.setdefault(kernel, IterationLog()) if _on else None


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _on:
        _counts[name] += n


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def take() -> Records:
    """Everything recorded since the last ``take``, then nothing."""
    spans = list(_spans)
    _spans.clear()
    overflow = {k: log.overflow for k, log in _logs.items()}
    counters = dict(_counts)
    _counts.clear()
    return Records(spans, {k: log.read() for k, log in _logs.items()}, overflow, counters)
