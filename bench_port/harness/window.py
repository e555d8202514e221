"""The measured window: the traffic's loop (``loops/<loop>.py``), driven
through the program's public entries until ``seconds`` have passed, with
the benchmark's own spans around every propagator application.

Every application goes through :class:`Recorder`: it synchronises the
device on entry and on exit (so an application's span holds its device
work, and the span between two applications the Krylov layer's), keeps a
copy of its input and output for the correctness check, and ends the
window by raising :class:`WindowClosed` at the first application that
would start after the deadline.  An analysis that ends before the window
closes is followed by the next one, from the next start vector.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, List, Optional

import torch


class WindowClosed(Exception):
    """Raised inside the loop at the first application due after the
    window's end."""


@dataclasses.dataclass
class Application:
    analysis: int  # which analysis of the window
    index: int  # its place in that analysis
    direction: str  # 'matvec' or 'rmatvec'
    x: torch.Tensor
    y: Optional[torch.Tensor]
    t0: float
    t1: float
    cpu: float = 0.0  # the process's CPU seconds over the span
    steal: float = 0.0  # seconds the hypervisor took from the machine's CPUs over the span


def _steal_s() -> float:
    """The machine's stolen CPU time so far (the ``steal`` column of
    ``/proc/stat``, in seconds), or 0 where it cannot be read."""
    try:
        with open("/proc/stat") as f:
            return int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return 0.0


class Recorder:
    def __init__(self, sync: Callable[[], None], seconds: float,
                 on_done: Optional[Callable[[int], None]] = None):
        self.sync = sync
        self.seconds = float(seconds)
        self.on_done = on_done  # called with the count of completed applications
        self.apps: List[Application] = []
        self.pending: Optional[Application] = None  # the input that met the deadline
        # (index of the application after it, seconds): the Krylov layer's
        # time between two applications of one analysis
        self.gaps: List[tuple] = []
        self.analysis = 0
        self.index = 0
        self.t_start = self.t_end = self.deadline = 0.0

    def start(self) -> None:
        self.sync()
        self.t_start = time.perf_counter()
        self.deadline = self.t_start + self.seconds

    def new_analysis(self) -> None:
        self.analysis += 1
        self.index = 0

    def wrap(self, direction: str, fn: Callable) -> Callable:
        def apply(x):
            self.sync()
            t0, c0, s0 = time.perf_counter(), time.process_time(), _steal_s()
            if self.index and self.apps and self.apps[-1].analysis == self.analysis:
                self.gaps.append((len(self.apps), t0 - self.apps[-1].t1))
            if t0 >= self.deadline:
                self.t_end = t0
                self.pending = Application(self.analysis, self.index, direction,
                                           x.detach().clone(), None, t0, t0)
                raise WindowClosed
            y = fn(x)
            self.sync()
            t1 = time.perf_counter()
            self.apps.append(Application(self.analysis, self.index, direction,
                                         x.detach().clone(), y.detach().clone(), t0, t1,
                                         time.process_time() - c0, _steal_s() - s0))
            self.index += 1
            if self.on_done is not None:
                self.on_done(len(self.apps))
            return y

        return apply

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start


def drive(loop, traffic: dict, krylov: dict, op, space,
          start_vector: Callable[[int], torch.Tensor], rec: Recorder,
          control: bool = False) -> None:
    """One analysis after another, analysis i from ``start_vector(i)``,
    each by the traffic's loop module (``loops/<loop>.py``), until the
    window closes."""
    rec.start()
    i = 0
    try:
        while True:
            loop.analysis(traffic, krylov, op, space, start_vector(i), rec, control)
            i += 1
            rec.new_analysis()
    except WindowClosed:
        pass
