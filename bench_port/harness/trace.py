"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
window's first ``traced_applications`` applications, reduced to the
kernels' intervals, the device's busy time, the kernel time by name, the
longest idle gaps by what the host was doing, and every K1/K2 launch's
iterations (read from the launch's grid-barrier counter once the trace
has stopped: no synchronisation inside the traced span)."""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Tuple

from . import roofline

# the __global__ functions of csrc/fused_helmholtz_cg.cu and fused_pressure_cg.cu
KERNEL_SYMBOLS = {"k1": "helmholtz_cg_kernel", "k2": "pressure_cg_kernel"}


@dataclasses.dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: List[Tuple[str, float, float]] = dataclasses.field(default_factory=list)
    kernel_s: Dict[str, float] = dataclasses.field(default_factory=dict)  # by K1/K2 id
    launches: Dict[str, list] = dataclasses.field(default_factory=dict)  # id -> [iters]
    shapes: Dict[str, dict] = dataclasses.field(default_factory=dict)
    device_ops: List[list] = dataclasses.field(default_factory=list)
    idle_gaps: List[list] = dataclasses.field(default_factory=list)


class Tracer:
    """Starts the profiler with the window, stops it after ``napps``
    applications; meanwhile keeps each K1/K2 launch's barrier counter."""

    def __init__(self, kernels: dict, napps: int, cuda: bool):
        self.kernels = {k: v for k, v in kernels.items() if v is not None}
        self.napps = int(napps)
        self.cuda = cuda
        self.prof = None
        self.t0 = self.t1 = 0.0
        self.stopped = False
        self._counters: Dict[str, list] = {k: [] for k in self.kernels}

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        for key, inst in self.kernels.items():  # an instance attribute over the method
            inst.solve = self._counting(key, inst)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def _counting(self, key, inst):
        solve = type(inst).solve.__get__(inst)

        def counted(*args):
            out = solve(*args)
            if inst._sync is not None and out.device.type == "cuda":
                self._counters[key].append((inst._sync, inst.grid))
            return out

        return counted

    def on_done(self, napps: int) -> None:
        if not self.stopped and napps >= self.napps:
            self.stop()

    def stop(self) -> None:
        if self.stopped or self.prof is None:
            return
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.stopped = True
        for inst in self.kernels.values():
            del inst.solve

    def reduce(self) -> Trace:
        import torch
        from torch.autograd import DeviceType

        self.stop()
        tr = Trace(window_s=self.t1 - self.t0)
        events = self.prof.events()
        dev = [e for e in events if e.device_type == DeviceType.CUDA]
        tr.kernels = [(e.name, e.time_range.start, e.time_range.end) for e in dev]
        tr.busy_s = roofline.busy_us([(s, e) for _, s, e in tr.kernels]) / 1e6
        by_name = collections.Counter()
        for name, s, e in tr.kernels:
            by_name[name] += (e - s) / 1e6
        tr.device_ops = [[n, s] for n, s in by_name.most_common(10)]
        for key, sym in KERNEL_SYMBOLS.items():
            if key in self.kernels:
                tr.kernel_s[key] = sum(s for n, s in by_name.items() if sym in n)
        for key, recs in self._counters.items():
            inst = self.kernels[key]
            per = 4 * inst.E
            tr.launches[key] = [roofline.iterations(
                int(sync[per:].view(torch.int32)[0]) // grid) for sync, grid in recs]
            tr.shapes[key] = kernel_shape(inst)
        tr.idle_gaps = self._idle_gaps(events, dev)
        return tr

    @staticmethod
    def _idle_gaps(events, dev) -> List[list]:
        """Idle gaps between merged kernel intervals, summed by the
        outermost host operation running when the gap opened."""
        if not dev:
            return []
        from torch.autograd import DeviceType

        iv = sorted((e.time_range.start, e.time_range.end) for e in dev)
        merged = [list(iv[0])]
        for s, e in iv[1:]:
            if s > merged[-1][1]:
                merged.append([s, e])
            else:
                merged[-1][1] = max(merged[-1][1], e)
        gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
        host = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                       if e.device_type == DeviceType.CPU and e.cpu_parent is None),
                      key=lambda t: t[0])
        starts = [h[0] for h in host]
        import bisect

        total = collections.Counter()
        for gs, ge in gaps:
            i = bisect.bisect_right(starts, gs) - 1
            name = host[i][2] if i >= 0 and host[i][1] >= gs else "(no host op)"
            total[name] += (ge - gs) / 1e6
        return [[n, s] for n, s in total.most_common(10)]


def kernel_shape(inst) -> dict:
    """The sizes the operations and bytes of a K1/K2 launch follow from:
    elements, nodes a direction, components, copies a node (and for K2 the
    coarse vertices and their slots)."""
    import numpy as np

    sem = inst.sem
    M = int(np.bincount(sem.gid_np).max())
    d = dict(E=int(inst.E), n=int(inst.n), M=M)
    if hasattr(inst, "C"):
        d["C"] = int(inst.C)
    else:
        d["nc"] = int(sem.pc_nc)
        d["MV"] = int(np.bincount(sem.pc_cid_np.reshape(-1)).max())
    return d
