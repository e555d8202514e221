"""Piecewise CUDA-graph replay of the tangent step about a frozen base.

About a frozen base (``stepper/linearized.py`` :class:`TangentSteps`) every
step of one BDF stage runs the same operations on the same shapes; only the
fields change.  So the step of each stage is captured once as CUDA graphs
and every step replays them, which takes the host's dispatch of some 480
enqueues a step off the device's path.

The fused inner solves (K1, K2: ``ops/fused_cg.py``) are not captured.
Each is a hole between two graph segments: at every replay it is called
eagerly through the kernel instance's ``solve``, looked up at the call, so
its launch counter, grid-barrier buffer and iteration log behave as on the
eager path and a wrapper on ``solve`` sees every launch.  On the fused-IR
route a step is five segments around four holes (explicit term and velocity
right-hand side | K1 | refinement residual | K1 | velocity update and
pressure right-hand side | K2 | residual | K2 | projection and packing); on
the f32 ``fused_solves`` route three segments around two.

Capture (:meth:`StepGraphs._capture`), at the first graphed application of
an operator, for each stage it needs: one eager dry run of a step on
throwaway fields first (each hole returns zeros), which loads every kernel
and the side stream's library workspaces outside a capture; then, on that
side stream, the step on the static field buffers with each hole ending one
graph and beginning the next, the stage's graphs sharing one memory pool.
A hole launches nothing during the capture: it keeps the right-hand side
its segment computed and sets out the placeholder the next segment reads.
The last segment writes the new fields back into the static buffers.

Replay (:meth:`StepGraphs.integrate`): the input is copied into the static
buffers, each step replays its stage's segments in turn and solves each
hole into its placeholder, and the output is read from the buffers.

The graphs engage where :func:`graph_refusal` finds no reason against them;
everywhere else the eager steps run unchanged.  :class:`StepGraphs` counts
the steps it replayed (``replayed``), the steps its operator ran eagerly
(``eager``: refused ``integrate`` calls and transposes) and its stage
captures (``captures``); while tracing is on the same counts go to
``utils/tracing.py`` (``graph.replayed``, ``graph.eager``,
``graph.captures``).  Spans: ``step`` around each replayed step, inside it
``step.graph`` around each segment's replay and ``solve.inner`` around each
hole's solve; ``step.capture`` around a capture.
"""

from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from ..utils import tracing


def graph_refusal(steps, forcing: Optional[Callable] = None,
                  q: Optional[torch.Tensor] = None) -> Optional[str]:
    """Why ``steps.integrate(q, n, forcing)`` cannot replay CUDA graphs, or
    None where it can: a frozen base on a single-device SEM on CUDA, a
    stepper with no scalar block and no forcing or buoyancy hook, every
    solve of the step a K1/K2 launch (the fused-IR route or the f32
    ``fused_solves`` route), no per-step forcing and no autograd."""
    ns, s = steps.ns, steps.sem
    if s.sharded:
        return "shard view"
    if not steps.frozen:
        return "orbit base"
    if ns.nscal:
        return "scalar block"
    if ns.forcing is not None:
        return "forcing hook"
    if ns.buoyancy is not None:
        return "buoyancy hook"
    if ns.mixed is not None:
        return "legacy mixed path"
    if ns.fused_v is None or ns.fused_p is None:
        return "plain solves"
    if s.device.type != "cuda":
        return "not on CUDA"
    if forcing is not None:
        return "per-step forcing"
    if torch.is_grad_enabled() and (
            steps.bases.requires_grad or (q is not None and q.requires_grad)):
        return "autograd"
    return None


class _Hole(NamedTuple):
    kernel: str  # the NavierStokes attribute of the kernel instance
    rhs: torch.Tensor  # the right-hand side its segment computes
    args: tuple  # the solve's other arguments (K1: nu, h2)
    out: torch.Tensor  # the placeholder the next segment reads


class _Stage(NamedTuple):
    segments: List["torch.cuda.CUDAGraph"]
    holes: List[_Hole]  # holes[i] lies between segments[i] and segments[i + 1]


@functools.cache
def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    """The stream captures run on, one a device for the process."""
    return torch.cuda.Stream(device)


class StepGraphs:
    """The CUDA graphs of one :class:`TangentSteps`' stages, their static
    fields, and the counts of its steps by how they ran.  It holds no
    reference to the steps (the caller passes them), so an operator and
    its graphs are freed together, without a reference cycle."""

    def __init__(self):
        self.replayed = 0  # steps replayed from graphs
        self.eager = 0  # steps run eagerly
        self.captures = 0  # BDF stages captured
        self.refusal: Optional[str] = None  # graph_refusal's last answer
        self._fields: Optional[Tuple[torch.Tensor, ...]] = None
        self._stages: dict = {}  # BDF stage -> _Stage

    def engages(self, steps, q: torch.Tensor, forcing: Optional[Callable]) -> bool:
        """Whether ``steps.integrate(q, n, forcing)`` replays the graphs;
        ``refusal`` keeps the reason where it does not."""
        self.refusal = graph_refusal(steps, forcing, q)
        return self.refusal is None

    def ran_eager(self, nsteps: int) -> None:
        """Count ``nsteps`` steps that the operator ran eagerly."""
        self.eager += nsteps
        tracing.count("graph.eager", nsteps)

    def integrate(self, steps, q: torch.Tensor, nsteps: int) -> torch.Tensor:
        """``nsteps`` of the tangent steps ``steps`` from the zero history
        seeded with q, each replayed from its stage's graphs (captured
        first where missing)."""
        if self._fields is None:
            self._fields = tuple(torch.zeros(f.shape, dtype=f.dtype, device=f.device)
                                 for f in steps.fields(q))
        missing = [k for k in range(min(nsteps, 3)) if k not in self._stages]
        if missing:
            self._capture(steps, missing)
        f0, *rest = self._fields
        f0.copy_(q)
        for f in rest:
            f.zero_()
        for n in range(nsteps):
            self._replay(steps.ns, self._stages[min(n, 2)])
        self.replayed += nsteps
        tracing.count("graph.replayed", nsteps)
        return f0.clone()

    @staticmethod
    def _replay(ns, stage: _Stage) -> None:
        with tracing.span("step"):
            for i, graph in enumerate(stage.segments):
                with tracing.span("step.graph"):
                    graph.replay()
                if i < len(stage.holes):
                    h = stage.holes[i]
                    with tracing.span("solve.inner"):
                        h.out.copy_(getattr(ns, h.kernel).solve(h.rhs, *h.args))

    # -- capture ---------------------------------------------------------
    def _capture(self, steps, stages: List[int]) -> None:
        dev = steps.sem.device
        main, side = torch.cuda.current_stream(dev), _side_stream(dev)
        with tracing.span("step.capture"):
            torch.cuda.synchronize(dev)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                if not self._stages:
                    self._dry_run(steps)
                for k in stages:
                    self._stages[k] = self._capture_stage(steps, k, main)
                    self.captures += 1
                    tracing.count("graph.captures")
            main.wait_stream(side)

    def _dry_run(self, steps) -> None:
        """One eager step on throwaway fields, each hole answered by zeros:
        every kernel and library workspace of the step is loaded before a
        capture."""
        ns = steps.ns
        ns._hole = lambda kernel, r, args: torch.zeros_like(r)
        try:
            steps.step(tuple(torch.zeros_like(f) for f in self._fields), 2)
        finally:
            ns._hole = None

    def _capture_stage(self, steps, k: int, main) -> _Stage:
        """Stage k's step on the static fields as graph segments around
        its fused solves.  ``main`` is the stream the placeholders are
        allocated on, the one the replays run on."""
        ns = steps.ns
        pool = torch.cuda.graph_pool_handle()
        segments: List[torch.cuda.CUDAGraph] = []
        holes: List[_Hole] = []
        graph = torch.cuda.CUDAGraph()

        def hole(kernel: str, rhs: torch.Tensor, args: tuple) -> torch.Tensor:
            nonlocal graph
            graph.capture_end()
            segments.append(graph)
            with torch.cuda.stream(main):
                out = torch.empty_like(rhs)
            holes.append(_Hole(kernel, rhs, args, out))
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=pool)
            return out

        graph.capture_begin(pool=pool)
        ns._hole = hole
        try:
            new = steps.step(self._fields, k)
            for f, x in zip(self._fields, new):
                f.copy_(x)
        except BaseException:
            if torch.cuda.is_current_stream_capturing():
                graph.capture_end()
            raise
        finally:
            ns._hole = None
        graph.capture_end()
        segments.append(graph)
        return _Stage(segments, holes)
