"""The CUDA-graph replay of the frozen-base tangent step
(``stepper/graphs.py``) on the CPU: which routes it refuses and why, that a
refused matvec runs the eager steps bit for bit, and the layout of the
capture pass (graph segments around the fused solves).  The replay itself
runs only on the card (``tests/test_torch_cuda.py``).

On the tiny cylinder of ``test_torch_tracing.py``, built by the port
alone: no JAX here."""

import contextlib

import numpy as np
import pytest
import torch

from nekstab_next_tpu_torch.cases.cylinder import CylinderCase
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.stepper import graphs
from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator, TangentSteps
from nekstab_next_tpu_torch.stepper.navier_stokes import NavierStokes
from nekstab_next_tpu_torch.utils import tracing

MESH = dict(nr=4, ntheta=8, order=6)
MIXED = dict(pressure_tol=1e-8, velocity_tol=1e-9, pressure_maxiter=500,
             velocity_maxiter=200, pressure_precond="block", fused_solves=True)
TIGHT_F32 = dict(pressure_tol=1e-6, velocity_tol=1e-7, pressure_maxiter=80,
                 velocity_maxiter=40, pressure_precond="block", fused_solves=True)
NSTEPS = 3


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


@pytest.fixture(scope="module")
def cyl():
    return CylinderCase(**MESH, solver=SolverConfig(**MIXED), mixed_precision=True,
                        device="cpu")


def _noise(case, seed=1):
    u = np.random.default_rng(seed).standard_normal(tuple(case.uniform_flow().shape))
    return case.sem.vmask * case.sem.dsavg(torch.as_tensor(u, dtype=case.sem.dtype))


def _ns(case, **kw):
    return NavierStokes(case.sem, 1.0 / case.reynolds, case.dt, u_bc=case.u_bc,
                        sponge_ref=case.uniform_flow(), solver=case.solver,
                        mixed_precision=case.mixed_precision, **kw)


def _frozen(ns, case):
    return TangentSteps(ns, case.uniform_flow().to(ns.sem.dtype), 0.0)


def _route(name, cyl):
    """(TangentSteps, integrate's forcing, input) of one route."""
    if name == "cpu":
        return _frozen(cyl.make_ns(), cyl), None, None
    if name == "plain_f64":
        case = CylinderCase(**MESH, solver=SolverConfig(**MIXED), device="cpu")
        return _frozen(case.make_ns(), case), None, None
    if name == "legacy_mixed":
        case = CylinderCase(**MESH, solver=SolverConfig(**dict(MIXED, fused_solves=False)),
                            mixed_precision=True, device="cpu")
        return _frozen(case.make_ns(), case), None, None
    if name == "f32_laplacian":  # K1 alone: the pressure solve is plain
        case = CylinderCase(**MESH, dtype=torch.float32, device="cpu",
                            solver=SolverConfig(**TIGHT_F32, pressure_operator="laplacian"))
        return _frozen(case.make_ns(), case), None, None
    if name == "orbit":
        base = cyl.uniform_flow()
        return TangentSteps(cyl.make_ns(), [base, base], [0.0, cyl.dt]), None, None
    if name == "scalar_block":
        return _frozen(_ns(cyl, scalar_diff=(0.1,)), cyl), None, None
    if name == "forcing_hook":
        return _frozen(_ns(cyl, forcing=lambda u, t: 0.1 * u), cyl), None, None
    if name == "per_step_forcing":
        return _frozen(cyl.make_ns(), cyl), (lambda n: None), None
    if name == "autograd":
        return _frozen(cyl.make_ns(), cyl), None, _noise(cyl).requires_grad_()
    raise KeyError(name)


@pytest.mark.parametrize("name,reason", [
    ("cpu", "not on CUDA"),
    ("plain_f64", "plain solves"),
    ("legacy_mixed", "legacy mixed path"),
    ("f32_laplacian", "plain solves"),
    ("orbit", "orbit base"),
    ("scalar_block", "scalar block"),
    ("forcing_hook", "forcing hook"),
    ("per_step_forcing", "not on CUDA"),
    ("autograd", "not on CUDA"),
    ("shard_view", "shard view"),
])
def test_graph_refusal_names_the_route(cyl, name, reason):
    if name == "shard_view":
        from nekstab_next_tpu_torch.parallel import make_device_mesh

        dm = make_device_mesh(1, device="cpu")
        try:
            view = cyl.sem.shard_view(cyl.sem.elem_arrays(), dm.group)
            ns = NavierStokes(view, 1.0 / cyl.reynolds, cyl.dt, solver=cyl.solver)
            got = graphs.graph_refusal(_frozen(ns, cyl))
        finally:
            dm.close()
    else:
        steps, forcing, q = _route(name, cyl)
        got = graphs.graph_refusal(steps, forcing, q)
    assert got == reason


@pytest.mark.parametrize("name,reason", [
    ("per_step_forcing", "per-step forcing"),
    ("autograd", "autograd"),
])
def test_graph_refusal_of_a_call_on_a_graphable_operator(cyl, monkeypatch, name, reason):
    # the call's own reasons, read past the device (the one reason a
    # graphable operator has on the CPU)
    steps, forcing, q = _route(name, cyl)
    monkeypatch.setattr(steps.sem, "device", torch.device("cuda"))
    assert graphs.graph_refusal(steps, forcing, q) == reason
    assert graphs.graph_refusal(steps) is None


def test_a_refused_matvec_is_the_eager_steps(cyl):
    ns = cyl.make_ns()
    op = LinearizedOperator(ns, cyl.uniform_flow(), nsteps=NSTEPS)
    q = _noise(cyl)
    tracing.enable()
    got = op.matvec(q)
    rec = tracing.take()
    df = op.steps.fields(q)
    for n in range(NSTEPS):
        df = ns._core(df, 0.0, min(n, 2), lin_base=op.base_u, dt=op.dt)
    assert torch.equal(got, df[0])
    g = op.steps.graphs
    assert (g.refusal, g.replayed, g.eager, g.captures) == ("not on CUDA", 0, NSTEPS, 0)
    assert rec.counters == {"graph.eager": NSTEPS}
    assert not any(s.name in ("step.graph", "step.capture") for s in rec.spans)


def test_transposes_count_their_steps_eager(cyl):
    ns = cyl.make_ns()
    op = LinearizedOperator(ns, cyl.uniform_flow(), nsteps=2)
    op.rmatvec(_noise(cyl))
    assert (op.steps.graphs.replayed, op.steps.graphs.eager) == (0, 2)
    steps = TangentSteps(ns, [cyl.uniform_flow()] * 2, [0.0, cyl.dt])
    steps.transpose(_noise(cyl), 2)
    assert (steps.graphs.replayed, steps.graphs.eager) == (0, 2)


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: records the
    capture calls; the ops between them run eagerly."""

    log: list = []

    def capture_begin(self, pool=None):
        self.log.append(("begin", pool))

    def capture_end(self):
        self.log.append(("end",))


@pytest.mark.parametrize("route,holes", [
    ("fused_ir", ["fused_v", "fused_v", "fused_p", "fused_p"]),
    ("f32", ["fused_v", "fused_p"]),
])
def test_capture_splits_the_step_at_the_fused_solves(cyl, monkeypatch, route, holes):
    if route == "f32":
        case = CylinderCase(**MESH, dtype=torch.float32, device="cpu",
                            solver=SolverConfig(**TIGHT_F32))
    else:
        case = cyl
    ns = case.make_ns()
    steps = _frozen(ns, case)
    g = steps.graphs
    g._fields = tuple(torch.zeros_like(f) for f in steps.fields(_noise(case)))
    monkeypatch.setattr(_FakeGraph, "log", [])
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    tracing.enable()
    stage = g._capture_stage(steps, 2, None)
    rec = tracing.take()
    # one pool, a segment ending at each hole and one after the last
    assert _FakeGraph.log == [("begin", "pool"), ("end",)] * (len(holes) + 1)
    assert len(stage.segments) == len(holes) + 1
    assert [h.kernel for h in stage.holes] == holes
    h2 = (11.0 / 6.0) / ns.dt  # BDF3
    for h in stage.holes:
        assert h.args == ((ns.nu, h2) if h.kernel == "fused_v" else ())
        assert h.out.shape == h.rhs.shape and h.out.dtype == h.rhs.dtype
        assert h.rhs.is_contiguous() and h.out.data_ptr() != h.rhs.data_ptr()
    # a hole launches and solves nothing: no iteration-log entry
    assert not any(rec.iterations.values())
    assert ns._hole is None
