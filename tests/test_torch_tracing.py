"""The port's tracing (``utils/tracing.py``): spans at the Krylov,
propagator, step and solve layers, and the CG kernels' iteration logs.

On the tiny fused-IR cylinder of ``test_torch_mixed_ir.py`` (the kernels'
plain versions on the CPU), built by the port alone: no JAX here."""

import numpy as np
import pytest
import torch

from nekstab_next_tpu_torch.algorithms.stability import velocity_space
from nekstab_next_tpu_torch.cases.cylinder import CylinderCase
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.krylov.krylov_schur import eigs
from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator
from nekstab_next_tpu_torch.utils import tracing

MESH = dict(nr=4, ntheta=8, order=6)
MIXED = dict(pressure_tol=1e-8, velocity_tol=1e-9, pressure_maxiter=500,
             velocity_maxiter=200, pressure_precond="block", fused_solves=True)
NSTEPS = 3
PHASES = ("step.explicit", "step.velocity", "step.pressure", "step.projection")


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and nothing recorded."""
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


@pytest.fixture(scope="module")
def tiny():
    case = CylinderCase(**MESH, solver=SolverConfig(**MIXED), mixed_precision=True,
                        device="cpu")
    ns = case.make_ns()
    assert ns._mixed_ir
    op = LinearizedOperator(ns, case.uniform_flow(), nsteps=NSTEPS)
    noise = np.random.default_rng(1).standard_normal(tuple(case.uniform_flow().shape))
    q = case.sem.vmask * case.sem.dsavg(torch.as_tensor(noise))
    return case, ns, op, q


def traced(fn, *args):
    tracing.enable()
    try:
        out = fn(*args)
    finally:
        tracing.disable()
    return out, tracing.take()


def children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def test_off_shares_one_context():
    assert tracing.span("step") is tracing.span("krylov.eigs")
    with tracing.span("step"):
        pass
    assert tracing.iteration_log("k1") is None
    rec = tracing.take()
    assert rec.spans == [] and not any(rec.iterations.values())


def test_tracing_changes_no_bit_of_a_matvec(tiny):
    _, _, op, q = tiny
    off = op.matvec(q)
    rec = tracing.take()  # tracing off: nothing recorded
    assert rec.spans == [] and not any(rec.iterations.values())
    on, rec = traced(op.matvec, q)
    assert rec.spans
    assert torch.equal(on, off)


def test_span_tree_of_a_matvec(tiny):
    _, ns, op, q = tiny
    _, rec = traced(op.matvec, q)
    spans = rec.spans
    (top,) = [s for s in spans if s.name == "prop.matvec"]
    assert top.parent == 0 and all(s.root == top.id for s in spans)
    steps = [s for s in spans if s.name == "step"]
    assert len(steps) == NSTEPS and all(s.parent == top.id for s in steps)
    cycles = ns.solver.mixed_ir_cycles
    for st in steps:
        kids = children(spans, st)
        assert sorted(s.name for s in kids) == sorted(PHASES)
        below = [s for s in spans if s.parent in {k.id for k in kids}]
        assert sum(s.name == "solve.inner" for s in below) == 2 * cycles
        assert sum(s.name == "solve.residual" for s in below) == 2 * (cycles - 1)
        # the velocity solve's under step.velocity, the pressure's under step.pressure
        for k in kids:
            n = len(children(spans, k))
            assert n == (2 * cycles - 1 if k.name in ("step.velocity", "step.pressure") else 0)
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.t0 <= s.t1
        if s.parent:
            p = by_id[s.parent]
            assert p.t0 <= s.t0 and s.t1 <= p.t1


def test_span_tree_of_an_rmatvec(tiny):
    _, ns, op, q = tiny
    op._stage_vjps()  # its build runs forward steps
    _, rec = traced(op.rmatvec, q)
    spans = rec.spans
    (top,) = [s for s in spans if s.name == "prop.rmatvec"]
    steps = [s for s in spans if s.name == "step"]
    assert len(steps) == NSTEPS and all(s.parent == top.id for s in steps)
    inner = [s for s in spans if s.name == "solve.inner"]
    cycles = ns.solver.mixed_ir_cycles
    assert len(inner) == 2 * cycles * NSTEPS
    assert {s.parent for s in inner} == {s.id for s in steps}


def test_cpu_iterations_are_the_plain_versions(tiny):
    case, ns, _, _ = tiny
    rng = np.random.default_rng(2)
    sem = case.sem
    rhs_v = sem.vmask * sem.dsavg(torch.as_tensor(rng.standard_normal(tuple(sem.vmask.shape))))
    rhs_p = torch.as_tensor(rng.standard_normal(tuple(ns.p_shape)))
    h2 = 1.0 / ns.dt
    its1 = ns.fused_v.plain(rhs_v, ns.nu, h2, return_iters=True)[1]
    its2 = ns.fused_p.plain(rhs_p, return_iters=True)[1]
    _, rec = traced(lambda: (ns.fused_v.solve(rhs_v, ns.nu, h2), ns.fused_p.solve(rhs_p)))
    assert rec.iterations["k1"] == [its1] and rec.iterations["k2"] == [its2]
    assert its1 > 0 and its2 > 0 and rec.overflow == {"k1": 0, "k2": 0}


def test_a_full_log_counts_its_overflow(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    tracing.enable()
    for k in range(5):
        tracing.iteration_log("kx").solve(k)
    rec = tracing.take()
    assert rec.iterations["kx"] == [0, 1, 2] and rec.overflow["kx"] == 2
    assert tracing.take().iterations["kx"] == []


def test_an_exception_closes_its_span():
    tracing.enable()
    with pytest.raises(KeyError):
        with tracing.span("krylov.eigs"):
            with tracing.span("prop.matvec"):
                raise KeyError
    with tracing.span("step"):
        pass
    spans = tracing.take().spans
    assert [s.name for s in spans] == ["prop.matvec", "krylov.eigs", "step"]
    assert spans[2].parent == 0 and spans[0].parent == spans[1].id


def test_eigs_spans_share_the_analysis_id(tiny):
    case, ns, _, q = tiny
    op = LinearizedOperator(ns, case.uniform_flow(), nsteps=1)
    res, rec = traced(lambda: eigs(op.matvec, velocity_space(case.sem), q, k_dim=4, nev=1,
                                   tol=1e-30, max_restarts=1))
    spans = rec.spans
    (root,) = [s for s in spans if s.name == "krylov.eigs"]
    assert all(s.root == root.id for s in spans)
    ortho = [s for s in spans if s.name == "krylov.ortho"]
    assert len(ortho) == res.n_matvecs == sum(s.name == "prop.matvec" for s in spans)
    assert sum(s.name == "krylov.ritz" for s in spans) == 2
    assert sum(s.name == "krylov.restart" for s in spans) == 1
