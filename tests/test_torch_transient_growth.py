"""The port's transient-growth analysis (``transient_growth_analysis``:
Golub-Kahan svds of the tangent propagator and its sponge-masked adjoint)
against the JAX package's and against a dense ground truth built from the
port's own ``matvec`` and ``rmatvec`` (the ``tests/test_tg_dense.py``
analog; ``tests/test_torch_svd.py`` holds the Stokes box's G = 1).

Tolerances: G to JAX's to 1e-6 relative (the same svds on operators that
agree to ~1e-12); G to the dense ground truth to 1e-3, as the JAX test
holds its own; the adjoint to the dense
W^+ M^T W to 1e-9 at solver tolerances 1e-12."""

import jax
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from nekstab_next_tpu.algorithms import transient_growth_analysis as jax_tg
from nekstab_next_tpu.cases.bfs import BackwardFacingStepCase as JaxBFS
from nekstab_next_tpu.config import SolverConfig as JaxSolverConfig
from nekstab_next_tpu_torch.algorithms import transient_growth_analysis
from nekstab_next_tpu_torch.cases.bfs import BackwardFacingStepCase
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator

# tests/test_tg_dense.py's sponged step: 28 elements at order 3
TG_DENSE = dict(reynolds=500.0, order=3, elems_upstream=2, elems_downstream=6,
                elems_y=4, inflow_length=3.0, outflow_length=9.0, sponge=True,
                sponge_left=1.5, sponge_right=2.5, sponge_strength=2.0)
TIGHT = dict(pressure_tol=1e-12, velocity_tol=1e-12, pressure_maxiter=3000,
             velocity_maxiter=1000, pressure_precond="schwarz")
# the same step cut to 7 elements, its right sponge widened: a dense
# propagator of under 100 columns
TINY = dict(TG_DENSE, elems_upstream=1, elems_downstream=3, elems_y=2,
            inflow_length=1.5, outflow_length=4.5, sponge_left=0.5, sponge_right=2.0)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread while this module runs: the test suite runs
    several worker processes at once, and torch's thread pools on tiny
    tensors slow down many-fold when they contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_growth_matches_jax():
    # test_tg_dense's case and base flow (400 JAX steps), the horizon cut
    # from 0.5 to 0.25 and a short svds (k_dim 6, tol 5e-2, one thick
    # restart) in place of its ground-truth settings, for time: the two
    # packages run the same iteration, so G agrees whatever the tolerance
    jcase = JaxBFS(**TG_DENSE, solver=JaxSolverConfig(pressure_precond="schwarz"))
    ns0 = jcase.make_ns()
    base = jax.jit(lambda s: ns0.advance(s, 400))(ns0.make_state(jcase.initial_flow())).u
    T = 0.25
    nsteps = max(int(round(T / jcase.dt)), 1)
    kw = dict(horizon=T, nsteps=nsteps, nsv=1, k_dim=6, tol=5e-2)
    ref = jax_tg(jcase.make_ns(sponge_ref=base), base, **kw)
    case = BackwardFacingStepCase(**TG_DENSE, solver=SolverConfig(pressure_precond="schwarz"),
                                  device="cpu")
    base_t = torch.as_tensor(np.array(base))
    got = transient_growth_analysis(case.make_ns(sponge_ref=base_t), base_t, **kw)
    assert got.n_matvecs == ref.n_matvecs
    assert got.horizon == pytest.approx(ref.horizon, rel=1e-15)
    assert abs(got.gains[0] / ref.gains[0] - 1.0) < 1e-6, (got.gains, ref.gains)
    np.testing.assert_allclose(got.sigma ** 2, got.gains, rtol=1e-15)
    np.testing.assert_allclose(got.residuals, ref.residuals, rtol=1e-4)
    # the optimal input lies in the measured (bm1s > 0) subspace
    v = got.optimal_inputs[0]
    assert float((v * (case.sem.bms == 0)[..., None]).abs().max()) == 0.0


def test_growth_matches_dense_ground_truth():
    # the dense propagator M on the free dofs from unit-vector matvecs; G is
    # the top eigenvalue of M^T W M q = G W q on the free bm1s > 0 subspace
    # solver tolerances 1e-12, so the solves' transposes are exact to ~1e-11
    case = BackwardFacingStepCase(**TINY, solver=SolverConfig(**TIGHT), device="cpu")
    ns0 = case.make_ns()
    base = ns0.advance(ns0.make_state(case.initial_flow()), 40).u
    ns = case.make_ns(sponge_ref=base)
    nsteps = 2
    op = LinearizedOperator(ns, base, nsteps=nsteps)
    shape = tuple(base.shape)
    W = case.sem.bms[..., None].expand(shape).reshape(-1).numpy()
    free = (case.sem.vmask.expand(shape).reshape(-1).numpy() > 0) & (W > 0)
    idx = np.flatnonzero(free)
    cols = []
    for i in idx:
        e = torch.zeros(base.numel(), dtype=base.dtype)
        e[i] = 1.0
        cols.append(op.matvec(e.reshape(shape)).reshape(-1).numpy())
    M = np.stack(cols, axis=1)  # (all dofs, free dofs)
    Mff = M[idx]
    Wf = W[idx]
    A = Mff.T @ (Wf[:, None] * Mff)
    G_dense = sla.eigh(0.5 * (A + A.T), np.diag(Wf), eigvals_only=True)[-1]
    # rmatvec = W^+ M^T W on the free subspace
    x = np.zeros(base.numel())
    x[idx] = np.random.default_rng(0).standard_normal(idx.size)
    adj = op.rmatvec(torch.as_tensor(x.reshape(shape))).reshape(-1).numpy()
    dense_adj = (Mff.T @ (Wf * x[idx])) / Wf
    assert np.linalg.norm(adj[idx] - dense_adj) <= 1e-9 * np.linalg.norm(dense_adj)
    res = transient_growth_analysis(ns, base, horizon=nsteps * ns.dt, nsteps=nsteps,
                                    nsv=1, k_dim=16, tol=1e-6)
    assert abs(res.gains[0] / G_dense - 1.0) < 1e-3, (res.gains[0], G_dense)


def test_seed_inside_the_sponge_raises():
    case = BackwardFacingStepCase(**TINY, device="cpu")
    ns = case.make_ns()
    base = case.initial_flow()
    x0 = torch.ones_like(base) * (case.sem.bms == 0)[..., None]
    with pytest.raises(ValueError, match="zero energy"):
        transient_growth_analysis(ns, base, horizon=ns.dt, nsteps=1, x0=x0)
    # about a periodic base (floquet=True) the seed is held to the same
    # measured subspace
    with pytest.raises(ValueError, match="zero energy"):
        transient_growth_analysis(ns, base, horizon=ns.dt, nsteps=1, x0=x0, floquet=True)
