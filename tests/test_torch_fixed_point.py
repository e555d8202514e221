"""The port's fixed-point accelerators (``algorithms/fixed_point.py``:
``sfd``, ``boostconv_dns``, ``tdf``) against the JAX package's, over a few
cycles on a small graded backward-facing step (28 elements at order 3,
Re 100, f64, 'schwarz' pressure and solver tolerances 1e-12) from the same
initial flow.

Tolerance: the iterates and the residual histories agree to 1e-10
relative (the same loops of steps solved to 1e-12, with BoostConv's
least-squares solve on top)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nekstab_next_tpu.algorithms import fixed_point as jfp
from nekstab_next_tpu.cases.bfs import BackwardFacingStepCase as JaxBFS
from nekstab_next_tpu.config import SolverConfig as JaxSolverConfig
from nekstab_next_tpu_torch.algorithms import boostconv_dns, sfd, tdf
from nekstab_next_tpu_torch.cases.bfs import BackwardFacingStepCase
from nekstab_next_tpu_torch.config import SolverConfig

SMALL = dict(reynolds=100.0, order=3, elems_upstream=2, elems_downstream=6, elems_y=4,
             inflow_length=3.0, outflow_length=9.0, step_dx=0.3)
CFG = dict(pressure_tol=1e-12, velocity_tol=1e-12, pressure_maxiter=3000,
           velocity_maxiter=1000, pressure_precond="schwarz")
RUNS = {
    # 3 chunks of 4 steps
    "sfd": (jfp.sfd, sfd, dict(gain=-0.2, cutoff=0.5, tol=1e-30, max_steps=12, chunk=4)),
    # 5 cycles of 4 steps on a subspace of 3: the cyclic buffers wrap
    "boostconv": (jfp.boostconv_dns, boostconv_dns,
                  dict(skip=4, subspace=3, tol=1e-30, max_steps=20)),
    # 3 periods of 4 steps
    "tdf": (jfp.tdf, tdf, dict(gain=-0.2, tol=1e-30, max_periods=3)),
}


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread while this module runs: the test suite runs
    several worker processes at once, and torch's thread pools on tiny
    tensors slow down many-fold when they contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def steppers():
    jcase = JaxBFS(**SMALL, solver=JaxSolverConfig(**CFG))
    case = BackwardFacingStepCase(**SMALL, solver=SolverConfig(**CFG), device="cpu")
    return jcase.make_ns(), case.make_ns(), np.array(jcase.initial_flow())


def relerr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("name", sorted(RUNS))
def test_iterates_and_histories_match_jax(steppers, name):
    jns, ns, u0 = steppers
    jax_fn, fn, kw = RUNS[name]
    if name == "tdf":
        kw = dict(kw, period=4 * ns.dt)
    ref = jax_fn(jns, jnp.asarray(u0), **kw)
    got = fn(ns, torch.as_tensor(u0), **kw)
    assert not got.converged and not ref.converged
    assert got.iterations == ref.iterations
    assert [s for s, _ in got.history] == [s for s, _ in ref.history]
    np.testing.assert_allclose([r for _, r in got.history], [r for _, r in ref.history],
                               rtol=1e-10, atol=0)
    assert relerr(got.u.numpy(), ref.u) <= 1e-10
    assert relerr(got.p.numpy(), ref.p) <= 1e-10
    assert got.residual == pytest.approx(ref.residual, rel=1e-10)


def test_callbacks_and_divergence(steppers):
    _, ns, u0 = steppers
    seen = []
    sfd(ns, torch.as_tensor(u0), tol=1e-30, max_steps=4, chunk=2,
        callback=lambda steps, res: seen.append(steps))
    assert seen == [2, 4]
    bad = torch.full_like(torch.as_tensor(u0), float("nan"))
    with pytest.raises(FloatingPointError):
        boostconv_dns(ns, bad, skip=2, subspace=2, max_steps=4)
