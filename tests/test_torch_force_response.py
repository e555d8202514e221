"""The port's response to a steady force (``postproc/sensitivity.py``:
``delta_forcing``, ``forced_tangent_response``, ``steady_force_sensitivity``)
against the JAX package's, the analogs of tests/test_postproc.py:130-189;
f64, solves at 1e-12, on 2 x 2 boxes at order 4."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nekstab_next_tpu.config import SolverConfig as JaxSolverConfig
from nekstab_next_tpu.mesh import box_mesh_2d
from nekstab_next_tpu.ops import SEM as JaxSEM
from nekstab_next_tpu.postproc.sensitivity import (
    forced_tangent_response as jax_forced_tangent_response,
    steady_force_sensitivity as jax_steady_force_sensitivity,
)
from nekstab_next_tpu.stepper import NavierStokes as JaxNavierStokes
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.interop import sem_arrays, sem_from_arrays
from nekstab_next_tpu_torch.postproc import (
    delta_forcing,
    forced_tangent_response,
    steady_force_sensitivity,
)
from nekstab_next_tpu_torch.stepper import NavierStokes
from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator

TIGHT = dict(pressure_tol=1e-12, velocity_tol=1e-12)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread while this module runs: the test suite runs
    several worker processes at once, and torch's thread pools on tiny
    tensors slow down many-fold when they contend for the cores.  And no
    ``opt_einsum`` path search: on these tiny tensors it is most of the
    plain step's host time (it changes only the contraction order)."""
    threads = torch.get_num_threads()
    opt = torch.backends.opt_einsum.enabled
    torch.set_num_threads(1)
    torch.backends.opt_einsum.enabled = False
    yield
    torch.set_num_threads(threads)
    torch.backends.opt_einsum.enabled = opt


def both(periodic: bool, nu: float, dt: float):
    """Both packages' steppers on a 2 x 2 box at order 4: periodic on
    [0, 2 pi]^2, or walled on [-1, 1]^2."""
    if periodic:
        mesh = box_mesh_2d(2, 2, order=4, x0=0, x1=2 * np.pi, y0=0, y1=2 * np.pi,
                           periodic_x=True, periodic_y=True)
    else:
        mesh = box_mesh_2d(2, 2, order=4, x0=-1, x1=1, y0=-1, y1=1)
    jsem = JaxSEM(mesh)
    cfg = JaxSolverConfig(**TIGHT)
    jns = JaxNavierStokes(jsem, viscosity=nu, dt=dt, solver=cfg)
    sem = sem_from_arrays(sem_arrays(jsem), device="cpu")
    ns = NavierStokes(sem, viscosity=nu, dt=dt, solver=SolverConfig(**dataclasses.asdict(cfg)))
    return mesh, jsem, jns, sem, ns


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def test_delta_forcing():
    mesh, _, _, sem, _ = both(False, 0.05, 0.01)
    base = torch.as_tensor(np.stack([np.ones_like(mesh.x), np.zeros_like(mesh.x)], -1))
    dl, dw = delta_forcing(sem, base, 2.0 * base, -1.0 * base)
    assert float((dl + 2.0).abs().max()) < 1e-12 and float((dw + 1.0).abs().max()) < 1e-12


def test_forced_tangent_response_matches_jax():
    """The particular solution of the tangent system under a constant
    force (4 steps about a uniform flow on the periodic box) against JAX's
    (1e-10), and its transpose in the bm product (1e-10: both sides solve
    to 1e-12)."""
    mesh, jsem, jns, sem, ns = both(True, 0.05, 0.01)
    rng = np.random.default_rng(5)
    shape = tuple(sem.bm.shape) + (2,)
    base = np.zeros(shape)
    base[..., 0] = 1.0
    f, w = rng.standard_normal(shape), rng.standard_normal(shape)
    ref, _ = jax_forced_tangent_response(jns, jnp.asarray(base), jnp.asarray(f), 4)
    gf, prop = forced_tangent_response(ns, torch.as_tensor(base), torch.as_tensor(f), 4)
    assert rel(gf.numpy(), ref) <= 1e-10
    bm = sem.bm[..., None]
    gtw = prop.transpose(torch.as_tensor(w) * bm) / bm
    lhs = float(torch.sum(bm * gf * torch.as_tensor(w)))
    rhs = float(torch.sum(bm * torch.as_tensor(f) * gtw))
    assert abs(lhs - rhs) <= 1e-10 * abs(lhs), (lhs, rhs)


def test_steady_force_sensitivity_matches_jax():
    """The time-stepper steady system (I - exp(T L^+)) x = b on the adjoint
    propagator, on the walled box (I - M^+ is invertible there): the port's
    x against JAX's (1e-8), and the port's residual (1e-7)."""
    mesh, jsem, jns, sem, ns = both(False, 0.05, 0.01)
    rng = np.random.default_rng(6)
    shape = tuple(sem.bm.shape) + (2,)
    f = rng.standard_normal(shape)
    base = np.zeros(shape)
    ref, jinfo = jax_steady_force_sensitivity(jns, jnp.asarray(base), jnp.asarray(f), 4,
                                              k_dim=30, tol=1e-9)
    x, info = steady_force_sensitivity(ns, torch.as_tensor(base), torch.as_tensor(f), 4,
                                       k_dim=30, tol=1e-9)
    assert info["converged"] and jinfo["converged"]
    assert rel(x.numpy(), ref) <= 1e-8
    _, prop = forced_tangent_response(ns, torch.as_tensor(base), torch.as_tensor(f), 4)
    bm = sem.bm[..., None]
    b = prop.transpose(torch.as_tensor(f) * bm) / bm
    r = x - LinearizedOperator(ns, torch.as_tensor(base), nsteps=4).rmatvec(x) - b
    assert float(r.norm() / b.norm()) < 1e-7
