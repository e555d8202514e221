"""On a Kovasznay flow (Re 5, Dirichlet data on every side, 3 x 3 elements
at order 4, f64): the fixed-point accelerators ``sfd`` and
``boostconv_dns`` converge to the steady state that the port's own
Newton-Krylov finds."""

import numpy as np
import pytest
import torch

from nekstab_next_tpu_torch.algorithms import boostconv_dns, newton_krylov, sfd
from nekstab_next_tpu_torch.config import NewtonConfig, SolverConfig
from nekstab_next_tpu_torch.mesh import box_mesh_2d
from nekstab_next_tpu_torch.mesh.mesh import BoundaryCondition as BC
from nekstab_next_tpu_torch.ops.core import SEM
from nekstab_next_tpu_torch.stepper import NavierStokes

RE, DT = 5.0, 0.01
CFG = dict(pressure_precond="block", pressure_tol=1e-10, velocity_tol=1e-10)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread and no ``opt_einsum`` path search while this
    module runs (the test suite runs several worker processes at once)."""
    threads = torch.get_num_threads()
    opt = torch.backends.opt_einsum.enabled
    torch.set_num_threads(1)
    torch.backends.opt_einsum.enabled = False
    yield
    torch.set_num_threads(threads)
    torch.backends.opt_einsum.enabled = opt


def kovasznay(x, y):
    lam = RE / 2.0 - np.sqrt(RE ** 2 / 4.0 + 4.0 * np.pi ** 2)
    return np.stack([1.0 - np.exp(lam * x) * np.cos(2 * np.pi * y),
                     lam / (2 * np.pi) * np.exp(lam * x) * np.sin(2 * np.pi * y)], axis=-1)


@pytest.fixture(scope="module")
def kov():
    dirichlet = {side: BC.DIRICHLET for side in ("left", "right", "bottom", "top")}
    mesh = box_mesh_2d(3, 3, order=4, x0=-0.5, x1=1.0, y0=-0.5, y1=1.5, bc=dirichlet)
    exact = kovasznay(mesh.x, mesh.y)
    sem = SEM(mesh, device="cpu")
    ns = NavierStokes(sem, viscosity=1.0 / RE, dt=DT, u_bc=torch.as_tensor(exact),
                      solver=SolverConfig(**CFG))
    pert = 0.02 * np.random.default_rng(0).standard_normal(exact.shape)
    u0 = torch.as_tensor(exact) + sem.vmask * sem.dsavg(torch.as_tensor(pert))
    return ns, sem, u0


def test_sfd_and_boostconv_reach_the_newton_fixed_point(kov):
    """SFD and BoostConv march to the steady state (residual 1e-9), the same
    one to 1e-7; the port's Newton-Krylov fixed point of the 5-step map
    from a fresh state (zero pressure, BDF ramp) lies within 1e-2 of it:
    that map's restart carries an O(dt) splitting error (6.2e-3 measured
    here at dt 0.01), which the marches, carrying their pressure, do not."""
    ns, sem, u0 = kov
    nr = newton_krylov(ns, u0, horizon=5 * DT, nsteps=5, k_dim=30,
                       cfg=NewtonConfig(tol=1e-10, max_iter=20))
    assert nr.converged
    s = sfd(ns, u0, gain=-2.0, cutoff=20.0, tol=1e-9, chunk=10,
            max_steps=1000)
    b = boostconv_dns(ns, u0, skip=10, subspace=10, tol=1e-9, max_steps=1000)
    assert s.converged and b.converged
    norm = lambda x: float(sem.norm(x))
    assert norm(s.u - b.u) <= 1e-7 * norm(b.u)
    gap = norm(b.u - nr.u) / norm(nr.u)
    assert gap <= 1e-2, gap
    # the march's state is a fixed point of the step carrying its pressure
    st = ns.make_state(b.u, p=b.p)
    st = ns.advance(st, 5)
    assert norm(st.u - b.u) <= 1e-6 * norm(b.u)
