"""``tests/test_3d_generic.py`` on the port: the resolvent and SFD layers
see the spanwise component of a 3-D PnPn-2 step (the analytic Stokes
resolvent of a spanwise shear mode, the SFD residual of a w-only start),
with the JAX test's bounds."""

import numpy as np
import pytest
import torch

from nekstab_next_tpu_torch.algorithms.fixed_point import sfd
from nekstab_next_tpu_torch.algorithms.resolvent import ResolventOperator
from nekstab_next_tpu_torch.mesh import box_mesh_3d
from nekstab_next_tpu_torch.ops.core3 import SEM3
from nekstab_next_tpu_torch.stepper import NavierStokes


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread and no ``opt_einsum`` path search while this
    module runs (see ``tests/test_torch_orbit.py``)."""
    threads = torch.get_num_threads()
    opt = torch.backends.opt_einsum.enabled
    torch.set_num_threads(1)
    torch.backends.opt_einsum.enabled = False
    yield
    torch.set_num_threads(threads)
    torch.backends.opt_einsum.enabled = opt


@pytest.fixture(scope="module")
def setup3():
    """``tests/test_3d_generic.py``'s fixture on the port."""
    L = 2 * np.pi
    mesh = box_mesh_3d(3, 3, 3, order=4, x1=L, y1=L, z1=L,
                       periodic_x=True, periodic_y=True, periodic_z=True)
    sem = SEM3(mesh, device="cpu")
    nu = 0.5
    ns = NavierStokes(sem, viscosity=nu, dt=0.01)
    base = torch.zeros(tuple(sem.bm.shape) + (3,), dtype=sem.dtype)
    return mesh, sem, ns, base, nu


def test_resolvent_matvec_analytic_3d(setup3):
    """The Stokes resolvent of the spanwise shear mode f = (0, 0, cos x)
    e^{i w t} is fhat / (i w + nu) (``tests/test_3d_generic.py``, its
    bounds)."""
    mesh, sem, ns, base, nu = setup3
    omega = 0.7
    op = ResolventOperator(ns, base, omega, steps_per_period=32, gmres_kdim=15,
                           gmres_tol=1e-9)
    x = torch.as_tensor(mesh.x)
    zero = torch.zeros_like(x)
    f_re = torch.stack([zero, zero, torch.cos(x)], dim=-1)
    f_im = torch.stack([zero, zero, torch.sin(x)], dim=-1)
    u_re, u_im = op.matvec((f_re, f_im))
    what = 1.0 / (1j * omega + nu)
    we_re = what.real * torch.cos(x) - what.imag * torch.sin(x)
    we_im = what.real * torch.sin(x) + what.imag * torch.cos(x)
    scale = float(sem.norm(we_re))
    err_re = float(sem.norm(u_re[..., 2] - we_re)) / scale
    err_im = float(sem.norm(u_im[..., 2] - we_im)) / scale
    assert err_re < 1e-2, (err_re, err_im)
    assert err_im < 2e-2, (err_re, err_im)
    assert float(sem.norm(u_re[..., 0])) < 1e-8 * scale
    assert float(sem.norm(u_re[..., 1])) < 1e-8 * scale


def test_sfd_residual_sees_spanwise_component(setup3):
    """A w-only start: the residual must see the spanwise component."""
    mesh, sem, ns, base, nu = setup3
    x = torch.as_tensor(mesh.x)
    zero = torch.zeros_like(x)
    u0 = 0.1 * torch.stack([zero, zero, torch.cos(x)], dim=-1)
    res = sfd(ns, u0, gain=-0.1, cutoff=0.2, tol=1e-12, max_steps=40, chunk=20)
    assert res.history[0][1] > 1e-6, "SFD residual blind to the w component"
    assert not res.converged
