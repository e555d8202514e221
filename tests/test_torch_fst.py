"""The port's free-stream-turbulence inflow (``stepper/fst.py``) and the
time-dependent Dirichlet lift ``NavierStokes(u_bc_fn=...)``: the analogs of
``tests/test_fst.py`` (the spline, the von Karman calibration, the inlet
signal driving a step, the ``FST_data/`` reader against a direct replay of
the reference's recipe), the host parts against the JAX module's, and the
port's FST steps against the JAX package's to 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nekstab_next_tpu.config import SolverConfig as JaxSolverConfig
from nekstab_next_tpu.mesh import box_mesh_2d as jax_box_mesh_2d
from nekstab_next_tpu.ops import SEM as JaxSEM
from nekstab_next_tpu.stepper import NavierStokes as JaxNavierStokes
from nekstab_next_tpu.stepper import fst as jax_fst
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.interop import sem_arrays, sem_from_arrays
from nekstab_next_tpu_torch.mesh import box_mesh_2d
from nekstab_next_tpu_torch.ops.core import SEM
from nekstab_next_tpu_torch.stepper import NavierStokes
from nekstab_next_tpu_torch.stepper.fst import (
    FSTInflow,
    fst_from_directory,
    isotropic_modes,
    load_fst_data,
    natural_cubic_spline,
    von_karman_amplitudes,
    von_karman_spectrum,
)

TIGHT = dict(pressure_tol=1e-12, velocity_tol=1e-12)


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


def library(yprof, numk=4, nmodes=3, seed=3):
    omega, beta, prof = isotropic_modes(numk, nmodes, 1.0, 6.0, yprof, seed=seed)
    amps = np.repeat(von_karman_amplitudes(1.0, 6.0, numk, nmodes, tu=0.05, length=1.0),
                     nmodes)
    return omega, beta, prof, amps


def test_spline_reproduces_smooth_function():
    x = np.linspace(0, 1, 40)
    y = np.sin(2 * np.pi * x)
    xq = np.linspace(0.05, 0.95, 200)
    got = natural_cubic_spline(x, y, xq)
    assert np.max(np.abs(got - np.sin(2 * np.pi * xq))) < 1e-4
    assert np.array_equal(got, jax_fst.natural_cubic_spline(x, y, xq))


def test_von_karman_spectrum_shape_and_calibration():
    k = np.linspace(0.1, 20, 200)
    E = von_karman_spectrum(k, length=1.0)
    assert np.all(E > 0)
    assert 1.0 < k[np.argmax(E)] < 3.0
    tu = 0.03
    amp = von_karman_amplitudes(0.5, 8.0, 12, 10, tu=tu, length=1.0)
    assert abs(np.sum(amp**2) * 10 / (1.5 * tu**2) - 1.0) < 0.25
    assert np.array_equal(amp, jax_fst.von_karman_amplitudes(0.5, 8.0, 12, 10, tu=tu,
                                                             length=1.0))
    yprof = np.linspace(0.0, 1.0, 64)
    for a, b in zip(isotropic_modes(4, 3, 1.0, 6.0, yprof, seed=3, ndim=3),
                    jax_fst.isotropic_modes(4, 3, 1.0, 6.0, yprof, seed=3, ndim=3)):
        assert np.array_equal(a, b)


def test_fst_inflow_signal_and_stepper():
    """The lift is zero off the inlet and time-dependent on it, matches the
    JAX inflow at 1e-14, and one step carries the inflow value (at the new
    time level) on the inlet nodes."""
    mesh = box_mesh_2d(3, 2, order=5, x1=3.0, y1=1.0)
    sem = SEM(mesh, device="cpu")
    yprof = np.linspace(0.0, 1.0, 64)
    omega, beta, prof, amps = library(yprof)
    fst = FSTInflow.from_modes(mesh, omega, beta, yprof, prof, amps, u_mean=(1.0, 0.0),
                               device="cpu")
    tu = fst.turbulence_intensity(nt=48)
    assert 0.02 < tu < 0.12, tu
    jref = jax_fst.FSTInflow.from_modes(jax_box_mesh_2d(3, 2, order=5, x1=3.0, y1=1.0),
                                        omega, beta, yprof, prof, amps, u_mean=(1.0, 0.0))
    assert abs(tu - jref.turbulence_intensity(nt=48)) <= 1e-14
    f0, f1 = fst(0.0), fst(0.37)
    assert np.allclose(f1.numpy(), np.asarray(jref(0.37)), rtol=0, atol=1e-14)
    x = mesh.x.reshape(-1)
    off_inlet = np.abs(x - x.min()) > 1e-10
    assert float(f0.reshape(-1, 2)[off_inlet].abs().max()) == 0.0
    assert float((f1 - f0).abs().max()) > 0.0

    ns = NavierStokes(sem, viscosity=0.05, dt=0.002, u_bc_fn=fst)
    st = ns.make_state(torch.zeros(tuple(sem.bm.shape) + (2,), dtype=torch.float64)
                       + torch.tensor([1.0, 0.0], dtype=torch.float64))
    st1 = ns.step(st)
    assert bool(torch.isfinite(st1.u).all())
    idx = fst.inlet_idx
    want = fst(ns.dt).reshape(-1, 2)[idx]
    assert np.allclose(st1.u.reshape(-1, 2)[idx].numpy(), want.numpy(), atol=1e-12)


def test_fst_steps_match_jax():
    """Five steps of a walled box driven by the FST inlet on its left wall
    in both packages on one SEM: u and p to 1e-12."""
    mesh = jax_box_mesh_2d(4, 2, order=5, x1=3.0, y1=1.0)
    jsem = JaxSEM(mesh)
    sem = sem_from_arrays(sem_arrays(jsem), device="cpu")
    yprof = np.linspace(0.0, 1.0, 64)
    omega, beta, prof, amps = library(yprof)
    jf = jax_fst.FSTInflow.from_modes(mesh, omega, beta, yprof, prof, amps)
    tf = FSTInflow.from_modes(mesh, omega, beta, yprof, prof, amps, device="cpu")
    jns = JaxNavierStokes(jsem, viscosity=0.05, dt=0.004, u_bc_fn=jf,
                          solver=JaxSolverConfig(**TIGHT))
    ns = NavierStokes(sem, viscosity=0.05, dt=0.004, u_bc_fn=tf, solver=SolverConfig(**TIGHT))
    u0 = np.zeros(mesh.x.shape + (2,))
    u0[..., 0] = 4.0 * mesh.y * (1.0 - mesh.y)
    ref = jax.jit(lambda s: jns.advance(s, 5))(jns.make_state(jnp.asarray(u0)))
    st = ns.advance(ns.make_state(torch.as_tensor(u0)), 5)
    for name in ("u", "p"):
        got, want = getattr(st, name).numpy(), np.asarray(getattr(ref, name))
        assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want)), name


def test_fst_data_reader_roundtrip(tmp_path):
    """The reference's ``FST_data/`` files: written in its exact format,
    read back, and the reconstructed inlet signal against a direct numpy
    replay of the reference's recipe (and the JAX reader's arrays)."""
    rng = np.random.default_rng(3)
    numk, nmodes = 3, 2
    M = numk * nmodes
    npts = 21
    ygrid = np.linspace(0.0, 1.0, npts)
    omega = rng.uniform(0.5, 3.0, M)
    beta = rng.uniform(-1.0, 1.0, M)
    prof = rng.standard_normal((M, npts, 6)) * 0.3
    d = tmp_path / "FST_data"
    d.mkdir()
    for m in range(M):
        (d / f"wavenumber{m+1:03d}.dat").write_text(f"{omega[m]:.12e}\n0.0\n{beta[m]:.12e}\n")
        rows = "\n".join(f"{ygrid[i]:.12e} " + " ".join(f"{prof[m, i, c]:.12e}"
                                                        for c in range(6))
                         for i in range(npts))
        (d / f"velocity{m+1:03d}.dat").write_text(f"{npts}\n{rows}\n")

    om2, be2, y2, p2 = load_fst_data(str(d), numk, nmodes, ndim=3)
    np.testing.assert_allclose(om2, omega, rtol=1e-12)
    np.testing.assert_allclose(be2, beta, rtol=1e-12)
    np.testing.assert_allclose(y2, ygrid, rtol=1e-12)
    np.testing.assert_allclose(p2[..., 0, 0], prof[:, :, 0], rtol=1e-12)
    np.testing.assert_allclose(p2[..., 2, 1], prof[:, :, 5], rtol=1e-12)
    for a, b in zip((om2, be2, y2, p2), jax_fst.load_fst_data(str(d), numk, nmodes, ndim=3)):
        assert np.array_equal(a, b)

    mesh = box_mesh_2d(3, 4, order=4, x0=0.0, x1=3.0, y0=0.0, y1=1.0)
    tu, length, k_ini, k_fin = 0.03, 1.0, 0.8, 4.0
    inflow = fst_from_directory(mesh, str(d), numk, nmodes, tu=tu, length=length,
                                k_ini=k_ini, k_fin=k_fin, u_mean=(1.0, 0.0), device="cpu")
    t = 0.37
    got = inflow.inlet_velocity(t).numpy()
    x = mesh.x.reshape(-1)
    vm = np.asarray(mesh.vmask[..., 0]).reshape(-1)
    idx = np.nonzero((np.abs(x - x.min()) < 1e-10) & (vm == 0.0))[0]
    yq = mesh.y.reshape(-1)[idx]
    zq = np.zeros_like(yq)
    amps = np.repeat(von_karman_amplitudes(k_ini, k_fin, numk, nmodes, tu, length), nmodes)
    want = np.tile([1.0, 0.0], (len(idx), 1))
    for m in range(M):
        auxc = np.cos(+omega[m] * t + beta[m] * zq) + np.cos(-omega[m] * t + beta[m] * zq)
        auxs = -np.sin(+omega[m] * t + beta[m] * zq) - np.sin(-omega[m] * t + beta[m] * zq)
        for dcomp, (cr, ci) in enumerate(((0, 1), (2, 3))):
            ure = natural_cubic_spline(ygrid, prof[m, :, cr], yq)
            uim = natural_cubic_spline(ygrid, prof[m, :, ci], yq)
            want[:, dcomp] += amps[m] * (ure * auxc + uim * auxs)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)

    bad = tmp_path / "bad"
    bad.mkdir()
    for f in d.iterdir():
        (bad / f.name).write_text(f.read_text())
    (bad / "velocity002.dat").write_text("3\n0 0 0 0 0 0 0\n0.5 0 0 0 0 0 0\n1 0 0 0 0 0 0\n")
    with pytest.raises(ValueError, match="points"):
        load_fst_data(str(bad), numk, nmodes)
