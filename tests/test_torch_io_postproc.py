"""The port's Nek5000 field files (``io/nek.py``), diagnostics
(``utils/diagnostics.py``: energy, enstrophy, probes, immersed objects, the
step monitor and series writer) and post-processing (``postproc/``: the
vortex criteria, running statistics, the energy budget): the analogs of
``tests/test_io_diagnostics.py`` and ``tests/test_postproc.py``, with the
writer's bytes equal to the JAX writer's and the criteria against JAX's at
1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nekstab_next_tpu.io.nek as jax_nek
import nekstab_next_tpu.postproc as jax_pp
from nekstab_next_tpu.mesh import box_mesh_2d as jax_box_mesh_2d
from nekstab_next_tpu.ops import SEM as JaxSEM
from nekstab_next_tpu.utils import diagnostics as jax_diag
from nekstab_next_tpu_torch.interop import sem_arrays, sem_from_arrays
from nekstab_next_tpu_torch.io import nek_to_layout, read_nek_field, write_nek_field
from nekstab_next_tpu_torch.mesh import box_mesh_2d
from nekstab_next_tpu_torch.mesh.mesh import BoundaryCondition as BC
from nekstab_next_tpu_torch.ops.core import SEM
from nekstab_next_tpu_torch.postproc import (
    RunningStats,
    antisymmetric_criterion,
    delta_criterion,
    energy_budget,
    lambda2_criterion,
    omega_criterion,
    q_criterion,
    swirling_strength,
    symmetric_criterion,
    velocity_gradient,
    vorticity,
)
from nekstab_next_tpu_torch.utils import (
    SeriesWriter,
    StepMonitor,
    boundary_quadrature,
    define_objects,
    locate_probes,
    probe_values,
    surface_force_and_torque,
    total_energy,
    total_enstrophy,
)

CRITERIA = ("q_criterion", "lambda2_criterion", "delta_criterion", "swirling_strength",
            "omega_criterion", "symmetric_criterion", "antisymmetric_criterion")


@pytest.fixture(scope="module")
def box():
    mesh = box_mesh_2d(4, 4, order=5, x0=-1, x1=1, y0=-1, y1=1)
    return mesh, SEM(mesh, device="cpu")


def test_nek_writer_roundtrip_and_bytes(tmp_path):
    """A '#std' file the reader ingests, byte for byte the JAX writer's
    (tensors in, 3-D and a scalar block too)."""
    mesh = box_mesh_2d(3, 2, order=4, x0=0, x1=3, y0=0, y1=2)
    rng = np.random.default_rng(3)
    u = rng.standard_normal(mesh.x.shape + (2,))
    p = rng.standard_normal(mesh.x.shape)
    T = rng.standard_normal(mesh.x.shape + (1,))
    path, ref = tmp_path / "BF_test0.f00001", tmp_path / "BF_jax0.f00001"
    write_nek_field(str(path), u=torch.as_tensor(u), p=torch.as_tensor(p), T=torch.as_tensor(T),
                    x=mesh.x, y=mesh.y, time=2.5, istep=7)
    jax_nek.write_nek_field(str(ref), u=u, p=p, T=T, x=mesh.x, y=mesh.y, time=2.5, istep=7)
    assert path.read_bytes() == ref.read_bytes()
    f = read_nek_field(str(path))
    assert f.ndim == 2 and f.nelem == mesh.nelem
    assert abs(f.time - 2.5) < 1e-12 and f.istep == 7
    assert f.rdcode.upper().startswith("XUPT")
    np.testing.assert_allclose(nek_to_layout(f.x), mesh.x, atol=1e-13)
    np.testing.assert_allclose(nek_to_layout(f.u), u, atol=1e-13)
    np.testing.assert_allclose(nek_to_layout(f.p), p, atol=1e-13)
    np.testing.assert_allclose(nek_to_layout(f.t), T[..., 0], atol=1e-13)
    u3 = rng.standard_normal((2, 3, 3, 3, 3))
    for w in (write_nek_field, jax_nek.write_nek_field):
        w(str(tmp_path / w.__module__), u=u3, wdsize=4)
    assert (tmp_path / write_nek_field.__module__).read_bytes() == \
        (tmp_path / jax_nek.write_nek_field.__module__).read_bytes()
    assert read_nek_field(str(tmp_path / write_nek_field.__module__)).nz == 3


def test_energy_enstrophy_taylor_green():
    mesh = box_mesh_2d(8, 8, order=5, x0=0, x1=2 * np.pi, y0=0, y1=2 * np.pi,
                       periodic_x=True, periodic_y=True)
    sem = SEM(mesh, device="cpu")
    u = torch.as_tensor(np.stack([-np.cos(mesh.x) * np.sin(mesh.y),
                                  np.sin(mesh.x) * np.cos(mesh.y)], axis=-1))
    assert abs(float(total_energy(sem, u)) - np.pi ** 2) < 1e-8
    assert abs(float(total_enstrophy(sem, u)) - 2 * np.pi ** 2) < 1e-6


def test_probe_locator():
    mesh = box_mesh_2d(4, 4, order=5, x0=0, x1=1, y0=0, y1=1)
    locs = locate_probes(mesh, [(0.51, 0.52), (0.0, 0.0)])
    assert locs == jax_diag.locate_probes(mesh, [(0.51, 0.52), (0.0, 0.0)])
    xs, ys = probe_values(mesh.x, locs), probe_values(torch.as_tensor(mesh.y), locs)
    assert abs(xs[0] - 0.51) < 0.55 / 4 and abs(ys[0] - 0.52) < 0.55 / 4
    assert xs[1] == 0.0 and ys[1] == 0.0 and locs[1][2] == 0.0
    assert abs(np.hypot(xs[0] - 0.51, ys[0] - 0.52) - locs[0][2]) < 1e-14
    uv = probe_values(torch.as_tensor(np.stack([mesh.x, mesh.y], axis=-1)), locs, vector=True)
    assert uv.shape == (2, 2) and uv[1, 0] == 0.0


def test_define_objects_two_bodies():
    """Two immersed blocks in a channel: two objects whose forces sum to
    the whole boundary's, grouped as JAX's."""
    kw = dict(bc={"left": BC.DIRICHLET, "right": BC.OUTFLOW,
                  "bottom": BC.DIRICHLET, "top": BC.DIRICHLET},
              mask=lambda xc, yc: (1.0 < xc < 2.0 or 5.0 < xc < 6.0) and 1.0 < yc < 2.0,
              mask_bc=BC.WALL)
    mesh = box_mesh_2d(8, 4, order=4, x0=0.0, x1=8.0, y0=0.0, y1=4.0, **kw)
    sem = SEM(mesh, device="cpu")
    objs = define_objects(mesh, tags=(BC.WALL,))
    assert len(objs) == 2
    mids = sorted(float(np.mean(mesh.x[o.elems[:, None], o.ii, o.jj])) for o in objs)
    assert mids[0] < 3.0 < mids[1]
    from nekstab_next_tpu.mesh.mesh import BoundaryCondition as JaxBC
    jmesh = jax_box_mesh_2d(8, 4, order=4, x0=0.0, x1=8.0, y0=0.0, y1=4.0,
                            **dict(kw, bc={k: JaxBC(v.value) for k, v in kw["bc"].items()},
                                   mask_bc=JaxBC.WALL))
    for a, b in zip(objs, jax_diag.define_objects(jmesh, tags=(JaxBC.WALL,))):
        assert np.array_equal(a.elems, b.elems) and np.array_equal(a.ds, b.ds)
    rng = np.random.default_rng(5)
    u = torch.as_tensor(rng.standard_normal(mesh.x.shape + (2,)))
    p = torch.as_tensor(rng.standard_normal(sem.p_shape))
    tot = surface_force_and_torque(sem, boundary_quadrature(mesh, tags=(BC.WALL,)), u, p,
                                   viscosity=0.01)
    per = [surface_force_and_torque(sem, o, u, p, viscosity=0.01) for o in objs]
    for c in range(3):
        assert abs(sum(float(f[c]) for f in per) - float(tot[c])) < 1e-12


def test_step_monitor_and_series_writer(tmp_path):
    lines = []
    mon = StepMonitor(10, 0.01, log=lines.append, every=5)
    for _ in range(10):
        mon.step(cfl=0.4)
    assert len(lines) == 2 and lines[-1].startswith("step 10/10")
    with pytest.raises(RuntimeError, match="CFL"):
        mon.step(cfl=11.0)
    w = SeriesWriter(str(tmp_path / "total_energy.dat"))
    w.write(0.5, torch.tensor(1.25))
    w.close()
    assert (tmp_path / "total_energy.dat").read_text() == \
        "5.000000000000000E-01 1.250000000000000E+00\n"


def test_vortex_criteria_match_jax(box):
    """Every criterion of a smooth rotational flow against JAX's at 1e-12,
    the vorticity and the gradient too."""
    mesh, _ = box
    jsem = JaxSEM(jax_box_mesh_2d(4, 4, order=5, x0=-1, x1=1, y0=-1, y1=1))
    sem = sem_from_arrays(sem_arrays(jsem), device="cpu")
    u = np.stack([np.sin(2 * mesh.y) * np.cos(mesh.x), np.sin(mesh.x + mesh.y ** 2)], axis=-1)
    G, jG = velocity_gradient(sem, torch.as_tensor(u)), jax_pp.velocity_gradient(jsem, jnp.asarray(u))
    assert np.max(np.abs(G.numpy() - np.asarray(jG))) <= 1e-12 * np.max(np.abs(np.asarray(jG)))
    fns = dict(zip(CRITERIA, (q_criterion, lambda2_criterion, delta_criterion,
                              swirling_strength, omega_criterion, symmetric_criterion,
                              antisymmetric_criterion)))
    for name, fn in fns.items():
        got, ref = fn(G).numpy(), np.asarray(getattr(jax_pp.vortex, name)(jG))
        assert np.max(np.abs(got - ref)) <= 1e-12 * max(np.max(np.abs(ref)), 1.0), name
    w, jw = vorticity(sem, torch.as_tensor(u)), jax_pp.vorticity(jsem, jnp.asarray(u))
    assert np.max(np.abs(w.numpy() - np.asarray(jw))) <= 1e-12 * np.max(np.abs(np.asarray(jw)))


def test_vortex_criteria_solid_body_rotation_and_shear(box):
    mesh, sem = box
    om = 0.7
    G = velocity_gradient(sem, torch.as_tensor(np.stack([-om * mesh.y, om * mesh.x], axis=-1)))
    assert float((q_criterion(G) - om ** 2).abs().max()) < 1e-10
    assert float((lambda2_criterion(G) + om ** 2).abs().max()) < 1e-10
    assert float((swirling_strength(G) - om).abs().max()) < 1e-10
    assert float(omega_criterion(G).min()) > 0.99
    G = velocity_gradient(sem, torch.as_tensor(
        np.stack([0.5 * mesh.y, np.zeros_like(mesh.x)], axis=-1)))
    assert float(q_criterion(G).abs().max()) < 1e-10
    assert float(swirling_strength(G).max()) < 1e-10
    assert float(omega_criterion(G).max()) < 0.51


def test_lambda2_3d_matches_jax():
    rng = np.random.default_rng(9)
    G = rng.standard_normal((5, 3, 3))
    ref = np.asarray(jax_pp.vortex.lambda2_criterion(jnp.asarray(G)))
    assert np.allclose(lambda2_criterion(torch.as_tensor(G)).numpy(), ref, rtol=0, atol=1e-12)
    ref = np.asarray(jax_pp.vortex.swirling_strength(jnp.asarray(G)))
    assert np.allclose(swirling_strength(torch.as_tensor(G)).numpy(), ref, rtol=0, atol=1e-12)


def test_running_stats(box):
    mesh, _ = box
    shape = mesh.x.shape
    st = RunningStats.zeros(shape, nc=2)
    u1 = torch.ones(shape + (2,), dtype=torch.float64)
    st = st.update(u1, 0.5).update(3.0 * u1, 0.5)
    assert float((st.avg - 2.0).abs().max()) < 1e-14
    assert float((st.rms - 5.0).abs().max()) < 1e-14
    assert float((st.variance() - 1.0).abs().max()) < 1e-13
    assert float((st.rm2 - 5.0).abs().max()) < 1e-13
    assert st.atime == 1.0


def test_energy_budget(box):
    """Production of a strain base flow and dissipation of a Fourier mode
    (the JAX tests' closed forms), and the pointwise fields against JAX's."""
    mesh, sem = box
    alpha = 0.3
    base = np.stack([alpha * mesh.x, -alpha * mesh.y], axis=-1)
    re = np.stack([np.ones_like(mesh.x), np.zeros_like(mesh.x)], axis=-1)
    eb = energy_budget(sem, torch.as_tensor(base), torch.as_tensor(re),
                       torch.zeros(re.shape, dtype=torch.float64), viscosity=0.0)
    assert abs(float(eb.total_production) + alpha / 2.0) < 1e-10
    pmesh = box_mesh_2d(6, 6, order=5, x0=0, x1=2 * np.pi, y0=0, y1=2 * np.pi,
                        periodic_x=True, periodic_y=True)
    psem = SEM(pmesh, device="cpu")
    re = np.stack([np.sin(pmesh.x), np.zeros_like(pmesh.x)], axis=-1)
    eb = energy_budget(psem, torch.zeros(re.shape, dtype=torch.float64), torch.as_tensor(re),
                       torch.zeros(re.shape, dtype=torch.float64), viscosity=0.02)
    assert abs(float(eb.dissipation_integral) + 0.01) < 1e-6
    jsem = JaxSEM(jax_box_mesh_2d(4, 4, order=5, x0=-1, x1=1, y0=-1, y1=1))
    s2 = sem_from_arrays(sem_arrays(jsem), device="cpu")
    rng = np.random.default_rng(1)
    m_re, m_im = (rng.standard_normal(base.shape) for _ in range(2))
    ub = np.stack([np.sin(mesh.y), mesh.x * mesh.y], axis=-1)
    got = energy_budget(s2, *(torch.as_tensor(a) for a in (ub, m_re, m_im)), viscosity=0.05)
    ref = jax_pp.energy_budget(jsem, *(jnp.asarray(a) for a in (ub, m_re, m_im)), viscosity=0.05)
    for name in ("production", "dissipation", "production_integrals", "dissipation_integral"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert np.max(np.abs(a - b)) <= 1e-12 * max(np.max(np.abs(b)), 1.0), name
