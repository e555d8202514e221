"""The port's post-processing, diagnostics, seeds and field files against
the JAX package's on the same arrays (all to 1e-12), and both packages on
the full-preset artifacts of ``cylinder_out_full/`` (the bound that
``chip_smoke.py`` holds the card's Cd and wavemaker to)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nekstab_next_tpu.cases.cylinder import CylinderCase as JaxCylinderCase
from nekstab_next_tpu.io import load_field as jax_load_field
from nekstab_next_tpu.io import save_field as jax_save_field
from nekstab_next_tpu.mesh.mesh import BoundaryCondition as JaxBC
from nekstab_next_tpu.postproc import bf_sensitivity as jax_bf_sensitivity
from nekstab_next_tpu.postproc import biorthogonalize as jax_biorthogonalize
from nekstab_next_tpu.postproc import velocity_gradient as jax_velocity_gradient
from nekstab_next_tpu.postproc import wave_maker as jax_wave_maker
from nekstab_next_tpu.utils import boundary_quadrature as jax_boundary_quadrature
from nekstab_next_tpu.utils import surface_force_and_torque as jax_surface_force
from nekstab_next_tpu.utils.noise import make_seed as jax_make_seed
from nekstab_next_tpu_torch.cases.cylinder import CylinderCase
from nekstab_next_tpu_torch.io import field_path, load_field, save_field
from nekstab_next_tpu_torch.mesh.mesh import BoundaryCondition as BC
from nekstab_next_tpu_torch.postproc import (
    bf_sensitivity,
    biorthogonalize,
    velocity_gradient,
    wave_maker,
)
from nekstab_next_tpu_torch.utils import (
    boundary_quadrature,
    make_seed,
    surface_force_and_torque,
    velocity_noise,
)

MESH = dict(nr=4, ntheta=8, order=6)
ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "cylinder_out_full")


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread while this module runs: the test suite runs
    several worker processes at once, and torch's thread pools on tiny
    tensors slow down many-fold when they contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel(got, ref) -> float:
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.fixture(scope="module")
def cases():
    """The 32-element cylinder in both packages (the port builds its own
    mesh, which the JAX mesh equals)."""
    return JaxCylinderCase(**MESH), CylinderCase(**MESH, device="cpu")


def fields(case, seed, ncomp=2):
    """Seeded smooth-ish vector fields on the case's mesh (numpy)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(tuple(case.sem.bm.shape) + (ncomp,))


def test_p_to_gll(cases):
    jcase, case = cases
    p = np.random.default_rng(1).standard_normal(case.sem.p_shape)
    assert rel(case.sem.p_to_gll(torch.as_tensor(p)), jcase.sem.p_to_gll(jnp.asarray(p))) <= 1e-12


def test_velocity_gradient(cases):
    jcase, case = cases
    u = fields(case, 2)
    for smooth in (True, False):
        got = velocity_gradient(case.sem, torch.as_tensor(u), smooth=smooth)
        ref = jax_velocity_gradient(jcase.sem, jnp.asarray(u), smooth=smooth)
        assert got.shape == ref.shape == tuple(u.shape) + (2,)
        assert rel(got, ref) <= 1e-12


def test_boundary_quadrature(cases):
    jcase, case = cases
    for tags in ((BC.WALL,), (BC.WALL, BC.DIRICHLET)):
        got = boundary_quadrature(case.mesh, tags=tags)
        ref = jax_boundary_quadrature(jcase.mesh, tags=tuple(JaxBC[t.name] for t in tags))
        for k in ("elems", "ii", "jj"):
            assert np.array_equal(getattr(got, k), getattr(ref, k))
        for k in ("ds", "normal"):
            assert rel(getattr(got, k), getattr(ref, k)) <= 1e-12
    with pytest.raises(ValueError):
        boundary_quadrature(case.mesh, tags=(BC.WALL,), region=lambda x, y: False)


def test_surface_force_and_torque(cases):
    jcase, case = cases
    u, p = fields(case, 3), np.random.default_rng(4).standard_normal(case.sem.p_shape)
    bq, jbq = boundary_quadrature(case.mesh), jax_boundary_quadrature(jcase.mesh)
    for pp in (p, np.asarray(jcase.sem.p_to_gll(jnp.asarray(p)))):  # Gauss and GLL pressure
        got = surface_force_and_torque(case.sem, bq, torch.as_tensor(u), torch.as_tensor(pp),
                                       viscosity=1 / 60, center=(0.1, -0.2))
        ref = jax_surface_force(jcase.sem, jbq, jnp.asarray(u), jnp.asarray(pp),
                                viscosity=1 / 60, center=(0.1, -0.2))
        for g, r in zip(got, ref):
            assert abs(float(g) - float(r)) <= 1e-12 * max(abs(float(r)), 1.0)


def test_sensitivity_maps(cases):
    jcase, case = cases
    arrays = [case.sem.vmask.numpy() * fields(case, s) for s in (5, 6, 7, 8)]
    t = [torch.as_tensor(a) for a in arrays]
    j = [jnp.asarray(a) for a in arrays]
    for g, r in zip(biorthogonalize(case.sem, *t), jax_biorthogonalize(jcase.sem, *j)):
        assert rel(g, r) <= 1e-12
    assert rel(wave_maker(case.sem, *t), jax_wave_maker(jcase.sem, *j)) <= 1e-12
    got, ref = bf_sensitivity(case.sem, *t), jax_bf_sensitivity(jcase.sem, *j)
    assert sorted(got) == sorted(ref) == ["pi", "pr", "si", "sr", "ti", "tr"]
    for k in got:
        assert rel(got[k], ref[k]) <= 1e-12


def test_seeds(cases, tmp_path):
    jcase, case = cases
    # the same numpy generator: the same Krylov seed vector in both packages
    assert rel(velocity_noise(case.sem, seed=7, amplitude=2.0),
               jax_make_seed(jcase.sem, mode="noise", seed=7, amplitude=2.0)) <= 1e-12
    case.sem.mesh = case.mesh
    assert rel(make_seed(case.sem, mode="symmetric"),
               jax_make_seed(jcase.sem, mode="symmetric")) <= 1e-12
    base = fields(case, 9)
    assert rel(make_seed(case.sem, mode="baseflow", base_u=torch.as_tensor(base)),
               jax_make_seed(jcase.sem, mode="baseflow", base_u=jnp.asarray(base))) <= 1e-12
    path = save_field(str(tmp_path / "seed.npz"), base)
    assert rel(make_seed(case.sem, mode="load", path=path),
               jax_make_seed(jcase.sem, mode="load", path=path)) <= 1e-12
    with pytest.raises(ValueError):
        make_seed(case.sem, mode="nope")


def test_field_files_cross_packages(tmp_path):
    rng = np.random.default_rng(10)
    u, p = rng.standard_normal((3, 4, 4, 2)), rng.standard_normal((3, 2, 2))
    meta = dict(reynolds=60.0, eigenvalue=[0.1, -0.7])
    mine = save_field(field_path(str(tmp_path / "port"), "BF", "cyl", 1),
                      torch.as_tensor(u, dtype=torch.float32), p=torch.as_tensor(p),
                      time=1.5, **meta)
    theirs = jax_save_field(str(tmp_path / "jax" / "BF_cyl_00001.npz"),
                            jnp.asarray(u, jnp.float32), p=jnp.asarray(p), time=1.5, **meta)
    assert mine.endswith(os.path.join("port", "BF_cyl_00001.npz"))
    # the same members, dtypes and values: each package reads the other's
    with np.load(mine) as a, np.load(theirs) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    for path in (mine, theirs):
        f, jf = load_field(path), jax_load_field(path)
        assert np.array_equal(f.u, jf.u) and np.array_equal(f.p, jf.p)
        assert f.t is None and f.time == jf.time == 1.5 and f.meta == jf.meta == meta


@pytest.fixture(scope="module")
def flagship():
    """The full-preset artifacts on the 768-element mesh, in both packages."""
    case = CylinderCase(nr=16, ntheta=48, order=6, outer_radius=40.0, device="cpu")
    jcase = JaxCylinderCase(nr=16, ntheta=48, order=6, outer_radius=40.0)
    with open(os.path.join(ARTIFACTS, "summary.json")) as f:
        summary = json.load(f)
    load = lambda name: load_field(os.path.join(ARTIFACTS, f"{name}_cyl_00001.npz"))
    return case, jcase, summary, load


def test_artifact_drag(flagship):
    # Cd = 2 Fx of the full-preset base flow: the port and JAX agree to
    # 1e-13 and both give summary.json's cd (measured 2.2e-15 relative)
    case, jcase, summary, load = flagship
    bf = load("BF")
    assert bf.u.shape == tuple(case.sem.bm.shape) + (2,) and bf.p.shape == case.sem.p_shape
    fx = surface_force_and_torque(case.sem, boundary_quadrature(case.mesh, tags=(BC.WALL,)),
                                  torch.as_tensor(bf.u), torch.as_tensor(bf.p), viscosity=1 / 60)[0]
    jfx = jax_surface_force(jcase.sem, jax_boundary_quadrature(jcase.mesh, tags=(JaxBC.WALL,)),
                            jnp.asarray(bf.u), jnp.asarray(bf.p), viscosity=1 / 60)[0]
    assert abs(2 * float(fx) - 2 * float(jfx)) <= 1e-13 * summary["cd"]
    assert abs(2 * float(fx) - summary["cd"]) <= 1e-12 * summary["cd"]


def test_artifact_wavemaker(flagship):
    # the wavemaker of the saved direct and adjoint modes against the saved
    # wavemaker (measured 1.0e-14 relative), the same peak value and node
    case, jcase, summary, load = flagship
    modes = [load(k).u for k in ("dRe", "dIm", "aRe", "aIm")]
    wm = wave_maker(case.sem, *(torch.as_tensor(m) for m in modes)).numpy()
    jwm = np.asarray(jax_wave_maker(jcase.sem, *(jnp.asarray(m) for m in modes)))
    saved = load("wm").u[..., 0]
    assert rel(wm, jwm) <= 1e-13
    assert rel(wm, saved) <= 1e-12
    ix = int(np.argmax(wm))
    peak = summary["wavemaker_peak"]
    assert ix == int(np.argmax(saved))
    assert abs(wm.max() - peak["value"]) <= 1e-12 * peak["value"]
    assert (case.mesh.x.reshape(-1)[ix], case.mesh.y.reshape(-1)[ix]) == (peak["x"], peak["y"])
