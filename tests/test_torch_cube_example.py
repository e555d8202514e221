"""``examples_torch/cube_transient_growth.py`` on the CPU.

The example's own case (184 elements at order 4) is built in both packages
and compared; its stages run end to end on the tiny cube of
``tests/test_cube_case.py``, passed in as the case, at a few steps (the
march's chunk and cap and the horizons patched down); its growth point
agrees with JAX's ``svds`` on the same operator from the same start; and
the example imports no jax.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nekstab_next_tpu.algorithms.stability import velocity_space as jax_velocity_space
from nekstab_next_tpu.cases.cube import CubeRoughnessCase as JaxCube
from nekstab_next_tpu.config import SolverConfig as JaxSolverConfig
from nekstab_next_tpu.krylov.svd import svds as jax_svds
from nekstab_next_tpu.stepper.linearized import LinearizedOperator as JaxLinearizedOperator
from nekstab_next_tpu_torch.cases.cube import CubeRoughnessCase

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "examples_torch", "cube_transient_growth.py")
# the tiny cube of tests/test_cube_case.py
TINY_CUBE = dict(reynolds=200.0, h=1.0, lx=6.0, ly=2.0, lz=2.0, cube_x=2.5, cube_z=0.5,
                 nx=6, ny=2, nz=2, order=4, delta=1.0)


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
def example():
    spec = importlib.util.spec_from_file_location("cube_transient_growth_torch", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_case_matches_jax(example):
    """The example's case against the JAX script's parameters: 184
    elements, the same dt, inflow data, solver and viscosity."""
    case = example.make_case(device="cpu")
    s = case.solver
    jcase = JaxCube(
        reynolds=60.0, h=2.0, lx=12.0, ly=4.0, lz=4.0, cube_x=4.0, cube_z=2.0,
        nx=12, ny=4, nz=4, order=4, delta=1.0, target_cfl=0.2,
        solver=JaxSolverConfig(pressure_tol=s.pressure_tol, velocity_tol=s.velocity_tol,
                               pressure_maxiter=s.pressure_maxiter,
                               velocity_maxiter=s.velocity_maxiter))
    assert case.mesh.nelem == jcase.mesh.nelem == 184 and case.order == 4
    assert case.dt == jcase.dt
    np.testing.assert_array_equal(case.u_bc.numpy(), np.asarray(jcase.u_bc))
    np.testing.assert_array_equal(case.initial_flow().numpy(), np.asarray(jcase.initial_flow()))
    assert (s.pressure_tol, s.velocity_tol, s.pressure_maxiter, s.velocity_maxiter) == (
        1e-7, 1e-8, 300, 120)
    assert s.pressure_operator == "pnpn2" and s.pressure_precond == "fdm"
    ns = case.make_ns()
    assert ns._scheme == "pnpn2" and ns.nu == pytest.approx(case.h / case.reynolds)


def test_example_stages_on_the_tiny_cube(example, tmp_path, monkeypatch):
    case = CubeRoughnessCase(**TINY_CUBE, device="cpu")
    monkeypatch.setattr(example, "CHUNK", 2)
    monkeypatch.setattr(example, "MAX_STEPS", 4)
    monkeypatch.setattr(example, "HORIZONS", (case.dt,))
    # svds converges slowly about this unsteady base (164 matvecs to 1e-6):
    # both packages run the same iteration to a loose tolerance
    monkeypatch.setattr(example, "SVDS_TOL", 5e-2)
    out = str(tmp_path / "cube")
    example.main(["--outdir", out, "--k-dim", "6"], case=case)
    with open(os.path.join(out, "report.json")) as fh:
        report = json.load(fh)
    assert report["baseflow"]["status"] == "done" and report["baseflow"]["steps"] == 4
    assert report["growth"]["status"] == "done"
    with open(os.path.join(out, "growth.json")) as fh:
        growth = json.load(fh)
    assert growth["devices"] == 1 and growth["nelem"] == 23 and growth["order"] == 4
    (point,) = growth["points"]
    assert point["nsteps"] == 1 and np.isfinite(point["G"]) and point["G"] > 0.0
    assert point["adjoint_rel"] < 1e-6 and point["svds_residual"] < 5e-2
    # the growth stage ran sharded over one gloo rank, whose shard view is
    # the single-device computation: no cross-check against itself
    assert "G_single_device" not in point and "sharded_vs_single_rel" not in point

    # the same call in the JAX package, about the saved base flow from the
    # same seed-11 start: the same Golub-Kahan iteration
    bf = np.load(os.path.join(out, example.BF_PATH))["u"]
    jcase = JaxCube(**TINY_CUBE)
    jsem = jcase.sem
    rng = np.random.default_rng(11)
    x0 = rng.standard_normal(bf.shape) * np.asarray(jsem.vmask)
    op = JaxLinearizedOperator(jcase.make_ns(), jnp.asarray(bf), nsteps=1)
    ref = jax_svds(op.matvec, op.rmatvec, jax_velocity_space(jsem), jnp.asarray(x0),
                   nsv=1, k_dim=6, tol=5e-2)
    G = float(ref.sigma[0] ** 2)
    assert abs(point["G"] / G - 1.0) < 1e-6, (point["G"], G)
    assert point["n_matvecs"] == int(ref.n_matvecs)


def test_example_imports_no_jax():
    # in a fresh interpreter (this one has jax loaded): the example and the
    # modules this slice added or completed
    code = ("import importlib.util, sys\n"
            "import nekstab_next_tpu_torch.mesh.re2, nekstab_next_tpu_torch.ops.core3, "
            "nekstab_next_tpu_torch.ops.schwarz, nekstab_next_tpu_torch.interop, "
            "nekstab_next_tpu_torch.parallel\n"
            f"spec = importlib.util.spec_from_file_location('m', {EXAMPLE!r})\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not [m for m in sys.modules if m.startswith('nekstab_next_tpu.')]\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]
