"""The port's backward-facing-step case (``cases/bfs.py``), the campaign
runner (``campaign.py``) and the transient-growth example
(``examples_torch/bfs_transient_growth.py``).

* The case against the JAX package's on the quick, barkley and full
  presets (mesh builds only, no steps): ``mesh.gid``, the inflow
  ``u_bc``, the sponge field and its masked weight, ``dt`` and the initial
  flow are equal (the same host numpy code);
* the ``tests/test_campaign.py`` analogs (order, resume, residual gate,
  failure record);
* the example end to end on a tiny preset in a fresh interpreter on the
  CPU, which must not import jax; and the example's and tools' imports."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from examples.bfs_transient_growth import PRESETS as JAX_PRESETS
from examples.bfs_transient_growth import build_case as jax_build_case
from nekstab_next_tpu.cases.bfs import _geometric_breaks as jax_breaks
from nekstab_next_tpu_torch.campaign import (
    Campaign, GateError, Stage, artifact_exists, residual_gate,
)
from nekstab_next_tpu_torch.cases.bfs import BackwardFacingStepCase, _geometric_breaks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "examples_torch", "bfs_transient_growth.py")
# 10 elements at order 3, a 2-time-unit march, 40-step f64 march chunks,
# one 3-step horizon, k_dim 6; the case built at Re 1 (the steady state is
# reached at once; at Re 500 this mesh does not settle)
TINY = dict(order=3, eu=2, ed=4, ey=2, outflow=6.0, k_dim=6, horizons=(0.3,))


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread while this module runs: the test suite runs
    several worker processes at once, and torch's thread pools on tiny
    tensors slow down many-fold when they contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load_example():
    spec = importlib.util.spec_from_file_location("bfs_transient_growth_torch", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("args", [(0.0, 10.0, 8, 0.22), (0.0, 50.0, 28, 0.22),
                                  (0.0, 50.0, 40, 0.1), (0.0, 3.0, 10, 0.5)])
def test_geometric_breaks_match_jax(args):
    np.testing.assert_array_equal(_geometric_breaks(*args), jax_breaks(*args))


@pytest.mark.parametrize("preset", ["quick", "barkley", "full"])
def test_case_matches_jax(preset):
    P = JAX_PRESETS[preset]
    example = load_example()
    assert example.PRESETS[preset] == P
    jcase = jax_build_case(P)
    case = example.build_case(P, device="cpu")
    assert case.sponge == bool(P.get("sponge", False))
    np.testing.assert_array_equal(case.mesh.gid, np.asarray(jcase.mesh.gid))
    np.testing.assert_array_equal(case.mesh.x, np.asarray(jcase.mesh.x))
    assert case.sem.has_pressure_dirichlet and jcase.sem.has_pressure_dirichlet
    np.testing.assert_array_equal(case.u_bc.numpy(), np.asarray(jcase.u_bc))
    np.testing.assert_array_equal(case.sem.sponge.numpy(), np.asarray(jcase.sem.sponge))
    np.testing.assert_array_equal(case.sem.bms.numpy(), np.asarray(jcase.sem.bms))
    assert case.dt == jcase.dt
    np.testing.assert_array_equal(case.initial_flow().numpy(),
                                  np.asarray(jcase.initial_flow()))
    # the carved step: the corner vertex is shared by 3 elements, not 4
    counts = np.bincount(case.mesh.gid.reshape(-1))
    corner = np.flatnonzero((np.abs(case.mesh.x) < 1e-12) & (np.abs(case.mesh.y) < 1e-12))
    assert counts[case.mesh.gid.reshape(-1)[corner[0]]] == 3


def test_case_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        assert BackwardFacingStepCase(order=3, elems_upstream=1, elems_downstream=2,
                                      elems_y=2).sem.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BackwardFacingStepCase(order=3, elems_upstream=1, elems_downstream=2, elems_y=2)


def _touch(workdir, name, content="x\n"):
    with open(os.path.join(workdir, name), "w") as fh:
        fh.write(content)


def test_stages_run_in_order_and_resume(tmp_path):
    wd = str(tmp_path)
    calls = []

    def mk(name, artifact):
        def run(w):
            calls.append(name)
            _touch(w, artifact)
            return {"n": len(calls)}

        return Stage(name, run, done=artifact_exists(artifact))

    stages = [mk("baseflow", "BF.npz"), mk("direct", "spec_d.dat")]
    rep = Campaign(wd, stages).run()
    assert calls == ["baseflow", "direct"]
    assert rep["baseflow"]["status"] == "done" and rep["direct"]["n"] == 2
    # resume: nothing re-runs (artifacts and report both present)
    rep2 = Campaign(wd, stages).run()
    assert calls == ["baseflow", "direct"]
    assert rep2["direct"]["status"] == "done"
    with open(os.path.join(wd, "report.json")) as fh:
        assert json.load(fh)["baseflow"]["status"] == "done"
    # a missing artifact re-runs its stage only
    os.remove(os.path.join(wd, "spec_d.dat"))
    Campaign(wd, stages).run()
    assert calls == ["baseflow", "direct", "direct"]


def test_residual_gate_blocks(tmp_path):
    wd = str(tmp_path)
    _touch(wd, "residu_newton.dat", "1 1e-3\n2 1e-7\n")
    st = Stage("direct", lambda w: {}, gate=residual_gate("residu_newton.dat", 1e-10))
    with pytest.raises(GateError):
        Campaign(wd, [st]).run()
    with open(os.path.join(wd, "report.json")) as fh:
        assert json.load(fh)["direct"]["status"] == "gated"
    st2 = Stage("direct", lambda w: {}, gate=residual_gate("residu_newton.dat", 1e-6))
    assert Campaign(wd, [st2]).run()["direct"]["status"] == "done"
    with pytest.raises(GateError, match="missing"):
        Campaign(wd, [Stage("x", lambda w: {}, gate=residual_gate("nope.dat", 1.0))]).run()


def test_failure_is_recorded(tmp_path):
    wd = str(tmp_path)

    def boom(w):
        raise ValueError("solver diverged")

    with pytest.raises(ValueError):
        Campaign(wd, [Stage("bad", boom)]).run()
    with open(os.path.join(wd, "report.json")) as fh:
        rep = json.load(fh)
    assert rep["bad"]["status"] == "failed"
    assert "solver diverged" in rep["bad"]["error"]
    # stop_on_error=False records the failure and returns
    rep = Campaign(wd, [Stage("bad", boom)]).run(stop_on_error=False)
    assert rep["bad"]["status"] == "failed"


def test_example_runs_to_the_end_without_jax(tmp_path):
    # in a fresh interpreter (this one has jax loaded, tests/conftest.py):
    # the tiny preset end to end on the CPU, base flow and growth stages,
    # then a rerun that skips both
    code = (
        "import sys, importlib.util\n"
        f"spec = importlib.util.spec_from_file_location('ex', {SCRIPT!r})\n"
        "ex = importlib.util.module_from_spec(spec); spec.loader.exec_module(ex)\n"
        f"ex.PRESETS['quick'] = {TINY!r}\n"
        "ex.MARCH_TIME, ex.CHUNK = 2.0, 40\n"
        "case = ex.BackwardFacingStepCase\n"
        "ex.BackwardFacingStepCase = lambda **kw: case(**dict(kw, reynolds=1.0))\n"
        f"sys.argv = ['bfs_transient_growth.py', '--outdir', {str(tmp_path)!r}]\n"
        "ex.main(); ex.main()\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not [m for m in sys.modules if m.startswith('nekstab_next_tpu.')]\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT, NEKSTAB_CPU="1", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[bfs] boostconv reached" in out.stdout and "[bfs] G(0.3) =" in out.stdout
    with open(tmp_path / "report.json") as fh:
        report = json.load(fh)
    assert report["baseflow"]["status"] == "done" and report["baseflow"]["residual"] < 2e-6
    (point,) = report["transient_growth"]["points"]
    assert point["t"] == 0.3 and np.isfinite(point["G"]) and point["G_barkley"] is None
    with open(tmp_path / "growth.json") as fh:
        assert json.load(fh) == report["transient_growth"]["points"]
    assert sorted(os.listdir(tmp_path)) == ["BF_bfs_00001.npz", "growth.json", "report.json"]


def test_tools_import_no_jax():
    code = (
        "import sys, importlib.util\n"
        "for name in ('examples_torch/bfs_transient_growth.py', 'tools_torch/bfs_march.py',\n"
        "             'tools_torch/bfs_tg.py'):\n"
        f"    spec = importlib.util.spec_from_file_location('m', {ROOT!r} + '/' + name)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "import nekstab_next_tpu_torch.campaign, nekstab_next_tpu_torch.cases.bfs, "
        "nekstab_next_tpu_torch.algorithms.fixed_point, nekstab_next_tpu_torch.krylov.svd, "
        "nekstab_next_tpu_torch.ops.schwarz\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not [m for m in sys.modules if m.startswith('nekstab_next_tpu.')]\n"
        "import nekstab_next_tpu_torch.campaign as c\n"
        "assert 'numpy' not in c.__dict__ and 'torch' not in c.__dict__\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
