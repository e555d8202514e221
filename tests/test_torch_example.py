"""``examples_torch/cylinder_stability.py`` (the port's cylinder pipeline)
runs to its end on the CPU on a tiny preset and writes what the JAX
script writes; the port's pipeline imports no jax."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "examples_torch", "cylinder_stability.py")
# 32 elements at order 3, Re = 1 (Newton converges in 4 iterations), a
# 2-step horizon, 8 Krylov vectors; --tol 1 stops Krylov-Schur after one pass
TINY = dict(nr=4, ntheta=8, order=3, outer_radius=5.0, k_dim=8, horizon=0.007,
            settle=60, newton_kdim=20)


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
    spec = importlib.util.spec_from_file_location("cylinder_stability_torch", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def keys(d: dict) -> dict:
    return {k: keys(v) if isinstance(v, dict) else None for k, v in d.items()}


def test_example_runs_to_the_end(tmp_path, monkeypatch):
    example = load_example()
    monkeypatch.setitem(example.PRESETS, "quick", TINY)
    monkeypatch.setenv("NEKSTAB_CPU", "1")
    monkeypatch.setattr(sys, "argv", ["cylinder_stability.py", "--outdir", str(tmp_path),
                                      "--reynolds", "1", "--tol", "1"])
    example.main()
    with open(tmp_path / "summary.json") as f:
        summary = json.load(f)
    with open(os.path.join(ROOT, "cylinder_out_full", "summary.json")) as f:
        reference = json.load(f)
    # the JAX script's keys (its full-preset summary)
    assert keys(summary) == keys(reference)
    assert summary["preset"] == "quick" and summary["precision"] == "f64"
    assert summary["nelem"] == 32 and summary["newton_residual"] < 1e-9
    for mode in ("direct", "adjoint"):
        assert summary[mode]["n_matvecs"] == TINY["k_dim"]
        assert all(np.isfinite(v) for v in summary[mode].values())
    assert np.isfinite(summary["cd"]) and np.isfinite(summary["wavemaker_peak"]["value"])
    written = sorted(os.listdir(tmp_path))
    expected = sorted(os.listdir(os.path.join(ROOT, "cylinder_out_full")))
    assert written == expected


def test_example_mixed_precision_runs_to_the_end(tmp_path, monkeypatch, capsys):
    # the JAX script's two-phase route: the f32 warm phase on the fused
    # path, then the fused-IR stepper for the Newton polish and the eigen
    # stages (here the kernels' plain versions: CPU tensors)
    example = load_example()
    monkeypatch.setitem(example.PRESETS, "quick", TINY)
    monkeypatch.setenv("NEKSTAB_CPU", "1")
    monkeypatch.setattr(sys, "argv", ["cylinder_stability.py", "--outdir", str(tmp_path),
                                      "--reynolds", "1", "--tol", "1",
                                      "--precision", "mixed"])
    example.main()
    out = capsys.readouterr().out
    assert "f32 DNS settle" in out and "f32 Newton warm" in out
    with open(tmp_path / "summary.json") as f:
        summary = json.load(f)
    assert summary["precision"] == "mixed" and summary["newton_residual"] < 1e-9
    for mode in ("direct", "adjoint"):
        assert summary[mode]["n_matvecs"] == TINY["k_dim"]
        assert all(np.isfinite(v) for v in summary[mode].values())


def test_pipeline_imports_no_jax():
    # in a fresh interpreter: this process has jax loaded (tests/conftest.py);
    # the pipeline's modules, the periodic-base and forced-response ones,
    # the thermal path's and the remaining single-device ones, this example,
    # the UPO, resolvent-sweep and Taylor-Green examples and their tools
    scripts = [SCRIPT] + [os.path.join(ROOT, p) for p in (
        "examples_torch/cylinder_upo.py", "examples_torch/cylinder_resolvent_sweep.py",
        "examples_torch/taylor_green.py",
        "tools_torch/merge_resolvent_sweep.py", "tools_torch/upo_newton.py")]
    code = (
        "import sys, importlib.util\n"
        "import nekstab_next_tpu_torch.algorithms.stability, "
        "nekstab_next_tpu_torch.algorithms.newton, "
        "nekstab_next_tpu_torch.algorithms.resolvent, "
        "nekstab_next_tpu_torch.algorithms.harmonic, "
        "nekstab_next_tpu_torch.stepper.linearized, "
        "nekstab_next_tpu_torch.postproc.sensitivity, nekstab_next_tpu_torch.krylov, "
        "nekstab_next_tpu_torch.io, nekstab_next_tpu_torch.utils, "
        "nekstab_next_tpu_torch.ops.exchange, nekstab_next_tpu_torch.ops.fused_cg, "
        "nekstab_next_tpu_torch.cases.rayleigh_benard, nekstab_next_tpu_torch.stepper.fst, "
        "nekstab_next_tpu_torch.stepper.state, nekstab_next_tpu_torch.io.checkpoint, "
        "nekstab_next_tpu_torch.io.nek, nekstab_next_tpu_torch.postproc.vortex, "
        "nekstab_next_tpu_torch.postproc.stats, nekstab_next_tpu_torch.postproc.budget, "
        "nekstab_next_tpu_torch.utils.diagnostics, nekstab_next_tpu_torch.interop\n"
        f"for i, path in enumerate({scripts!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'ex{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not [m for m in sys.modules if m.startswith('nekstab_next_tpu.')]\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
