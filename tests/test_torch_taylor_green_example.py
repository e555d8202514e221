"""``examples_torch/taylor_green.py`` end to end on the CPU, in a fresh
interpreter that imports no jax, against ``examples/taylor_green.py``: the
same five lines, every number within 1e-6 relative (the lines print 4-7
digits; the two packages' steps agree far closer)."""

import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT, NEKSTAB_CPU="1"))
    assert out.returncode == 0, out.stderr
    return out.stdout


def numbers(line: str) -> np.ndarray:
    return np.array([float(x) for x in re.findall(r"[-+]?\d+\.\d+(?:e[-+]\d+)?", line)])


def test_taylor_green_example_prints_the_jax_lines():
    port = run("import runpy, sys\n"
               "runpy.run_path('examples_torch/taylor_green.py', run_name='__main__')\n"
               "assert 'jax' not in sys.modules, 'jax imported'\n")
    ref = run("import runpy\nrunpy.run_path('examples/taylor_green.py', run_name='__main__')\n")
    port, ref = port.splitlines(), ref.splitlines()
    assert len(port) == len(ref) == 5
    for a, b in zip(port, ref):
        assert a.split("|u|")[0] == b.split("|u|")[0]  # "step k t=..."
        assert np.allclose(numbers(a), numbers(b), rtol=1e-6, atol=0), (a, b)
