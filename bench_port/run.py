"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the checkout's root, on a machine with the CUDA devices the cell asks
for (see README.md)."""

import time

T_PROCESS = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

# one process, one thread of host compute: the run's host work is dispatch
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_v] = "1"

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from bench_port.harness.main import cli

    sys.exit(cli(sys.argv[1:], t_process=T_PROCESS, root=ROOT))
