"""Time one grid-wide barrier on the card, with and without a deterministic
all-reduce of one double: cooperative_groups' ``grid.sync()`` against the
arrive/wait barrier that the whole-solve CG kernels use
(``nekstab_next_tpu_torch/csrc/sem_device.cuh``).

    python3 tools_torch/grid_barrier_probe.py

Builds ``grid_barrier_probe.cu`` with nvcc (sm_90a) into the package's
git-ignored ``_build/``, launches a persistent cooperative kernel of 256
threads a block for a number of rounds at several grid sizes (192 blocks is
the flagship launch of both kernels), and prints microseconds per round by
CUDA events, with the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

VARIANTS = ("grid.sync()", "arrive/wait", "grid.sync() + all-reduce (before)",
            "arrive/wait + all-reduce (now)")
GRIDS = (66, 132, 192, 264, 528, 1056)
ROUNDS = 2000


def main() -> None:
    import torch

    from nekstab_next_tpu_torch.ops import _cuda

    if not torch.cuda.is_available():
        raise SystemExit("grid_barrier_probe: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    src = Path(__file__).with_suffix(".cu")
    lib_path = _cuda.BUILD_DIR / "libgrid_barrier_probe.so"
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC),
                    "-o", str(lib_path), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.nsk_grid_barrier_probe.argtypes = [I, I, I, I, P, P, P, P]
    lib.nsk_grid_barrier_probe_resident.argtypes = [I]
    resident = lib.nsk_grid_barrier_probe_resident(0)
    print(f"[{card}] grid barrier probe: 256 threads a block, at most {resident} "
          f"resident blocks, {ROUNDS} rounds a launch", flush=True)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for grid in GRIDS:
        if grid > resident:
            continue
        cells = []
        for variant in range(len(VARIANTS)):
            def launch():
                bar = torch.zeros(1, dtype=torch.int32, device=dev)
                part = torch.zeros(2 * grid, dtype=torch.float64, device=dev)
                out = torch.zeros(1, dtype=torch.float64, device=dev)
                err = lib.nsk_grid_barrier_probe(0, variant, grid, ROUNDS, bar.data_ptr(),
                                                 part.data_ptr(), out.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"probe launch: CUDA error {err}")
                return out
            launch()
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = launch()
            end.record()
            torch.cuda.synchronize()
            cells.append(f"{VARIANTS[variant]} {start.elapsed_time(end) * 1e3 / ROUNDS:.3f} us")
            if variant >= 2:
                cells[-1] += f" (sum {float(out[0])!r})"
        print(f"[{card}] {grid} blocks: " + "; ".join(cells), flush=True)


if __name__ == "__main__":
    main()
