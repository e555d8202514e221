"""Host-side logic of the fused local Helmholtz kernel (K4) that the CPU can
check: the launch grid and the kernel's walk over element groups, the D
factor the wrapper hands the kernel, and the C entry points the ``ctypes``
bindings name.  The kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import re

import pytest
import torch

from nekstab_next_tpu_torch.mesh import box_mesh_2d, box_mesh_3d
from nekstab_next_tpu_torch.ops import _cuda
from nekstab_next_tpu_torch.ops.core import SEM
from nekstab_next_tpu_torch.ops.core3 import SEM3
from nekstab_next_tpu_torch.ops.fused_helmholtz import (
    FusedHelmholtz,
    block_groups,
    launch_grid,
)


@pytest.mark.parametrize("per_block,fit", [(1, 1), (2, 3), (3, 5), (4, 2), (9, 7), (16, 4)])
def test_walk_covers_every_element_once(per_block, fit):
    # every element count from one element to three times what the grid
    # holds at once: each element in exactly one block's groups, each group
    # a contiguous run of at most per_block elements
    for E in range(1, 3 * fit * per_block + 2):
        grid = launch_grid(E, per_block, fit)
        groups = -(-E // per_block)
        assert grid == min(groups, fit) and 1 <= grid <= fit
        seen = []
        for b in range(grid):
            runs = block_groups(b, grid, E, per_block)
            assert runs, "every block of the grid owns a group"
            for first, count in runs:
                assert first % per_block == 0 and 1 <= count <= per_block
                seen.extend(range(first, first + count))
        assert sorted(seen) == list(range(E))


def test_walk_strides_by_the_grid():
    # block 1 of 3, groups of 2 elements over 13 elements: groups 1, 4 (the
    # last group holds the one element left)
    assert block_groups(1, 3, 13, 2) == [(2, 2), (8, 2)]
    assert block_groups(0, 3, 13, 2) == [(0, 2), (6, 2), (12, 1)]


@pytest.mark.parametrize("dim", [2, 3])
def test_wrapper_hands_the_kernel_d_on_the_host(dim):
    # D travels in the kernel's parameters, so the wrapper keeps a float32
    # host copy equal to the SEM's D
    sem = (SEM(box_mesh_2d(2, 2, order=5), device="cpu") if dim == 2
           else SEM3(box_mesh_3d(2, 2, 2, order=4), device="cpu"))
    k4 = FusedHelmholtz(sem)
    assert k4._D_host.device.type == "cpu" and k4._D_host.dtype == torch.float32
    assert k4._D_host.is_contiguous()
    assert torch.equal(k4._D_host, sem.D.to(torch.float32))
    assert k4.launches == 0 and k4.grid == 0


def _c_params(name: str) -> int:
    """Parameter count of the C entry point ``name`` in its source."""
    stems = [p.stem for p in _cuda.CSRC.glob("*.cu")]
    src = (_cuda.CSRC / f"{_cuda._source_of(name, stems)}.cu").read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert m, f"{name} is not defined in its source"
    return len(m.group(1).split(","))


@pytest.mark.parametrize("name", sorted(_cuda._SIGNATURES))
def test_bindings_match_the_c_entry_points(name):
    # each ctypes signature resolves to the source that defines the entry
    # point and has one type per C parameter
    assert _c_params(name) == len(_cuda._SIGNATURES[name])
