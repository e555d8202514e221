"""The port's entry points run on the card unless the caller asks for the
CPU: without ``device=`` they take the current CUDA device, and without one
they raise (never a quiet CPU fallback).  Whether there is a card is decided
inside each test."""

import numpy as np
import pytest
import torch

from nekstab_next_tpu_torch import resolve_device
from nekstab_next_tpu_torch.cases.cube import CubeRoughnessCase
from nekstab_next_tpu_torch.cases.cylinder import CylinderCase
from nekstab_next_tpu_torch.interop import sem3_from_arrays, sem_from_arrays
from nekstab_next_tpu_torch.mesh import box_mesh_2d, box_mesh_3d
from nekstab_next_tpu_torch.ops.core import SEM, sem_factors
from nekstab_next_tpu_torch.ops.core3 import SEM3, sem3_factors

SMALL_CUBE = dict(nx=3, ny=2, nz=2, order=3, lx=3.0, ly=2.0, lz=2.0, cube_x=1.5)

ENTRY_POINTS = {
    "SEM": lambda: SEM(box_mesh_2d(2, 2, order=3)),
    "SEM3": lambda: SEM3(box_mesh_3d(2, 2, 2, order=3)),
    "CylinderCase": lambda: CylinderCase(nr=2, ntheta=4, order=3).sem,
    "CubeRoughnessCase": lambda: CubeRoughnessCase(**SMALL_CUBE).sem,
    "sem_from_arrays": lambda: sem_from_arrays(sem_factors(box_mesh_2d(2, 2, order=3))),
    "sem3_from_arrays": lambda: sem3_from_arrays(sem3_factors(box_mesh_3d(2, 2, 2, order=3))),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_is_the_card(name):
    if torch.cuda.is_available():
        sem = ENTRY_POINTS[name]()
        assert sem.device.type == "cuda" and sem.bm.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            ENTRY_POINTS[name]()


def test_explicit_cpu_runs_on_the_cpu():
    case = CubeRoughnessCase(**SMALL_CUBE, device="cpu")
    assert case.sem.device == torch.device("cpu")
    assert case.u_bc.device.type == "cpu" and case.initial_flow().device.type == "cpu"
    assert resolve_device("cpu") == torch.device("cpu")
    assert np.isfinite(case.initial_flow().numpy()).all()
