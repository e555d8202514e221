"""Carry state across from the JAX package without importing it.

:func:`sem_from_arrays` builds the port's ``SEM`` from the JAX ``SEM``'s
precomputed factors passed as numpy arrays, so both packages compute with
identical factors; :func:`sem_arrays` collects them from a JAX ``SEM``::

    sem = sem_from_arrays(sem_arrays(jax_sem), device="cuda")

:func:`sem3_arrays` and :func:`sem3_from_arrays` do the same for a 3-D
``SEM3``.  ``device`` defaults to the current CUDA device and raises without
one: CPU callers pass ``device="cpu"``.

This module imports no jax: ``np.asarray`` of a jax array needs none.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ops.core import FLOAT_KEYS, INT_KEYS, SEM
from .ops.core3 import FLOAT_KEYS3, INT_KEYS3, SEM3

SEM_ARRAY_KEYS = FLOAT_KEYS + INT_KEYS + ("pblock_inv",)
SEM3_ARRAY_KEYS = FLOAT_KEYS3 + INT_KEYS3
SEM_META_KEYS = ("nglobal", "has_pressure_dirichlet")


def sem_arrays(jax_sem) -> dict:
    """The factor arrays (numpy) and metadata of a JAX ``SEM``, by
    attribute name; ``pblock_inv`` is None until the JAX SEM has built it."""
    arrays = {k: (None if getattr(jax_sem, k) is None else np.asarray(getattr(jax_sem, k)))
              for k in SEM_ARRAY_KEYS}
    arrays.update({k: getattr(jax_sem, k) for k in SEM_META_KEYS})
    return arrays


def sem_from_arrays(arrays: dict, device=None,
                    dtype: Optional[torch.dtype] = None) -> SEM:
    """The port's SEM from a dict of the JAX SEM's factor arrays (names as
    the JAX SEM's attributes: :data:`SEM_ARRAY_KEYS` plus
    :data:`SEM_META_KEYS`).  Float factors take ``dtype`` (float64 when
    None); ``pblock_inv`` is installed as given when present."""
    missing = [k for k in FLOAT_KEYS + INT_KEYS + SEM_META_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"sem_from_arrays: missing {missing}")
    a = {k: (v if k in SEM_META_KEYS or v is None else np.asarray(v))
         for k, v in arrays.items()}
    return SEM.from_arrays(a, dtype=dtype, device=device)


def sem3_arrays(jax_sem3) -> dict:
    """The factor arrays (numpy) and metadata of a JAX ``SEM3``, by
    attribute name."""
    arrays = {k: np.asarray(getattr(jax_sem3, k)) for k in SEM3_ARRAY_KEYS}
    arrays.update({k: getattr(jax_sem3, k) for k in SEM_META_KEYS})
    return arrays


def sem3_from_arrays(arrays: dict, device=None,
                     dtype: Optional[torch.dtype] = None) -> SEM3:
    """The port's SEM3 from a dict of the JAX SEM3's factor arrays (names
    as the JAX SEM3's attributes: :data:`SEM3_ARRAY_KEYS` plus
    :data:`SEM_META_KEYS`).  Float factors take ``dtype`` (float64 when
    None)."""
    missing = [k for k in SEM3_ARRAY_KEYS + SEM_META_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"sem3_from_arrays: missing {missing}")
    a = {k: (v if k in SEM_META_KEYS else np.asarray(v)) for k, v in arrays.items()}
    return SEM3.from_arrays(a, dtype=dtype, device=device)
