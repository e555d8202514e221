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

# the preconditioners the JAX SEM builds on demand (None until built);
# pschwarz is the (pidx, Pinv, w) tuple of its build_pressure_patches
PRECOND_KEYS = ("pblock_inv", "pschwarz", "p0Acinv")
SEM_ARRAY_KEYS = FLOAT_KEYS + INT_KEYS + PRECOND_KEYS
SEM3_ARRAY_KEYS = FLOAT_KEYS3 + INT_KEYS3 + PRECOND_KEYS
SEM_META_KEYS = ("nglobal", "has_pressure_dirichlet")


def _host(v):
    """numpy copies of an array or of a tuple of arrays; None stays None."""
    if v is None:
        return None
    return tuple(np.asarray(x) for x in v) if isinstance(v, tuple) else np.asarray(v)


def _arrays(jax_sem, keys) -> dict:
    arrays = {k: _host(getattr(jax_sem, k)) for k in keys}
    arrays.update({k: getattr(jax_sem, k) for k in SEM_META_KEYS})
    return arrays


def _from_arrays(cls, arrays: dict, required, device, dtype):
    missing = [k for k in tuple(required) + SEM_META_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"{cls.__name__} from arrays: missing {missing}")
    a = {k: (v if k in SEM_META_KEYS else _host(v)) for k, v in arrays.items()}
    return cls.from_arrays(a, dtype=dtype, device=device)


def sem_arrays(jax_sem) -> dict:
    """The factor arrays (numpy) and metadata of a JAX ``SEM``, by
    attribute name; the :data:`PRECOND_KEYS` are None until the JAX SEM has
    built them."""
    return _arrays(jax_sem, SEM_ARRAY_KEYS)


def sem_from_arrays(arrays: dict, device=None,
                    dtype: Optional[torch.dtype] = None) -> SEM:
    """The port's SEM from a dict of the JAX SEM's factor arrays (names as
    the JAX SEM's attributes: :data:`SEM_ARRAY_KEYS` plus
    :data:`SEM_META_KEYS`).  Float factors take ``dtype`` (float64 when
    None); the :data:`PRECOND_KEYS` are installed as given when present (the
    'schwarz' patches with their gather lists built from ``pidx``)."""
    return _from_arrays(SEM, arrays, FLOAT_KEYS + INT_KEYS, device, dtype)


def sem3_arrays(jax_sem3) -> dict:
    """The factor arrays (numpy) and metadata of a JAX ``SEM3``, by
    attribute name; the :data:`PRECOND_KEYS` as :func:`sem_arrays`."""
    return _arrays(jax_sem3, SEM3_ARRAY_KEYS)


def sem3_from_arrays(arrays: dict, device=None,
                     dtype: Optional[torch.dtype] = None) -> SEM3:
    """The port's SEM3 from a dict of the JAX SEM3's factor arrays (names
    as the JAX SEM3's attributes: :data:`SEM3_ARRAY_KEYS` plus
    :data:`SEM_META_KEYS`), the :data:`PRECOND_KEYS` as
    :func:`sem_from_arrays` installs them."""
    return _from_arrays(SEM3, arrays, FLOAT_KEYS3 + INT_KEYS3, device, dtype)
