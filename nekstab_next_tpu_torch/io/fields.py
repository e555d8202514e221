"""Snapshot container: one ``.npz`` per field with metadata (a numpy copy
of ``nekstab_next_tpu/io/fields.py``).

The files are the JAX package's, byte for byte in layout: the same keys
(``u``, ``time``, optional ``p`` and ``t``, ``meta_json``), float64 arrays,
``np.savez_compressed``; each package reads the other's files.  Tensors are
copied to the host first.  The ``time`` entry carries physical time (and,
by the reference's convention, the orbit period for UPO restarts)."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class FieldFile:
    u: np.ndarray  # (nelem, n, n, ndim)
    p: Optional[np.ndarray]  # (nelem, n, n) or None
    t: Optional[np.ndarray]  # temperature / scalar or None
    time: float
    meta: dict


def _host(x) -> np.ndarray:
    """A float64 host copy of a tensor or array."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def field_path(directory: str, prefix: str, session: str, index: int) -> str:
    """Reference naming convention: ``<prefix><session>0.f<index:05d>`` ->
    ``<prefix>_<session>_<index:05d>.npz``."""
    return os.path.join(directory, f"{prefix}_{session}_{index:05d}.npz")


def save_field(
    path: str,
    u,
    p=None,
    t=None,
    time: float = 0.0,
    **meta,
) -> str:
    """Write one snapshot (arrays copied to host numpy, f64)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"u": _host(u), "time": np.asarray(float(time))}
    if p is not None:
        payload["p"] = _host(p)
    if t is not None:
        payload["t"] = _host(t)
    payload["meta_json"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    np.savez_compressed(path, **payload)
    return path


def load_field(path: str) -> FieldFile:
    with np.load(path) as z:
        meta = {}
        if "meta_json" in z:
            meta = json.loads(bytes(z["meta_json"].tobytes()).decode())
        return FieldFile(
            u=z["u"],
            p=z["p"] if "p" in z else None,
            t=z["t"] if "t" in z else None,
            time=float(z["time"]),
            meta=meta,
        )
