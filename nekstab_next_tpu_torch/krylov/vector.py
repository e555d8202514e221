"""Krylov vector algebra over tensors and tuples of tensors with a weighted
inner product (port of ``nekstab_next_tpu/krylov/vector.py``).

A "vector" is a tensor or a pytree of tensors (``torch.utils._pytree``);
the inner product is supplied by the operator (mass-weighted,
sponge-masked).  A :class:`Basis` holds ``capacity`` vectors as one
preallocated ``(capacity, *shape)`` tensor per leaf.  Its products are
single batched calls: the dots of a vector against the active columns are
``torch.func.vmap`` of ``space.dot`` over the leading axis (one reduction
for all columns, not a Python loop), and the combinations ``sum_j y_j Q_j``
and the Schur-restart rotation ``Q V`` are ``torch.tensordot``.
Coefficients are cast to each leaf's dtype, so an f32 basis stays f32.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map


class VectorSpace:
    """Bundles the weighted inner product and elementary vector algebra."""

    def __init__(self, dot: Callable[[Any, Any], torch.Tensor]):
        self._dot = dot

    def dot(self, x, y) -> torch.Tensor:
        return self._dot(x, y)

    def norm(self, x) -> torch.Tensor:
        return torch.sqrt(self._dot(x, x))

    def scale(self, a, x):
        return tree_map(lambda l: a * l, x)

    def axpby(self, a, x, b, y):
        return tree_map(lambda lx, ly: a * lx + b * ly, x, y)

    def add(self, x, y):
        return tree_map(torch.add, x, y)

    def sub(self, x, y):
        return tree_map(torch.sub, x, y)

    def zeros_like(self, x):
        return tree_map(torch.zeros_like, x)

    def normalize(self, x):
        n = self.norm(x)
        return self.scale(1.0 / n, x), n


def _coefficients(y, leaf: torch.Tensor) -> torch.Tensor:
    """Host or device coefficients as a tensor of the leaf's dtype and
    device (host f64 coefficients must not promote an f32 basis)."""
    return torch.as_tensor(y, dtype=leaf.dtype, device=leaf.device)


class Basis:
    """Preallocated stacked basis of ``capacity`` vectors (leading axis)."""

    def __init__(self, space: VectorSpace, template, capacity: int):
        self.space = space
        self.capacity = capacity
        self.Q = tree_map(lambda l: l.new_zeros((capacity,) + tuple(l.shape)), template)

    def set(self, j: int, x) -> None:
        tree_map(lambda B, l: B[j].copy_(l), self.Q, x)

    def get(self, j: int):
        return tree_map(lambda B: B[j], self.Q)

    def _dots(self, w, ncols: int) -> torch.Tensor:
        """<q_j, w> for j < ncols, as one batched reduction (none for
        ncols = 0: vmap cannot index into an empty batch)."""
        if ncols == 0:
            return tree_leaves(self.Q)[0].new_zeros(0)
        cols = tree_map(lambda B: B[:ncols], self.Q)
        return torch.func.vmap(lambda q: self.space.dot(q, w))(cols)

    def _combine(self, y: torch.Tensor, ncols: int):
        """sum_{j < ncols} y_j q_j."""
        return tree_map(
            lambda B: torch.tensordot(y[:ncols].to(B.dtype), B[:ncols], dims=1), self.Q)

    def dots(self, w, ncols: Optional[int] = None) -> torch.Tensor:
        """Inner products of w against all (or the first ncols) columns,
        zero beyond ncols (length ``capacity``)."""
        ncols = self.capacity if ncols is None else ncols
        d = self._dots(w, ncols)
        return torch.cat([d, d.new_zeros(self.capacity - ncols)])

    def combine(self, y):
        """Linear combination sum_j y[j] Q_j (the reference's ``k_matmul``);
        ``y`` has length ``capacity`` (zero beyond the active columns) and
        is cast to each leaf's dtype."""
        return tree_map(
            lambda B: torch.tensordot(_coefficients(y, B), B, dims=1), self.Q)

    def ortho_insert(self, w, j: int, reorth: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """Classical Gram-Schmidt of ``w`` against columns 0..j with
        ``reorth`` re-orthogonalization passes, normalized into column
        j+1.  Returns (h, beta) on the device: h the accumulated projection
        coefficients (length ``capacity``, zero beyond j), beta the norm
        before normalization.  Each pass is one batched dot and one
        tensordot."""
        ncols = j + 1
        h = self._dots(w, ncols)
        w1 = self.space.sub(w, self._combine(h, ncols))
        for _ in range(reorth):
            c = self._dots(w1, ncols)
            w1 = self.space.sub(w1, self._combine(c, ncols))
            h = h + c
        beta = self.space.norm(w1)
        self.set(j + 1, self.space.scale(1.0 / beta.clamp_min(1e-300), w1))
        return torch.cat([h, h.new_zeros(self.capacity - ncols)]), beta

    def rotate(self, V) -> None:
        """In place: the first m columns become Q V for V (capacity, m), the
        Schur-condensation rotation; the columns from m on are zeroed."""
        m = np.shape(V)[1]

        def rot(B):
            B[:m] = torch.tensordot(_coefficients(V, B).T, B, dims=1)
            B[m:] = 0
            return B

        tree_map(rot, self.Q)
