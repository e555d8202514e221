"""The shift decomposition of the direct-stiffness sum, as the predicate of
the fused-IR mixed-precision path.

A numpy copy of ``nekstab_next_tpu/ops/exchange.py`` (``build_shift_exchange``
and the dataclasses it returns).  The JAX package's Pallas kernels have no
gather, so they run the direct-stiffness sum as lane rolls and masks, and
they need a mesh whose exchange decomposes into a few constant lane
offsets; the JAX stepper takes its fused-IR path only on such a mesh
(``nekstab_next_tpu/stepper/navier_stokes.py``) and the legacy mixed path
elsewhere.  The port's kernels gather through copy lists and take any
conforming mesh, so the port uses this module only to choose the same
scheme as JAX on every mesh (:func:`shift_decomposes`).

``build_shift_exchange`` returns ``None`` when the mesh is not a conforming
quad mesh or its numbering needs more than ``max_groups`` shift groups; a
decomposition it returns is verified against a bincount sum.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class FaceBucket:
    ext: np.ndarray  # (nfpad, n2p) 0/1: src-face interior nodes in DST order
    dst_face: int  # 0..3 — row block in the face accumulation buffer
    groups: List[Tuple[int, np.ndarray]]  # (shift k, dst-lane mask (nep,))


@dataclasses.dataclass
class CornerBucket:
    cs: int  # src corner row in the (4, nep) corner extraction
    cd: int  # dst corner row in the corner accumulation buffer
    groups: List[Tuple[int, np.ndarray]]


@dataclasses.dataclass
class ShiftExchange:
    """Static data for the roll-based dssum on ``(n2p, nep)`` lanes fields.

    All 0/1 matrices are padded; the face scatter ``fscat`` maps the face
    accumulation buffer (4 row blocks of ``nfpad``) back to nodes, ``cscat``
    the (8, nep) corner buffer.  ``apply_np`` is the numpy reference used
    for build-time verification and CPU tests.
    """

    n: int
    nelem: int
    nep: int
    n2p: int
    nfpad: int
    face_buckets: List[FaceBucket]
    corner_buckets: List[CornerBucket]
    fsel: np.ndarray  # unused by kernels (kept for debugging): (4*nfpad, n2p)
    fscat: np.ndarray  # (n2p, 4*nfpad)
    csel: np.ndarray  # (8, n2p)
    cscat: np.ndarray  # (n2p, 8)

    # -- numpy reference ------------------------------------------------
    def apply_np(self, x: np.ndarray) -> np.ndarray:
        """dssum on an (n2p, nep) field (zero-padded), numpy semantics
        identical to the kernel helper in ops/fused_cg.py."""
        out = x.copy()
        nf = self.nfpad
        facc = np.zeros((4 * nf, self.nep), x.dtype)
        for b in self.face_buckets:
            src = b.ext @ x  # (nfpad, nep)
            for k, mask in b.groups:
                facc[b.dst_face * nf:(b.dst_face + 1) * nf] += (
                    np.roll(src, k, axis=1) * mask[None, :]
                )
        out += self.fscat @ facc
        corners = self.csel @ x  # (8, nep)
        cacc = np.zeros((8, self.nep), x.dtype)
        for b in self.corner_buckets:
            for k, mask in b.groups:
                cacc[b.cd] += np.roll(corners[b.cs], k) * mask
        out += self.cscat @ cacc
        return out


def build_shift_exchange(
    gid: np.ndarray,
    n: int,
    max_groups: int = 96,
    verify: bool = True,
) -> Optional[ShiftExchange]:
    """Build the shift decomposition from the (nelem, n, n) global-id array.

    Returns ``None`` when the mesh is not a conforming quad mesh or its
    numbering needs more than ``max_groups`` total shift groups (fallback:
    the XLA segment-sum dssum)."""
    gid = np.asarray(gid).reshape(-1, n, n)
    E = gid.shape[0]
    if n < 3:
        return None
    n2 = n * n
    n2p = _round_up(n2, 8)
    nep = _round_up(E, 128)
    nfpad = _round_up(n - 2, 8)

    r = np.arange(1, n - 1)
    # face traversal (interior nodes), fixed order; face index W,E,S,N
    faces = [
        (np.zeros_like(r), r),          # W: i = 0
        (np.full_like(r, n - 1), r),    # E: i = n-1
        (r, np.zeros_like(r)),          # S: j = 0
        (r, np.full_like(r, n - 1)),    # N: j = n-1
    ]
    flat_idx = [ii * n + jj for (ii, jj) in faces]
    seqs = [gid[:, ii, jj] for (ii, jj) in faces]  # each (E, n-2)

    bykey = {}
    for f, s in enumerate(seqs):
        for e in range(E):
            key = tuple(sorted(s[e].tolist()))
            bykey.setdefault(key, []).append((e, f))

    # (fd, fs, flip) -> list of (ed, es)
    raw = {}
    for key, members in bykey.items():
        if len(members) == 1:
            continue
        if len(members) > 2:
            return None
        (e1, f1), (e2, f2) = members
        for (ed, fd), (es, fs) in (((e1, f1), (e2, f2)), ((e2, f2), (e1, f1))):
            sd, ss = seqs[fd][ed], seqs[fs][es]
            if np.array_equal(sd, ss):
                flip = False
            elif np.array_equal(sd, ss[::-1]):
                flip = True
            else:
                return None
            raw.setdefault((fd, fs, flip), []).append((ed, es))

    total_groups = 0
    face_buckets: List[FaceBucket] = []
    for (fd, fs, flip), pairs in sorted(raw.items()):
        ext = np.zeros((nfpad, n2p), np.float32)
        rows = flat_idx[fs][::-1] if flip else flat_idx[fs]
        for a, node in enumerate(rows):
            ext[a, node] = 1.0
        shifts = {}
        for ed, es in pairs:
            shifts.setdefault(ed - es, []).append(ed)
        groups = []
        for k, eds in sorted(shifts.items()):
            mask = np.zeros(nep, np.float32)
            mask[np.asarray(eds)] = 1.0
            groups.append((int(k), mask))
        total_groups += len(groups)
        face_buckets.append(FaceBucket(ext=ext, dst_face=fd, groups=groups))

    # vertex assembly
    ci = np.array([0, 0, n - 1, n - 1])
    cj = np.array([0, n - 1, 0, n - 1])
    cnodes = ci * n + cj
    cg = gid[:, ci, cj]  # (E, 4)
    byvert = {}
    for e in range(E):
        for c in range(4):
            byvert.setdefault(int(cg[e, c]), []).append((e, c))
    raw_c = {}
    for v, members in byvert.items():
        for (ed, cd) in members:
            for (es, cs) in members:
                if es == ed and cs == cd:
                    continue
                raw_c.setdefault((cd, cs, ed - es), []).append(ed)
    corner_buckets: List[CornerBucket] = []
    merged = {}
    for (cd, cs, k), eds in sorted(raw_c.items()):
        mask = np.zeros(nep, np.float32)
        mask[np.asarray(eds)] = 1.0
        merged.setdefault((cd, cs), []).append((int(k), mask))
    for (cd, cs), groups in sorted(merged.items()):
        total_groups += len(groups)
        corner_buckets.append(CornerBucket(cs=cs, cd=cd, groups=groups))

    if total_groups > max_groups:
        return None

    # selectors / scatters
    fsel = np.zeros((4 * nfpad, n2p), np.float32)
    fscat = np.zeros((n2p, 4 * nfpad), np.float32)
    for f in range(4):
        for a, node in enumerate(flat_idx[f]):
            fsel[f * nfpad + a, node] = 1.0
            fscat[node, f * nfpad + a] = 1.0
    csel = np.zeros((8, n2p), np.float32)
    cscat = np.zeros((n2p, 8), np.float32)
    for c, node in enumerate(cnodes):
        csel[c, node] = 1.0
        cscat[node, c] = 1.0

    ex = ShiftExchange(
        n=n, nelem=E, nep=nep, n2p=n2p, nfpad=nfpad,
        face_buckets=face_buckets, corner_buckets=corner_buckets,
        fsel=fsel, fscat=fscat, csel=csel, cscat=cscat,
    )

    if verify:
        rng = np.random.default_rng(12345)
        u = rng.standard_normal((E, n, n))
        # reference dssum via bincount over gid
        flat = u.reshape(-1)
        g = np.bincount(gid.reshape(-1), weights=flat,
                        minlength=int(gid.max()) + 1)
        ref = g[gid.reshape(-1)].reshape(E, n2)
        x = np.zeros((n2p, nep))
        x[:n2, :E] = u.reshape(E, n2).T
        got = ex.apply_np(x)
        if not np.allclose(got[:n2, :E].T, ref, rtol=1e-12, atol=1e-9):
            return None

    return ex


def get_exchange(sem) -> Optional[ShiftExchange]:
    """The shift exchange of a 2-D SEM's numbering, built once and cached on
    the SEM; None if the mesh does not decompose (JAX ``get_exchange``)."""
    if getattr(sem, "_shift_exchange", "unset") == "unset":
        sem._shift_exchange = build_shift_exchange(
            sem.gid_np.reshape(sem.nelem, sem.n, sem.n), sem.n)
    return sem._shift_exchange


def shift_decomposes(sem) -> bool:
    """Whether the JAX package's fused kernels take this 2-D SEM's mesh: the
    predicate of its fused-IR path."""
    return get_exchange(sem) is not None
