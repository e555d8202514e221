"""Nek5000 ``.re2`` binary mesh reader and writer.

Numpy copy of ``nekstab_next_tpu/mesh/re2.py`` (it imports only numpy and
the port's own ``gll``, ``mesh`` and ``mesh3``): the same reader, writer,
curved-side and curved-hex geometry, so both packages build the same mesh
from one file.  Lets users bring Nek5000 case meshes (e.g. a cylinder mesh
with a curved wall) into the port.

Format (little-endian, version ``#v002``):

* 80-byte ASCII header: ``#v002  nelgt  ndim  nelgv ...``;
* 4-byte endian-test float 6.54321;
* per element (2-D): 9 float64 — group, x(4 corners), y(4 corners), in Nek
  preprocessor corner order (counterclockwise from (-1,-1));
* curved-side section: count, then records (eg, iside, p1..p5, ccurve) of
  8 float64 each, ``ccurve`` being the first byte ('C' = circular arc of
  radius p1, sign = which of the two centers);
* BC section: count, then records (eg, iside, p1..p5, cbc3) — 'W' wall,
  'v' inflow, 'O' outflow, 'SYM', 'P' periodic (p1/p2 = partner el/side).

Element GLL coordinates come from Gordon-Hall transfinite interpolation of
the four (possibly curved) edges, after which :func:`mesh.build_mesh`
assembles connectivity by coordinate matching — the O-mesh periodic seam
('P' with coincident coordinates) merges automatically.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from .gll import gll_points_weights
from .mesh import BoundaryCondition as BC
from .mesh import Mesh2D, build_mesh

_CBC_MAP = {
    b"W": BC.WALL,
    b"v": BC.DIRICHLET,
    b"V": BC.DIRICHLET,
    b"O": BC.OUTFLOW,
    b"o": BC.OUTFLOW,
    b"SYM": BC.SYMMETRY,
}


@dataclasses.dataclass
class Re2Data:
    nelem: int
    ndim: int
    corners: np.ndarray  # (nelem, 4, ndim) preprocessor-ordered corners
    curves: Dict[Tuple[int, int], Tuple[str, np.ndarray]]  # (el, side) -> (type, p1..p5)
    bcs: Dict[Tuple[int, int], Tuple[str, np.ndarray]]  # (el, side) -> (cbc, p1..p5)


def read_re2(path: str) -> Re2Data:
    with open(path, "rb") as fh:
        raw = fh.read()
    hdr = raw[:80].decode("ascii", errors="replace")
    if hdr[:5] not in ("#v002", "#v003"):
        raise ValueError(f"unsupported .re2 version: {hdr[:10]!r}")
    parts = hdr.split()
    nelem, ndim = int(parts[1]), int(parts[2])
    test = struct.unpack("<f", raw[80:84])[0]
    if abs(test - 6.54321) > 1e-4:
        raise ValueError("byte order mismatch (big-endian .re2 not supported)")

    off = 84
    nc = 4 if ndim == 2 else 8
    per = 1 + ndim * nc  # group + coordinates
    data = np.frombuffer(raw, "<f8", nelem * per, off).reshape(nelem, per)
    off += nelem * per * 8
    if ndim == 2:
        corners = np.stack([data[:, 1:5], data[:, 5:9]], axis=-1)  # (nelem,4,2)
    else:
        corners = np.stack(
            [data[:, 1:9], data[:, 9:17], data[:, 17:25]], axis=-1
        )  # (nelem,8,3): x(1:8), y(1:8), z(1:8)

    def read_records(off: int):
        cnt = int(np.frombuffer(raw, "<f8", 1, off)[0])
        off += 8
        rec = np.frombuffer(raw, "<f8", cnt * 8, off).reshape(cnt, 8)
        off += cnt * 64
        return rec, off

    crec, off = read_records(off)
    curves: Dict[Tuple[int, int], Tuple[str, np.ndarray]] = {}
    for row in crec:
        e, s = int(row[0]) - 1, int(row[1]) - 1
        ctype = row[7:8].tobytes()[:1].decode()
        curves[(e, s)] = (ctype, row[2:7].copy())

    brec, off = read_records(off)
    bcs: Dict[Tuple[int, int], Tuple[str, np.ndarray]] = {}
    for row in brec:
        e, s = int(row[0]) - 1, int(row[1]) - 1
        cbc = row[7:8].tobytes().rstrip(b"\x00 ").decode()
        bcs[(e, s)] = (cbc, row[2:7].copy())

    return Re2Data(nelem=nelem, ndim=ndim, corners=corners, curves=curves,
                   bcs=bcs)


def write_re2(path: str, data: Re2Data) -> None:
    """Write a Nek5000 ``#v002`` binary ``.re2`` (inverse of :func:`read_re2`;
    the reference relies on external tooling — genbox/gmsh converters — for
    this).  Used to emit generated fixture meshes that both this framework
    and Nek5000 can ingest."""
    nc = 4 if data.ndim == 2 else 8
    with open(path, "wb") as fh:
        hdr = f"#v002 {data.nelem:9d} {data.ndim:2d} {data.nelem:9d}"
        fh.write(hdr.ljust(80).encode("ascii"))
        fh.write(struct.pack("<f", 6.54321))
        for e in range(data.nelem):
            block = np.zeros(1 + data.ndim * nc)
            for d in range(data.ndim):
                block[1 + d * nc:1 + (d + 1) * nc] = data.corners[e, :, d]
            fh.write(block.astype("<f8").tobytes())

        def pack_records(records, tagbytes: int):
            fh.write(np.asarray([float(len(records))], "<f8").tobytes())
            for (e, sd), (tag, p) in records.items():
                row = np.zeros(7)
                row[0], row[1] = e + 1, sd + 1
                row[2:7] = p[:5]
                fh.write(row.astype("<f8").tobytes())
                fh.write(tag.encode("ascii")[:tagbytes].ljust(8, b"\x00"))

        pack_records(data.curves, 1)
        pack_records(data.bcs, 3)


def _arc_points(A: np.ndarray, B: np.ndarray, radius: float,
                s: np.ndarray) -> np.ndarray:
    """Points along the circular arc A -> B of given (signed) radius at
    normalized parameters ``s`` in [0,1] (Nek 'C' curved side, genxyz
    ``arcsrf`` convention: the sign picks which of the two circle centers)."""
    chord = B - A
    d = float(np.hypot(*chord))
    R = abs(radius)
    if R < d / 2:
        raise ValueError(f"arc radius {radius} < half chord {d/2}")
    m = (A + B) / 2.0
    # left-hand normal of the A->B direction
    nhat = np.array([-chord[1], chord[0]]) / d
    h = np.sqrt(R * R - 0.25 * d * d)
    c = m + (h if radius > 0 else -h) * nhat
    thA = np.arctan2(A[1] - c[1], A[0] - c[0])
    thB = np.arctan2(B[1] - c[1], B[0] - c[0])
    dth = (thB - thA + np.pi) % (2 * np.pi) - np.pi  # short way
    th = thA + s * dth
    return c[None, :] + R * np.stack([np.cos(th), np.sin(th)], axis=-1)


def _edge_points(corners: np.ndarray, side: int,
                 curve: Optional[Tuple[str, np.ndarray]],
                 s: np.ndarray) -> np.ndarray:
    """Points along preprocessor side ``side`` (0..3: c1-c2, c2-c3, c3-c4,
    c4-c1) at parameters ``s``; straight unless a curve record exists."""
    A = corners[side]
    Bidx = (side + 1) % 4
    B = corners[Bidx]
    if curve is None:
        return A[None, :] + s[:, None] * (B - A)[None, :]
    ctype, p = curve
    if ctype == "C":
        return _arc_points(A, B, float(p[0]), s)
    if ctype == "m":  # midside-point quadratic
        M = np.array([p[0], p[1]])
        # quadratic through A (s=0), M (s=1/2), B (s=1)
        l0 = 2 * (s - 0.5) * (s - 1.0)
        l1 = -4 * s * (s - 1.0)
        l2 = 2 * s * (s - 0.5)
        return l0[:, None] * A + l1[:, None] * M + l2[:, None] * B
    raise NotImplementedError(f"curve type {ctype!r}")


def mesh_from_re2(
    path: str,
    order: int,
    coord_key: Optional[Callable] = None,
    bc_override: Optional[Dict[str, BC]] = None,
    boundary_ids: Optional[Dict[int, BC]] = None,
) -> Mesh2D:
    """Build a :class:`Mesh2D` at polynomial ``order`` from a Nek ``.re2``.

    ``bc_override`` remaps cbc strings (e.g. {'v': BC.WALL}).  Periodic
    sides rely on coordinate coincidence (O-mesh seams) or a supplied
    ``coord_key`` wrap for translational periodicity.

    ``boundary_ids`` handles v003 meshes whose BC section carries boundary
    IDs instead of condition strings ('MSH' records; the reference's BFS
    case assigns them in usrdat2 via ``setbc(id, field, bc)``,
    examples/back_fstep/baseflow/bfs.usr:114-127): map id -> BC, e.g.
    {4: BC.DIRICHLET, 2: BC.OUTFLOW, 3: BC.WALL} for the BFS."""
    data = read_re2(path)
    n = order + 1
    z, _ = gll_points_weights(n)
    s = (z + 1.0) / 2.0  # edge parameter in [0,1]
    xi = s[:, None]  # (n,1) for xi-direction blending
    eta = s[None, :]  # (1,n)

    nelem = data.nelem
    X = np.zeros((nelem, n, n))
    Y = np.zeros((nelem, n, n))
    for e in range(nelem):
        c = data.corners[e]  # (4,2)
        Eb = _edge_points(c, 0, data.curves.get((e, 0)), s)  # c1->c2, xi
        Er = _edge_points(c, 1, data.curves.get((e, 1)), s)  # c2->c3, eta
        Et = _edge_points(c, 2, data.curves.get((e, 2)), s)[::-1]  # -> xi asc
        El = _edge_points(c, 3, data.curves.get((e, 3)), s)[::-1]  # -> eta asc
        for k, out in ((0, X), (1, Y)):
            face = (
                (1 - eta) * Eb[:, k][:, None]
                + eta * Et[:, k][:, None]
                + (1 - xi) * El[:, k][None, :]
                + xi * Er[:, k][None, :]
                - (
                    (1 - xi) * (1 - eta) * c[0, k]
                    + xi * (1 - eta) * c[1, k]
                    + xi * eta * c[2, k]
                    + (1 - xi) * eta * c[3, k]
                )
            )
            out[e] = face

    if data.ndim == 3:
        raise ValueError("3-D mesh: use mesh3_from_re2")
    cbc_map = dict(_CBC_MAP)
    edge_bc = np.empty((nelem, 4), dtype=object)
    edge_bc[:] = None
    for (e, sd), (cbc, p) in data.bcs.items():
        if cbc in ("P", "E", ""):
            continue  # connectivity, not a boundary condition
        if cbc == "MSH":  # v003 boundary-ID record; id in the last param
            bid = int(p[4])
            if boundary_ids is None or bid not in boundary_ids:
                raise ValueError(
                    f"mesh carries boundary-ID records; pass boundary_ids "
                    f"(element {e} side {sd} has id {bid})"
                )
            edge_bc[e, sd] = boundary_ids[bid]
            continue
        bc = (bc_override or {}).get(cbc) or cbc_map.get(cbc.encode()[:3]) \
            or cbc_map.get(cbc.encode()[:1])
        if bc is None:
            raise ValueError(f"unmapped cbc {cbc!r} at element {e} side {sd}")
        edge_bc[e, sd] = bc

    return build_mesh(X, Y, edge_bc, order, coord_key=coord_key)


# Nek preprocessor face numbers (1..6: eta-, xi+, eta+, xi-, zeta-, zeta+)
# -> mesh3.face index (0..5: xi-, xi+, eta-, eta+, zeta-, zeta+)
_NEK_FACE3 = {0: 2, 1: 1, 2: 3, 3: 0, 4: 4, 5: 5}

# Nek preprocessor edge numbers (1..12) as 0-based corner pairs: 1-4 around
# the bottom (zeta-) face, 5-8 around the top, 9-12 vertical (genxyz.f).
_NEK_EDGES3 = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]

# corner index (xi, eta, zeta) -> preprocessor corner number (0-based)
_CORNER3 = {
    (0, 0, 0): 0, (1, 0, 0): 1, (1, 1, 0): 2, (0, 1, 0): 3,
    (0, 0, 1): 4, (1, 0, 1): 5, (1, 1, 1): 6, (0, 1, 1): 7,
}


def _edge_points_3d(A: np.ndarray, B: np.ndarray,
                    curve: Optional[Tuple[str, np.ndarray]],
                    s: np.ndarray) -> np.ndarray:
    """Points along a hex edge A -> B at parameters ``s`` in [0,1]."""
    if curve is None:
        return A[None, :] + s[:, None] * (B - A)[None, :]
    ctype, p = curve
    if ctype == "m":  # midside-point quadratic (Nek 'm' edge record)
        M = p[:3]
        l0 = 2 * (s - 0.5) * (s - 1.0)
        l1 = -4 * s * (s - 1.0)
        l2 = 2 * s * (s - 0.5)
        return l0[:, None] * A + l1[:, None] * M[None, :] + l2[:, None] * B
    if ctype == "C":
        # Nek's arcsrf: the arc lives in the xy-plane (extruded meshes);
        # z interpolates linearly along the edge
        xy = _arc_points(A[:2], B[:2], float(p[0]), s)
        zl = A[2] + s * (B[2] - A[2])
        return np.concatenate([xy, zl[:, None]], axis=1)
    raise NotImplementedError(f"3-D curve type {ctype!r} on an edge")


def _sphere_project(pts: np.ndarray, center: np.ndarray,
                    radius: float) -> np.ndarray:
    """Radial projection onto the sphere (center, |radius|) — Nek's 's'
    spherical-face generation (genxyz.f ``sphsrf``): points move along rays
    from the center; corners already on the sphere stay put."""
    d = pts - center
    r = np.linalg.norm(d, axis=-1, keepdims=True)
    return center + abs(radius) * d / np.maximum(r, 1e-300)


def _tf_face(eu0, eu1, ev0, ev1, C00, C10, C01, C11, s):
    """2-D transfinite (Gordon-Hall) face grid (n, n, 3) with indices [u, v]
    from its four edge curves (each (n, 3), ascending parameter) and corner
    coordinates."""
    u = s[:, None, None]
    v = s[None, :, None]
    return (
        (1 - v) * eu0[:, None, :] + v * eu1[:, None, :]
        + (1 - u) * ev0[None, :, :] + u * ev1[None, :, :]
        - ((1 - u) * (1 - v) * C00 + u * (1 - v) * C10
           + (1 - u) * v * C01 + u * v * C11)
    )


def _curved_hex_coords(corners: np.ndarray,
                       curves: Dict[int, Tuple[str, np.ndarray]],
                       sphere: Dict[int, Tuple[np.ndarray, float]],
                       s: np.ndarray) -> np.ndarray:
    """GLL coordinates (n, n, n, 3) of one hex by 3-D Gordon-Hall transfinite
    blending of its 6 faces / 12 edges / 8 corners.

    ``curves``: Nek edge records (0-based edge number -> ('C'|'m', params));
    ``sphere``: 's' face records (mesh3 face index -> (center, radius)).
    Faces touched by an 's' record (and their boundary edges) are projected
    radially onto the sphere, as Nek's genxyz.f sphsrf/arcsrf do."""
    n = len(s)
    E = {}
    for i, (a, b) in enumerate(_NEK_EDGES3):
        E[i] = _edge_points_3d(corners[a], corners[b], curves.get(i), s)

    # edges organized by direction with ascending parameter:
    # EX[(eta, zeta)], EY[(xi, zeta)], EZ[(xi, eta)]
    EX = {(0, 0): E[0], (1, 0): E[2][::-1], (0, 1): E[4], (1, 1): E[6][::-1]}
    EY = {(1, 0): E[1], (0, 0): E[3][::-1], (1, 1): E[5], (0, 1): E[7][::-1]}
    EZ = {(0, 0): E[8], (1, 0): E[9], (1, 1): E[10], (0, 1): E[11]}

    # faces (mesh3 index) -> the four (dict, key) edge slots on its boundary
    face_edges = {
        0: [(EY, (0, 0)), (EY, (0, 1)), (EZ, (0, 0)), (EZ, (0, 1))],
        1: [(EY, (1, 0)), (EY, (1, 1)), (EZ, (1, 0)), (EZ, (1, 1))],
        2: [(EX, (0, 0)), (EX, (0, 1)), (EZ, (0, 0)), (EZ, (1, 0))],
        3: [(EX, (1, 0)), (EX, (1, 1)), (EZ, (0, 1)), (EZ, (1, 1))],
        4: [(EX, (0, 0)), (EX, (1, 0)), (EY, (0, 0)), (EY, (1, 0))],
        5: [(EX, (0, 1)), (EX, (1, 1)), (EY, (0, 1)), (EY, (1, 1))],
    }
    for f, (c, R) in sphere.items():
        for d, key in face_edges[f]:
            d[key] = _sphere_project(d[key], c, R)

    C = lambda i, j, k: corners[_CORNER3[(i, j, k)]]

    # the six face grids (2-D transfinite from the final edge curves)
    Fxi = [_tf_face(EY[(a, 0)], EY[(a, 1)], EZ[(a, 0)], EZ[(a, 1)],
                    C(a, 0, 0), C(a, 1, 0), C(a, 0, 1), C(a, 1, 1), s)
           for a in (0, 1)]  # indices [eta, zeta]
    Fet = [_tf_face(EX[(b, 0)], EX[(b, 1)], EZ[(0, b)], EZ[(1, b)],
                    C(0, b, 0), C(1, b, 0), C(0, b, 1), C(1, b, 1), s)
           for b in (0, 1)]  # indices [xi, zeta]
    Fze = [_tf_face(EX[(0, c_)], EX[(1, c_)], EY[(0, c_)], EY[(1, c_)],
                    C(0, 0, c_), C(1, 0, c_), C(0, 1, c_), C(1, 1, c_), s)
           for c_ in (0, 1)]  # indices [xi, eta]
    for f, grid in ((0, Fxi[0]), (1, Fxi[1]), (2, Fet[0]), (3, Fet[1]),
                    (4, Fze[0]), (5, Fze[1])):
        if f in sphere:
            c, R = sphere[f]
            if f in (0, 1):
                Fxi[f] = _sphere_project(grid, c, R)
            elif f in (2, 3):
                Fet[f - 2] = _sphere_project(grid, c, R)
            else:
                Fze[f - 4] = _sphere_project(grid, c, R)

    xi = s[:, None, None, None]
    eta = s[None, :, None, None]
    zeta = s[None, None, :, None]
    X = (
        (1 - xi) * Fxi[0][None, :, :, :] + xi * Fxi[1][None, :, :, :]
        + (1 - eta) * Fet[0][:, None, :, :] + eta * Fet[1][:, None, :, :]
        + (1 - zeta) * Fze[0][:, :, None, :] + zeta * Fze[1][:, :, None, :]
    )
    # subtract the doubly-counted edges
    w = {0: lambda t: (1 - t), 1: lambda t: t}
    for (a, b), pts in EX.items():
        X -= (w[a](eta) * w[b](zeta)) * pts[:, None, None, :]
    for (a, b), pts in EY.items():
        X -= (w[a](xi) * w[b](zeta)) * pts[None, :, None, :]
    for (a, b), pts in EZ.items():
        X -= (w[a](xi) * w[b](eta)) * pts[None, None, :, :]
    # add back the corners
    for (i, j, k), cidx in _CORNER3.items():
        X += (w[i](xi) * w[j](eta) * w[k](zeta)) * corners[cidx]
    return X


def mesh3_from_re2(
    path: str,
    order: int,
    coord_key: Optional[Callable] = None,
    bc_override: Optional[Dict[str, "BC"]] = None,
    boundary_ids: Optional[Dict[int, "BC"]] = None,
):
    """3-D analog of :func:`mesh_from_re2`: hex elements with full curved-side
    support — 'C' (circular arc, xy-plane) and 'm' (midside point) edge
    records plus 's' (sphere) face records, blended into the element interior
    by 3-D Gordon-Hall transfinite interpolation (the equivalent of Nek's
    genxyz.f geometry generation that the reference inherits)."""
    from .mesh3 import Mesh3D, build_mesh_3d  # noqa: F401 (Mesh3D re-export)

    data = read_re2(path)
    if data.ndim != 3:
        raise ValueError("2-D mesh: use mesh_from_re2")
    return _mesh3_from_data(data, order, coord_key=coord_key,
                            bc_override=bc_override,
                            boundary_ids=boundary_ids)


def _mesh3_from_data(
    data: Re2Data,
    order: int,
    coord_key: Optional[Callable] = None,
    bc_override: Optional[Dict[str, "BC"]] = None,
    boundary_ids: Optional[Dict[int, "BC"]] = None,
):
    from .mesh3 import build_mesh_3d

    n = order + 1
    z, _ = gll_points_weights(n)
    s = (z + 1.0) / 2.0
    nelem = data.nelem

    # split curve records: edge records ('C'/'m', iside 1..12) vs sphere
    # faces ('s', iside = preprocessor face 1..6)
    edge_curves: Dict[int, Dict[int, Tuple[str, np.ndarray]]] = {}
    sphere_faces: Dict[int, Dict[int, Tuple[np.ndarray, float]]] = {}
    for (e, sd), (ctype, p) in data.curves.items():
        if ctype == "s":
            sphere_faces.setdefault(e, {})[_NEK_FACE3[sd]] = (
                p[1:4].copy(), float(p[0])
            )
        else:
            edge_curves.setdefault(e, {})[sd] = (ctype, p)

    if not edge_curves and not sphere_faces:
        # fast path: all-straight hexes are trilinear
        xi = s[:, None, None]
        eta = s[None, :, None]
        zeta = s[None, None, :]
        wts = [
            (1 - xi) * (1 - eta), xi * (1 - eta), xi * eta, (1 - xi) * eta,
        ]
        W = np.stack([w * (1 - zeta) for w in wts] + [w * zeta for w in wts])
        XYZ = np.einsum("cijk,ecd->deijk", W, data.corners)
    else:
        XYZ = np.zeros((3, nelem, n, n, n))
        for e in range(nelem):
            grid = _curved_hex_coords(
                data.corners[e], edge_curves.get(e, {}),
                sphere_faces.get(e, {}), s,
            )
            XYZ[:, e] = np.moveaxis(grid, -1, 0)
    face_bc = np.empty((nelem, 6), dtype=object)
    face_bc[:] = None
    cbc_map = dict(_CBC_MAP)
    for (e, sd), (cbc, p) in data.bcs.items():
        if cbc in ("P", "E", ""):
            continue
        face = _NEK_FACE3[sd]
        if cbc == "MSH":
            bid = int(p[4])
            if boundary_ids is None or bid not in boundary_ids:
                raise ValueError(
                    f"boundary-ID records need boundary_ids (el {e} face "
                    f"{face} id {bid})"
                )
            face_bc[e, face] = boundary_ids[bid]
            continue
        bc = (bc_override or {}).get(cbc) or cbc_map.get(cbc.encode()[:3]) \
            or cbc_map.get(cbc.encode()[:1])
        if bc is None:
            raise ValueError(f"unmapped cbc {cbc!r} at element {e} face {face}")
        face_bc[e, face] = bc

    return build_mesh_3d(XYZ[0], XYZ[1], XYZ[2], face_bc, order,
                         coord_key=coord_key)
