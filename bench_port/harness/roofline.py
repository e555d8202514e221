"""The yardstick of the kernels: the card's published peaks, the
operations and bytes of the two whole-solve CG kernels, and the union of
device intervals.

Copied, so that the benchmark imports none of the originals:

* ``HBM_BYTES_PER_S``, ``F32_FLOP_PER_S``, :func:`least_time` (was
  ``roofline``), :func:`k1_flops`, :func:`k2_flops`: ``chip_smoke.py``
  lines 302-346 (commit 5a1bc48);
* :func:`busy_us`: ``profile_torch.py`` lines 29-41 (commit 5a1bc48).

:func:`k1_bytes` and :func:`k2_bytes` write out from the shapes what
``chip_smoke.py`` counted as ``nbytes(rhs, rhs, *kernel._dev.values())``
(lines 1078, 1499, 2329-2334): the right-hand side read and the solution
written once, and every constant the kernel reads, once.
"""

from __future__ import annotations

# NVIDIA H100 SXM, the data sheet's dense rates at the full 700 W
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F32, I32 = 4, 4


def least_time(nbytes: float, flops: float) -> float:
    """The least seconds the card could take: the larger of the bytes over
    the memory rate and the operations over the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)


def k1_flops(E: int, n: int, C: int, iters: int) -> float:
    """Operations of a K1 solve, per iteration and node and component as
    counted from csrc/fused_helmholtz_cg.cu: the local Helmholtz apply
    (8n + 10), the FDM preconditioner (8n + 12), two assemblies (8), three
    dots (6) and three axpys (6)."""
    return float(iters) * E * n * n * C * (16 * n + 38)


def k2_flops(E: int, n: int, nc: int, iters: int) -> float:
    """Operations of a K2 solve, per iteration and element as counted from
    csrc/fused_pressure_cg.cu (m = n - 2): E = D M^-1 D^T with its Gauss <->
    GLL transfers (16 n^3 + 4 n m (m + n) + 25 n^2), the element-block
    inverse (2 m^4), the Q1 restriction and prolongation, dots and axpys
    (28 m^2); plus the dense coarse solve (2 nc^2) once per iteration."""
    m = n - 2
    per_elem = 16 * n ** 3 + 4 * n * m * (m + n) + 25 * n * n + 2 * m ** 4 + 28 * m * m
    return float(iters) * (E * per_elem + 2.0 * nc * nc)


def k1_bytes(E: int, n: int, C: int, M: int) -> float:
    """Bytes of a K1 solve: rhs and x (E n^2 C each); D, S (n^2), lam (n),
    the box ratios (3 E), g11, g12, g22, bm, 1/mult (E n^2 each), the
    component masks (E n^2 C) in float32; every node's list of its M
    copies (int32)."""
    node = E * n * n
    return F32 * (2 * node * C + 2 * n * n + n + 3 * E + 5 * node + node * C) + I32 * node * M


def k2_bytes(E: int, n: int, nc: int, M: int, MV: int) -> float:
    """Bytes of a K2 solve (m = n - 2): rhs and x (E m^2 each); D (n^2),
    the Gauss -> GLL map (n m), the Q1 restriction (4 m^2), rx, ry, sx,
    sy, bm, B^-1 (E n^2 each), the velocity masks (2 E n^2), the element
    blocks (E m^4) and the coarse inverse (nc^2) in float32; the corner
    ids (4 E), every vertex's MV slots and every node's M copies (int32)."""
    m = n - 2
    node = E * n * n
    f = 2 * E * m * m + n * n + n * m + 4 * m * m + 6 * node + 2 * node + E * m ** 4 + nc * nc
    return F32 * f + I32 * (4 * E + nc * MV + node * M)


def share(run, key: str):
    """The share of its roofline, in percent, of kernel ``key`` ('k1' or
    'k2') over the traced applications: the least time the card could
    take for every launch (at the iterations that launch ran) over the
    kernel's time summed by name in the device trace.  None without a
    device trace or without launches of the kernel."""
    tr = run.trace
    if tr is None or not tr.launches.get(key) or not tr.kernel_s.get(key):
        return None
    s = tr.shapes[key]
    if key == "k1":
        nbytes = k1_bytes(s["E"], s["n"], s["C"], s["M"])
        flops = lambda k: k1_flops(s["E"], s["n"], s["C"], k)
    else:
        nbytes = k2_bytes(s["E"], s["n"], s["nc"], s["M"], s["MV"])
        flops = lambda k: k2_flops(s["E"], s["n"], s["nc"], k)
    least = sum(least_time(nbytes, flops(k)) for k in tr.launches[key])
    return 100.0 * least / tr.kernel_s[key]


def iterations(barriers: int) -> int:
    """CG iterations of a K1/K2 launch from its grid barriers (2 + 4 k)."""
    return max((int(barriers) - 2) // 4, 0)


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total
