"""Point-triangle continuous collision detection (port of
``pies_tpu/collision/narrowphase.py:39-237``).

Column form: every vector is an ``(x, y, z)`` tuple of same-shaped tensors,
and all inputs are relative to a triangle corner, as the reference passes
them (``Solver.cpp:777-788``).  The narrowphase kernels (``kernels/csrc/
ccd.cuh``) repeat these float32 operations in the same order.
"""

from __future__ import annotations

import torch

from ..ops.cubic import earliest_root_in_unit_interval
from ..ops.math3d import ieee_div as _div


def _cross_c(a, b):
    ax, ay, az = a
    bx, by, bz = b
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _dot_c(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _det3_c(a, b, c):
    return _dot_c(a, _cross_c(b, c))


def _sub_c(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _lerp_c(a, d, t):
    return (a[0] + t * d[0], a[1] + t * d[1], a[2] + t * d[2])


def _recip(x: torch.Tensor) -> torch.Tensor:
    return _div(torch.ones_like(x), x)


def _normalize_c(v):
    inv = _recip(torch.clamp_min(torch.sqrt(_dot_c(v, v)), 1e-20))
    return (v[0] * inv, v[1] * inv, v[2] * inv)


def _barycentric_inside_c(ab, ac, n, ap) -> torch.Tensor:
    """Cramer's rule for ``[ab ac n]·β = ap`` and the interior test
    (``CollisionDetection.cpp:249-254,293-298``)."""
    det = _det3_c(ab, ac, n)
    inv_det = _recip(torch.where(det == 0.0, 1.0, det))
    bx = _det3_c(ap, ac, n) * inv_det
    by = _det3_c(ab, ap, n) * inv_det
    return ((det != 0.0) & (bx >= 0.0) & (bx <= 1.0) & (by >= 0.0) & (by <= 1.0)
            & (bx + by <= 1.0))


def point_triangle_ccd_cols(ap0, ab0, ac0, ap1, ab1, ac1, threshold):
    """``pointTriangleCCD`` (``CollisionDetection.cpp:227-302``): returns
    ``(hit, t)``.  A point that stays on one side of the plane hits at t = 0
    when its final distance is in ``[0, threshold)`` and it projects inside
    the triangle; otherwise the earliest coplanarity time is checked for
    containment."""
    n0 = _normalize_c(_cross_c(ab0, ac0))
    n1 = _normalize_c(_cross_c(ab1, ac1))
    ndp0 = _dot_c(n0, ap0)
    ndp1 = _dot_c(n1, ap1)
    no_cross = ndp0 * ndp1 >= 0.0
    proximity_hit = (no_cross & (ndp1 >= 0.0) & (ndp1 < threshold)
                     & _barycentric_inside_c(ab1, ac1, n1, ap1))

    apd = _sub_c(ap1, ap0)
    abd = _sub_c(ab1, ab0)
    acd = _sub_c(ac1, ac0)
    c3 = _det3_c(apd, abd, acd)
    c2 = _det3_c(ap0, abd, acd) + _det3_c(apd, ab0, acd) + _det3_c(apd, abd, ac0)
    c1 = _det3_c(ap0, ab0, acd) + _det3_c(ap0, abd, ac0) + _det3_c(apd, ab0, ac0)
    c0 = _det3_c(ap0, ab0, ac0)
    t, found = earliest_root_in_unit_interval(c3, c2, c1, c0)

    apt = _lerp_c(ap0, apd, t)
    abt = _lerp_c(ab0, abd, t)
    act = _lerp_c(ac0, acd, t)
    nt = _normalize_c(_cross_c(abt, act))
    ccd_hit = found & _barycentric_inside_c(abt, act, nt, apt)

    hit = torch.where(no_cross, proximity_hit, ccd_hit)
    t_out = torch.where(no_cross, 0.0, torch.where(ccd_hit, t, 0.0))
    return hit, t_out


def point_triangle_phase1_face(b0, ab0, ac0, b1, ab1, ac1, corners_prev, corners_now,
                               threshold):
    """Phase 1 of the two-phase narrowphase, one face against many points:
    per corner ``(proximity_hit, crossing)``.  The proximity outcome is
    decided exactly here; ``crossing`` marks points that crossed the face's
    plane, which only the coplanarity cubic can decide.  The face's
    geometry is computed once for all corners; the barycentric ``by`` uses
    the permuted triple product ``ap·(n×ab)``, as in the JAX package."""
    cross0 = _cross_c(ab0, ac0)
    n1 = _normalize_c(_cross_c(ab1, ac1))
    det = _det3_c(ab1, ac1, n1)
    inv_det = _recip(torch.where(det == 0.0, 1.0, det))
    ok = det != 0.0
    cx_acn = _cross_c(ac1, n1)
    cx_nab = _cross_c(n1, ab1)
    out = []
    for cp, cn in zip(corners_prev, corners_now):
        ap0 = _sub_c(cp, b0)
        ap1 = _sub_c(cn, b1)
        c_start = _dot_c(ap0, cross0)
        ndp1 = _dot_c(n1, ap1)
        no_cross = c_start * ndp1 >= 0.0
        bx = _dot_c(ap1, cx_acn) * inv_det
        by = _dot_c(ap1, cx_nab) * inv_det
        inside = (ok & (bx >= 0.0) & (bx <= 1.0) & (by >= 0.0) & (by <= 1.0)
                  & (bx + by <= 1.0))
        prox = no_cross & (ndp1 >= 0.0) & (ndp1 < threshold) & inside
        out.append((prox, ~no_cross))
    return out


def point_triangle_ccd(ap0, ab0, ac0, ap1, ab1, ac1, threshold):
    """Row form of :func:`point_triangle_ccd_cols`: every argument a
    ``[..., 3]`` tensor (``narrowphase.py:210-237``)."""
    return point_triangle_ccd_cols(*(_cols(v) for v in (ap0, ab0, ac0, ap1, ab1, ac1)),
                                   threshold)


def _cols(v: torch.Tensor):
    return (v[..., 0], v[..., 1], v[..., 2])
