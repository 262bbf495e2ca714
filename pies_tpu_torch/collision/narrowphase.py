"""Point-triangle and edge-edge continuous collision detection (port of
``pies_tpu/collision/narrowphase.py:39-342``).

Column form: every vector is an ``(x, y, z)`` tuple of same-shaped tensors,
and all inputs are relative to a triangle corner, as the reference passes
them (``Solver.cpp:777-788``; an edge pair relative to its first edge's
start).  The narrowphase kernels (``kernels/csrc/ccd.cuh``, and
``edge_ccd.cu`` for the edges) repeat these float32 operations in the same
order.
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


def segment_closest_uv(ab, ac, ad):
    """Closest-point parameters ``(u, v, degenerate)`` of the segments
    ``[0, ab]`` and ``[ac, ad]`` (``_segment_closest_uv``,
    ``narrowphase.py:239-294``, ``CollisionConstraint.cpp:243-287``), column
    form: the unclamped solution of the 2x2 normal equations, or for
    parallel segments (``det == 0``) the midpoint of the projections'
    overlap; both clamped to ``[0, 1]``."""
    cd = _sub_c(ad, ac)
    ab_sq = _dot_c(ab, ab)
    cd_sq = _dot_c(cd, cd)
    ab_cd = _dot_c(ab, cd)
    ac_ab = _dot_c(ac, ab)
    ac_cd = _dot_c(ac, cd)
    det = ab_sq * -cd_sq + ab_cd * ab_cd
    inv_det = _recip(torch.where(det == 0.0, 1.0, det))
    u_n = (ac_ab * -cd_sq + ab_cd * ac_cd) * inv_det
    v_n = (ab_sq * ac_cd - ac_ab * ab_cd) * inv_det
    u0 = torch.zeros_like(ab_sq)
    u1 = ab_sq
    v0 = ac_ab
    v1 = _dot_c(ad, ab)
    flip0 = u0 > u1
    flip1 = v0 > v1
    u_lo, u_hi = torch.minimum(u0, u1), torch.maximum(u0, u1)
    v_lo, v_hi = torch.minimum(v0, v1), torch.maximum(v0, v1)
    mid = torch.where(u_lo > v_lo, (u_lo + v_hi) * 0.5, (v_lo + u_hi) * 0.5)
    u_mid = torch.where(u_lo == u_hi, 0.5,
                        _div(mid - u_lo, torch.where(u_hi == u_lo, 1.0, u_hi - u_lo)))
    v_mid = torch.where(v_lo == v_hi, 0.5,
                        _div(mid - v_lo, torch.where(v_hi == v_lo, 1.0, v_hi - v_lo)))
    disjoint_a = u_lo >= v_hi
    disjoint_b = v_lo >= u_hi
    one, zero = torch.ones_like(ab_sq), torch.zeros_like(ab_sq)
    u_par = torch.where(disjoint_a, torch.where(flip0, one, zero),
                        torch.where(disjoint_b, torch.where(flip0, zero, one), u_mid))
    v_par = torch.where(disjoint_a, torch.where(flip1, zero, one),
                        torch.where(disjoint_b, torch.where(flip1, one, zero), v_mid))
    degenerate = det == 0.0
    u = torch.where(degenerate, u_par, u_n)
    v = torch.where(degenerate, v_par, v_n)
    return torch.clamp(u, 0.0, 1.0), torch.clamp(v, 0.0, 1.0), degenerate


def _div_normalize_c(v):
    """``v / max(|v|, 1e-20)`` with a division per component
    (``_safe_normalize``)."""
    nn = torch.clamp_min(torch.sqrt(_dot_c(v, v)), 1e-20)
    return (_div(v[0], nn), _div(v[1], nn), _div(v[2], nn))


def _neg_c(a):
    return (-a[0], -a[1], -a[2])


def edge_edge_ccd(ab0, ac0, ad0, ab1, ac1, ad1, quirk: bool = True) -> torch.Tensor:
    """``edgeEdgeCCD`` (``narrowphase.py:296-342``,
    ``CollisionDetection.cpp:304-418``), column form, relative to the first
    edge's start before (``*0``) and now (``*1``): a hit when the segments'
    closest points now lie within the hard-coded 0.5, or when the four
    points become coplanar at the earliest root in ``[0, 1]`` of the
    coplanarity cubic with the crossing inside both segments.  ``quirk``
    evaluates the proximity at u = v = 0 unless the segments are parallel
    (the reference's shadowed u/v).  Returns bool."""
    u, v, degenerate = segment_closest_uv(ab1, ac1, ad1)
    if quirk:
        u = torch.where(degenerate, u, 0.0)
        v = torch.where(degenerate, v, 0.0)
    q0 = (u * ab1[0], u * ab1[1], u * ab1[2])
    q1 = _lerp_c(ac1, _sub_c(ad1, ac1), v)
    dq = _sub_c(q0, q1)
    proximity_hit = torch.sqrt(_dot_c(dq, dq)) < 0.5

    abd, acd, add = _sub_c(ab1, ab0), _sub_c(ac1, ac0), _sub_c(ad1, ad0)
    c3 = _det3_c(abd, acd, add)
    c2 = _det3_c(ab0, acd, add) + _det3_c(abd, ac0, add) + _det3_c(abd, acd, ad0)
    c1 = _det3_c(ab0, ac0, add) + _det3_c(ab0, acd, ad0) + _det3_c(abd, ac0, ad0)
    c0 = _det3_c(ab0, ac0, ad0)
    t, found = earliest_root_in_unit_interval(c3, c2, c1, c0)

    abt = _lerp_c(ab0, abd, t)
    act = _lerp_c(ac0, acd, t)
    adt = _lerp_c(ad0, add, t)
    cdt = _sub_c(adt, act)
    ncdt = _neg_c(cdt)
    nt = _div_normalize_c(_cross_c(abt, cdt))
    det = _det3_c(abt, ncdt, nt)
    inv_det = _recip(torch.where(det == 0.0, 1.0, det))
    uu = _det3_c(act, ncdt, nt) * inv_det
    vv = _det3_c(abt, act, nt) * inv_det
    inside = (det != 0.0) & (uu >= 0.0) & (uu <= 1.0) & (vv >= 0.0) & (vv <= 1.0)
    return proximity_hit | (found & inside)
