"""Flat 3x3 linear algebra on tuples of ``[C]`` tensors (port of the flat
pipeline of ``pies_tpu/ops/math3d.py:204-364``).

A "matrix" is a tuple of nine tensors, row-major (``m[3*i+j]``).  These are
the plain PyTorch twins of the device functions in
``kernels/csrc/tet_force.cuh``: same formulas, same order of operations, same
``sign(0) = 0`` convention as ``jnp.sign``.  They run on the CPU in the tests
and are the oracle the CUDA kernels are held to on the card.
"""

from __future__ import annotations

import torch

JACOBI_SWEEPS = 8  # cyclic sweeps; 8 reach float32 roundoff for 3x3
_TINY = 1e-20
_EPS = 1e-12


def ieee_div(a: torch.Tensor, b) -> torch.Tensor:
    """``a / b`` as an IEEE division on every device, ``b`` a tensor or a
    Python number.  (PyTorch's CUDA path turns division by a Python scalar
    into a product with its reciprocal, which rounds differently from the
    kernels and the JAX package.)"""
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=a.dtype, device=a.device)
    return a / b


def det3x3_flat(m):
    return (
        m[0] * (m[4] * m[8] - m[5] * m[7])
        - m[1] * (m[3] * m[8] - m[5] * m[6])
        + m[2] * (m[3] * m[7] - m[4] * m[6])
    )


def matmul_flat(a, b):
    """(ab)[i,j] = sum_k a[i,k] b[k,j] on 9-tuples."""
    return tuple(
        a[3 * i + 0] * b[0 + j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j]
        for i in range(3)
        for j in range(3)
    )


def _jacobi_rotate_flat(s, v, p: int, q: int):
    """One Jacobi rotation zeroing ``s[p, q]``; accumulates ``v <- v J``."""
    s = list(s)
    v = list(v)
    app, aqq, apq = s[3 * p + p], s[3 * q + q], s[3 * p + q]
    small = apq.abs() < _TINY
    tau = (aqq - app) / (2.0 * torch.where(small, _TINY, apq))
    t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(small, 0.0, t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    sn = t * c

    for r in range(3):  # rows p, q
        sp, sq = s[3 * p + r], s[3 * q + r]
        s[3 * p + r] = c * sp - sn * sq
        s[3 * q + r] = sn * sp + c * sq
    for r in range(3):  # cols p, q
        sp, sq = s[3 * r + p], s[3 * r + q]
        s[3 * r + p] = c * sp - sn * sq
        s[3 * r + q] = sn * sp + c * sq
    zero = torch.zeros_like(s[0])
    s[3 * p + q] = zero
    s[3 * q + p] = zero

    for r in range(3):
        vp, vq = v[3 * r + p], v[3 * r + q]
        v[3 * r + p] = c * vp - sn * vq
        v[3 * r + q] = sn * vp + c * vq
    return tuple(s), tuple(v)


def eigh3x3_flat(s, sweeps: int = JACOBI_SWEEPS):
    """Eigendecomposition of a symmetric 9-tuple: (w 3-tuple descending,
    v 9-tuple with matching columns)."""
    one = torch.ones_like(s[0])
    zero = torch.zeros_like(s[0])
    v = (one, zero, zero, zero, one, zero, zero, zero, one)
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            s, v = _jacobi_rotate_flat(s, v, p, q)
    w = [s[0], s[4], s[8]]
    v = list(v)

    def swap_if(i, j):
        do = w[i] < w[j]
        w[i], w[j] = torch.where(do, w[j], w[i]), torch.where(do, w[i], w[j])
        for r in range(3):
            vi, vj = v[3 * r + i], v[3 * r + j]
            v[3 * r + i] = torch.where(do, vj, vi)
            v[3 * r + j] = torch.where(do, vi, vj)

    swap_if(0, 1)
    swap_if(1, 2)
    swap_if(0, 1)
    return tuple(w), tuple(v)


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross3(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def svd3x3_flat(f, sweeps: int = JACOBI_SWEEPS):
    """f (9-tuple) -> (u 9-tuple, sigma 3-tuple, v 9-tuple): ``f = U diag(σ)
    Vᵀ`` with σ descending and non-negative, U completed orthonormally for
    rank-deficient f and carrying the sign of det f."""
    s = tuple(
        f[0 + i] * f[0 + k] + f[3 + i] * f[3 + k] + f[6 + i] * f[6 + k]
        for i in range(3)
        for k in range(3)
    )
    w, v = eigh3x3_flat(s, sweeps=sweeps)
    sigma = tuple(torch.sqrt(torch.clamp_min(wk, 0.0)) for wk in w)

    fv = matmul_flat(f, v)  # columns = U diag(σ)
    u_cols = []
    for j in range(3):
        inv = 1.0 / torch.clamp_min(sigma[j], _EPS)
        u_cols.append(tuple(fv[3 * r + j] * inv for r in range(3)))

    def normalize(x, fallback):
        n = torch.sqrt(_dot3(x, x))
        ok = n > 1e-6
        inv = 1.0 / torch.clamp_min(n, _EPS)
        return tuple(torch.where(ok, xi * inv, fi) for xi, fi in zip(x, fallback))

    zero = torch.zeros_like(sigma[0])
    u0 = normalize(u_cols[0], (torch.ones_like(sigma[0]), zero, zero))
    d10 = _dot3(u_cols[1], u0)
    u1 = normalize(tuple(x - d10 * y for x, y in zip(u_cols[1], u0)), _perp_flat(u0))
    d20 = _dot3(u_cols[2], u0)
    u2r = tuple(x - d20 * y for x, y in zip(u_cols[2], u0))
    d21 = _dot3(u2r, u1)
    u2r = tuple(x - d21 * y for x, y in zip(u2r, u1))
    detf = det3x3_flat(f)
    detv = det3x3_flat(v)
    sgn = torch.sign(detf * detv) + (detf == 0).to(detf.dtype)
    u2 = normalize(u2r, tuple(x * sgn for x in _cross3(u0, u1)))
    u = (
        u0[0], u1[0], u2[0],
        u0[1], u1[1], u2[1],
        u0[2], u1[2], u2[2],
    )
    return u, sigma, v


def _perp_flat(x):
    """A unit vector orthogonal to the unit 3-vector ``x`` (branch-free)."""
    ax = tuple(xi.abs() for xi in x)
    use_x = (ax[0] <= ax[1]) & (ax[0] <= ax[2])
    use_y = ~use_x & (ax[1] <= ax[2])
    dt = x[0].dtype
    e = (use_x.to(dt), use_y.to(dt), (~(use_x | use_y)).to(dt))
    d = _dot3(e, x)
    p = tuple(ei - d * xi for ei, xi in zip(e, x))
    n = torch.sqrt(_dot3(p, p))
    inv = 1.0 / torch.clamp_min(n, _EPS)
    return tuple(pi * inv for pi in p)


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z) and Müller's rotation extraction (port of
# ``pies_tpu/ops/math3d.py:372-443``).  Written component by component, in
# the order in which ``kernels/csrc/shape_match.cu`` does the same steps.


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_to_mat9(q: torch.Tensor):
    """Unit quaternion ``[..., 4]`` -> the rotation matrix as nine tensors,
    row-major."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return (
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    )


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation matrix ``[..., 3, 3]``."""
    r = quat_to_mat9(q)
    return torch.stack(r, dim=-1).reshape(*q.shape[:-1], 3, 3)


def quat_from_axis_angle(angle: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    half = 0.5 * angle
    s = torch.sin(half)
    return torch.cat([torch.cos(half)[..., None], s[..., None] * axis], dim=-1)


def _cross3(u, v):
    return (u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2], u[0] * v[1] - u[1] * v[0])


def extract_rotation(a: torch.Tensor, q: torch.Tensor, iterations: int) -> torch.Tensor:
    """Rotational part of ``a`` f32[G, 3, 3] by Müller et al.'s iteration
    (``extractRotation``, ``ShapeMatchingConstraint.cpp:75-94``), warm-started
    from ``q`` f32[G, 4]: per trip the torque ``ω`` of the current rotation
    against ``a``, and a turn of ``q`` about it.  A fixed trip count with the
    update masked once ``|ω| < 1e-9``, as in the JAX package.

    The torque's scale is ``1/|den| + 1e-9`` — the JAX package's expression
    (``pies_tpu/ops/math3d.py:432``), not ``1/(|den| + 1e-9)`` — because the
    port is held to that package."""
    acol = [(a[..., 0, k], a[..., 1, k], a[..., 2, k]) for k in range(3)]
    for _ in range(iterations):
        r = quat_to_mat9(q)
        rcol = [(r[k], r[3 + k], r[6 + k]) for k in range(3)]
        num = _cross3(rcol[0], acol[0])
        for k in (1, 2):
            c = _cross3(rcol[k], acol[k])
            num = tuple(n + ci for n, ci in zip(num, c))
        dots = [rc[0] * ac[0] + rc[1] * ac[1] + rc[2] * ac[2] for rc, ac in zip(rcol, acol)]
        den = dots[0] + dots[1] + dots[2]
        scale = ieee_div(torch.ones_like(den), den.abs()) + 1e-9
        om = tuple(n * scale for n in num)
        w = torch.sqrt(om[0] * om[0] + om[1] * om[1] + om[2] * om[2])
        converged = w < 1e-9
        wn = torch.clamp_min(w, _TINY)
        axis = torch.stack([o / wn for o in om], dim=-1)
        q_new = quat_mul(quat_from_axis_angle(w, axis), q)
        norm = torch.sqrt(q_new[..., 0] * q_new[..., 0] + q_new[..., 1] * q_new[..., 1]
                          + q_new[..., 2] * q_new[..., 2] + q_new[..., 3] * q_new[..., 3])
        q_new = q_new / torch.clamp_min(norm, _TINY)[..., None]
        q = torch.where(converged[..., None], q, q_new)
    return q
