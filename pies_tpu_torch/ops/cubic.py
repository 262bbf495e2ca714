"""Cubic root finding for continuous collision detection (port of
``pies_tpu/ops/cubic.py``).

The earliest coplanarity time in ``[0, 1]`` in closed form (Cardano, or the
trigonometric form for three real roots), polished by two clamped Newton
steps, with the reference's exact-zero tests for the degenerate degrees
(``CollisionDetection.cpp:143-205``), its quadratic quirk included: when the
``(−c−√)/2b`` root lies past t = 1 it gives up without trying the other.

Every constant is the float32 value the JAX package traces, and every
division is IEEE (``math3d.ieee_div``), so kernel T6's device copy of this code
(``kernels/csrc/pt_narrowphase.cu``) agrees with it bit for bit on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .math3d import ieee_div as _div

_F = np.float32
ONE_THIRD = float(_F(1.0 / 3.0))
TWO_PI_3 = float(_F(2.0943951023931953))
FOUR_PI_3 = float(_F(2.0 * 2.0943951023931953))


def _sign(x: torch.Tensor) -> torch.Tensor:
    return (x > 0).to(x.dtype) - (x < 0).to(x.dtype)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """``sign(x)·|x|^(1/3)`` with the float32 exponent; ``sign(0) = 0``."""
    return _sign(x) * torch.pow(x.abs(), ONE_THIRD)


def _cubic_roots_closed_form(a, b, c, d):
    """The real roots of ``a·t³ + b·t² + c·t + d`` (``a ≠ 0``) as three
    tensors, non-real ones +inf."""
    inv_a = _div(torch.ones_like(a), a)
    p = b * inv_a
    q = c * inv_a
    r = d * inv_a
    p2 = p * p
    big_a = q - _div(p2, 3.0)
    big_b = _div(2.0 * p2 * p - 9.0 * p * q + 27.0 * r, 27.0)
    shift = _div(-p, 3.0)
    disc = _div(big_b * big_b, 4.0) + _div(big_a * big_a * big_a, 27.0)

    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    half_b = _div(-big_b, 2.0)
    s_single = _cbrt(half_b + sq) + _cbrt(half_b - sq)

    m = 2.0 * torch.sqrt(torch.clamp_min(_div(-big_a, 3.0), 1e-30))
    am = big_a * m
    guard = torch.where(am.abs() < 1e-30, 1e-30, 0.0).to(a.dtype)
    arg = torch.clamp(_div(3.0 * big_b, am + guard), -1.0, 1.0)
    theta = _div(torch.acos(arg), 3.0)
    s0 = m * torch.cos(theta)
    s1 = m * torch.cos(theta - TWO_PI_3)
    s2 = m * torch.cos(theta - FOUR_PI_3)

    one_real = disc > 0
    inf = torch.full_like(a, float("inf"))
    r0 = torch.where(one_real, s_single, s0) + shift
    r1 = torch.where(one_real, inf, s1 + shift)
    r2 = torch.where(one_real, inf, s2 + shift)
    return (r0, r1, r2), one_real


def _newton_polish(a, b, c, d, t, steps: int = 2):
    """Newton steps clamped to ``[0, 1]`` (``fastFindRootInInterval``,
    ``CollisionDetection.cpp:107-141``)."""
    for _ in range(steps):
        f = ((a * t + b) * t + c) * t + d
        fp = (3.0 * a * t + 2.0 * b) * t + c
        t_new = t - _div(f, torch.where(fp.abs() < 1e-20, 1e-20, fp))
        t = torch.clamp(torch.where(torch.isfinite(t_new), t_new, t), 0.0, 1.0)
    return t


def earliest_root_in_unit_interval(a, b, c, d):
    """Earliest root of ``a·t³ + b·t² + c·t + d`` in ``[0, 1]``
    (``findRootInInterval``).  Returns ``(t, found)``; ``t`` is 0 where
    nothing was found."""
    roots, one_real = _cubic_roots_closed_form(torch.where(a == 0.0, 1.0, a), b, c, d)
    t_cubic = torch.full_like(a, float("inf"))
    for i, r in enumerate(roots):
        in01 = (r >= 0.0) & (r <= 1.0) & (~one_real if i else True)
        t_cubic = torch.minimum(t_cubic, torch.where(in01, r, float("inf")))
    found_cubic = torch.isfinite(t_cubic)
    t_cubic = torch.where(found_cubic, t_cubic, 0.0)
    t_cubic = torch.where(found_cubic, _newton_polish(a, b, c, d, t_cubic), 0.0)

    disc = c * c - 4.0 * b * d
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    den = torch.where(b == 0.0, 1.0, 2.0 * b)
    t_q1 = _div(-c - sq, den)
    t_q2 = _div(-c + sq, den)
    t_quad = torch.where(t_q1 < 0.0, t_q2, t_q1)
    found_quad = (disc >= 0.0) & (t_q1 <= 1.0) & (t_quad >= 0.0) & (t_quad <= 1.0)
    t_quad = torch.where(found_quad, t_quad, 0.0)

    t_lin = _div(-d, torch.where(c == 0.0, 1.0, c))
    found_lin = (t_lin >= 0.0) & (t_lin <= 1.0)
    t_lin = torch.where(found_lin, t_lin, 0.0)

    found_const = d == 0.0
    is_cubic = a != 0.0
    is_quad = ~is_cubic & (b != 0.0)
    is_lin = ~is_cubic & ~is_quad & (c != 0.0)
    t = torch.where(is_cubic, t_cubic,
                    torch.where(is_quad, t_quad, torch.where(is_lin, t_lin, 0.0)))
    found = torch.where(is_cubic, found_cubic,
                        torch.where(is_quad, found_quad,
                                    torch.where(is_lin, found_lin, found_const)))
    return t, found
