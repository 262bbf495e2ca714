"""The port's cubic root finder and point-triangle narrowphase against the
JAX package.

Tolerances and why:

* The cubic: ``found`` equal, ``t`` within 2e-4.  XLA on the CPU computes
  ``x/3`` as a product with the reciprocal, contracts ``a*b+c`` into FMAs and
  has its own ``pow``/``acos``/``cos``; eager PyTorch does none of that, so
  about one root in five differs by an ulp or more, and the closed form
  amplifies that near close roots.  Measured on the seeded set (cubics
  built from roots at least 0.02 from 0, 1 and each other, scale e^±2, half
  of them with a complex pair): max |Δt| 8.4e-5, no ``found`` differs.  On
  random coefficients of any conditioning 0.14% of the ``found`` flags
  differ, which is why the set is built from its roots.  The hand-made
  degenerate cases agree exactly with the JAX function run op by op (no
  ``jit``, so XLA fuses nothing and rounds each operation as PyTorch does);
  under ``jit`` its fused rounding moves the roots that lie exactly on 0 and
  1 (it finds t = 1 for the roots 0, 1, 2 and for 1, 2, 3).
* The CCD test and phase 1: equal outcomes on 100,000 random configurations.
* The narrowphase (the plain twin of kernel T6): contacts equal, on states
  of a JAX run of the 96-tet, spacing-1.0 soup and on one of them with the
  positions jittered so that points cross face planes and the cubic runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pies_tpu
from pies_tpu.collision import narrowphase as jnarrow
from pies_tpu.collision.broadphase import detect_point_tri_collisions as jdetect
from pies_tpu.ops import cubic as jcubic
from pies_tpu.options import SolverName as JName, SolverOptions as JOptions
from pies_tpu_torch import convert
from pies_tpu_torch.collision import broadphase as tb
from pies_tpu_torch.collision import narrowphase as tnarrow
from pies_tpu_torch.ops import cubic as tcubic

from torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)

T_TOL = 2e-4
N_TETS = 96
SCENE = dict(spacing=1.0, scale=0.8, w=2000.0, height=0.5, jitter=0.05)

# (a, b, c, d): every degree branch and the reference's quirks.
HAND = np.array([
    [0, 0, 0, 0],  # constant, d == 0: found at t = 0
    [0, 0, 0, 1],  # constant, no root
    [0, 0, 2, -1],  # linear, t = 0.5
    [0, 0, 1, 1],  # linear, root at -1
    [0, 1, -1.5, 0.5],  # quadratic, roots 0.5 and 1
    [0, -1, 2.5, -1],  # quadratic quirk: (-c - sqrt)/2b = 2 > 1, gives up
    [0, 1, 0.5, -0.5],  # quadratic, first root -1 < 0, takes 0.5
    [0, 1, 0, 1],  # quadratic, negative discriminant
    [1, -3, 2, 0],  # cubic, d == 0: roots 0, 1, 2
    [1, -1, 0, 0],  # cubic, double root at 0
    [1, -6, 11, -6],  # cubic, roots 1, 2, 3
    [1, 0, 0, -0.125],  # one real root 0.5 (positive discriminant)
    [1, 0, 1, -0.5],  # one real root, complex pair
    [2, -3, 1, 0],  # roots 0, 0.5, 1
    [-1, 3, -2, 0],  # the same, negated
    [1, -1.5, 0.5, 0],  # roots 0, 0.5, 1 again, another scale
], np.float32).T


def _seeded_cubics(n=40000, seed=0):
    rng = np.random.default_rng(seed)
    r = rng.uniform(-0.5, 1.5, (n, 3))
    s = np.sort(r, 1)
    ok = ((np.abs(r) > 0.02).all(1) & (np.abs(r - 1) > 0.02).all(1)
          & (np.diff(s, 1) > 0.02).all(1))
    r = r[ok]
    a = rng.choice([-1.0, 1.0], len(r)) * np.exp(rng.uniform(-2, 2, len(r)))
    pair = rng.random(len(r)) < 0.5
    q = rng.uniform(0.05, 1.0, len(r))
    p = r[:, 1]
    real = [a, -a * r.sum(1), a * (r[:, 0] * r[:, 1] + r[:, 0] * r[:, 2] + r[:, 1] * r[:, 2]),
            -a * r.prod(1)]
    cplx = [a, -a * (r[:, 0] + 2 * p), a * (2 * p * r[:, 0] + p * p + q * q),
            -a * r[:, 0] * (p * p + q * q)]
    return np.stack([np.where(pair, c, rr) for rr, c in zip(real, cplx)]).astype(np.float32)


@pytest.mark.parametrize("case", ["seeded", "hand_made"])
def test_earliest_root_matches(case):
    coeffs = _seeded_cubics() if case == "seeded" else HAND
    ref = jcubic.earliest_root_in_unit_interval
    t_ref, f_ref = (jax.jit(ref) if case == "seeded" else ref)(*map(jnp.asarray, coeffs))
    t, f = tcubic.earliest_root_in_unit_interval(*map(torch.from_numpy, coeffs))
    f_ref, t_ref = np.asarray(f_ref), np.asarray(t_ref)
    np.testing.assert_array_equal(f.numpy(), f_ref)
    np.testing.assert_allclose(t.numpy()[f_ref], t_ref[f_ref], rtol=0,
                               atol=T_TOL if case == "seeded" else 0)
    if case == "hand_made":
        np.testing.assert_array_equal(
            f.numpy(), [1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 0, 1, 1, 1, 1, 1])


def _random_geometry(n=100_000, seed=3):
    rng = np.random.default_rng(seed)
    v = [rng.standard_normal((n, 3)).astype(np.float32) for _ in range(6)]
    v[3] = v[0] + (0.3 * rng.standard_normal((n, 3))).astype(np.float32)
    return v


def _jcols(x):
    return (x[:, 0], x[:, 1], x[:, 2])


def _tcols(x):
    t = torch.from_numpy(x)
    return (t[:, 0], t[:, 1], t[:, 2])


def test_point_triangle_ccd_matches():
    v = _random_geometry()
    hit_ref, _ = jax.jit(lambda *a: jnarrow.point_triangle_ccd_cols(*map(_jcols, a), 0.1))(
        *map(jnp.asarray, v))
    hit, _ = tnarrow.point_triangle_ccd_cols(*map(_tcols, v), 0.1)
    assert int(hit.sum()) > 500
    np.testing.assert_array_equal(hit.numpy(), np.asarray(hit_ref))


def test_phase1_face_matches():
    v = _random_geometry(seed=4)
    b0, ab0, ac0, b1, ab1, ac1 = v[1], v[2] - v[1], v[4] - v[1], v[5], v[2] - v[5], v[4] - v[5]
    corners = [(v[0], v[3]), (v[3], v[0])]

    def ref(*a):
        return jnarrow.point_triangle_phase1_face(
            *map(_jcols, a[:6]), [_jcols(a[6]), _jcols(a[8])], [_jcols(a[7]), _jcols(a[9])], 0.1)

    args = (b0, ab0, ac0, b1, ab1, ac1, *corners[0], *corners[1])
    out_ref = jax.jit(ref)(*map(jnp.asarray, args))
    out = tnarrow.point_triangle_phase1_face(
        *map(_tcols, args[:6]), [_tcols(args[6]), _tcols(args[8])],
        [_tcols(args[7]), _tcols(args[9])], 0.1)
    for (p, c), (pr, cr) in zip(out, out_ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(pr))
        np.testing.assert_array_equal(c.numpy(), np.asarray(cr))
        assert int(p.sum()) > 0 and int(c.sum()) > 0


@pytest.fixture(scope="module")
def reference_run():
    j = pies_tpu.Solver(JOptions(solver=JName.PD), enable_collisions=True, dense_operator_max=0)
    j.create_tet_soup(N_TETS, **SCENE)
    j._prepare()
    params, cfg = j.current_params(), j._config
    det = jax.jit(lambda x, p, c: jdetect(x, p, j._topology.triangles, j._topology.tri_mask,
                                          params, cfg, cache=c))
    states = {}
    for tick in range(26):
        if tick in (0, 19, 25):
            s = j._state
            states[tick] = (s.positions + params.dt * s.velocities * s.node_mask[:, None], s)
        j.tick()
    return j, states, det


@pytest.mark.parametrize("state", ["tick0", "tick19", "tick25", "tick25_jittered"])
def test_narrowphase_matches_reference(reference_run, state):
    j, states, det = reference_run
    tick = int(state.split("_")[0][4:])
    x, s = states[tick]
    if state.endswith("jittered"):
        rng = np.random.default_rng(5)
        x = x + jnp.asarray((0.05 * rng.standard_normal(x.shape)).astype(np.float32)) \
            * s.node_mask[:, None]
    pt_idx, pt_mask, over, new = det(x, s.prev_positions, s.bp)

    cfg = convert.config_from(j._config)
    params = convert.params_from(jax.tree.map(np.asarray, j.current_params()))
    cache = convert.cache_from_numpy(jax.tree.map(np.asarray, new))
    lay = tb.body_layout(cfg, j._topology.tri_mask.shape[0])
    overflow = torch.zeros(1, dtype=torch.int32)
    stats = {}
    out = tb.pt_narrowphase_plain(
        torch.from_numpy(np.array(x)), torch.from_numpy(np.array(s.prev_positions)),
        torch.from_numpy(np.array(j._topology.tri_mask)), cache, lay, tb.scalars(params),
        overflow, stats=stats)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(pt_idx))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(pt_mask))
    assert int(out[2][0]) == int(np.asarray(pt_mask).sum())
    assert int(overflow[0]) == int(bool(over))
    if state.endswith("jittered"):
        assert stats["cross_combos"] > 0  # phase 2 ran
    else:
        assert int(out[2][0]) > 0
