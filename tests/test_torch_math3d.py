"""The port's flat 3x3 SVD / eigensolver twins against the JAX package.

Inputs come from a numpy seed and go through ``pies_tpu.ops.math3d`` and
``pies_tpu_torch.ops.math3d``.  U and V alone are ambiguous for repeated
singular values, so the tests compare σ and the reconstruction U·diag(σ)·Vᵀ.
Tolerance 1e-5 absolute on entries of order 1: a few float32 ulps through 8
Jacobi sweeps (the JAX package fuses multiply-adds, the port does not).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pies_tpu.ops import math3d as jm
from pies_tpu_torch.ops import math3d as tm

TOL = 1e-5
# A zero singular value comes out of the eigenvalues of FᵀF as the square
# root of float32 roundoff, about sqrt(2^-23)·σ₁ ≈ 3.5e-4·σ₁, in both
# packages; the rank-deficient case holds σ₃ and the reconstruction to that.
TOL_RANK_DEFICIENT = 1e-3


def _cases():
    rng = np.random.default_rng(7)
    n = 256
    eye = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    random = rng.standard_normal((n, 3, 3)).astype(np.float32)
    near = (eye + 1e-3 * rng.standard_normal((n, 3, 3))).astype(np.float32)
    inverted = random.copy()
    flip = np.linalg.det(inverted) > 0
    inverted[flip, :, 0] *= -1.0  # every matrix now has det < 0
    rank2 = random.copy()
    rank2[:, :, 2] = rank2[:, :, 0] + 0.5 * rank2[:, :, 1]  # det = 0
    return {
        "identity": eye,  # every apq = 0: the sign(0) branch decides
        "random": random,
        "near_identity": near,
        "inverted": inverted,
        "rank_deficient": rank2,
    }


CASES = _cases()


def _flat_np(m):
    return [m[:, i, j] for i in range(3) for j in range(3)]


def _recon(u, s, v):
    u = np.stack([np.asarray(x) for x in u], -1).reshape(-1, 3, 3)
    v = np.stack([np.asarray(x) for x in v], -1).reshape(-1, 3, 3)
    s = np.stack([np.asarray(x) for x in s], -1)
    return np.einsum("cij,cj,ckj->cik", u, s, v)


@pytest.mark.parametrize("case", list(CASES))
def test_svd3x3_flat_matches_reference(case):
    f = CASES[case]
    if case == "inverted":
        assert np.all(np.linalg.det(f) < 0)
    ju, js, jv = jm.svd3x3_flat(tuple(jnp.asarray(x) for x in _flat_np(f)))
    tu, ts, tv = tm.svd3x3_flat(tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in _flat_np(f)))
    js = np.stack([np.asarray(x) for x in js], -1)
    ts_np = np.stack([x.numpy() for x in ts], -1)
    tol = TOL_RANK_DEFICIENT * js[:, :1] if case == "rank_deficient" else TOL
    np.testing.assert_allclose(ts_np[:, :2], js[:, :2], atol=TOL)
    assert np.all(np.abs(ts_np[:, 2:] - js[:, 2:]) <= tol)
    assert np.all(ts_np[:, 0] >= ts_np[:, 1]) and np.all(ts_np[:, 1] >= ts_np[:, 2])
    rec_t = _recon([x.numpy() for x in tu], ts, [x.numpy() for x in tv])
    tol3 = tol if np.isscalar(tol) else tol[:, :, None]
    assert np.all(np.abs(rec_t - _recon(ju, js.T, jv)) <= tol3)
    # The port's U·diag(σ)·Vᵀ is F itself (σ carries no sign: an inverted F
    # keeps det U·det V = −1).
    assert np.all(np.abs(rec_t - f) <= 10 * tol3)


@pytest.mark.parametrize("case", ["random", "near_identity", "identity"])
def test_eigh3x3_flat_matches_reference(case):
    f = CASES[case]
    s = np.einsum("cji,cjk->cik", f, f)  # symmetric FᵀF
    jw, _ = jm.eigh3x3_flat(tuple(jnp.asarray(x) for x in _flat_np(s)))
    tw, tv = tm.eigh3x3_flat(tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in _flat_np(s)))
    jw = np.stack([np.asarray(x) for x in jw], -1)
    tw_np = np.stack([x.numpy() for x in tw], -1)
    scale = np.abs(jw).max()
    np.testing.assert_allclose(tw_np, jw, atol=TOL * scale)
    # V Λ Vᵀ reproduces the input.
    v = np.stack([x.numpy() for x in tv], -1).reshape(-1, 3, 3)
    np.testing.assert_allclose(np.einsum("cij,cj,ckj->cik", v, tw_np, v), s, atol=10 * TOL * scale)


def test_sign_of_zero_matches_jnp_sign():
    """sign(0) = 0 in both packages: at F = I the Jacobi rotation is the
    identity, so V stays I exactly."""
    f = CASES["identity"][:4]
    tu, ts, tv = tm.svd3x3_flat(tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in _flat_np(f)))
    v = np.stack([x.numpy() for x in tv], -1).reshape(-1, 3, 3)
    np.testing.assert_array_equal(v, np.tile(np.eye(3, dtype=np.float32), (4, 1, 1)))
    np.testing.assert_array_equal(np.stack([x.numpy() for x in ts], -1), np.ones((4, 3), np.float32))
