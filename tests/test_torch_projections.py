"""The port's fused strain + volume tet force (kernel T1 and its twin)
against the JAX package.

Both packages build the same tets with their own ``build_tets`` from seeded
rest positions; the current positions deform, compress or invert them.
Tolerance: 1e-4 of the largest force.  The force is a difference of
products of order w·|F| ≈ 4e3 that cancel towards the rest shape, so a few
float32 ulps of the operands (the JAX package fuses multiply-adds, the port
does not) show at ~1e-6 relative; 1e-4 leaves room for the SVD's branch
points at nearly repeated singular values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pies_tpu import topology as jtopo
from pies_tpu.constraints import projections as jproj
from pies_tpu_torch import topology as ttopo
from pies_tpu_torch.constraints import projections as tproj

REL = 1e-4
N_TETS = 96


def _rest(seed=3):
    rng = np.random.default_rng(seed)
    unit = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    origins = rng.uniform(-5, 5, (N_TETS, 1, 3)).astype(np.float32)
    shape = unit[None] + 0.1 * rng.standard_normal((N_TETS, 4, 3)).astype(np.float32)
    return (origins + shape).reshape(-1, 3).astype(np.float32)


def _current(kind, rest, seed=4):
    rng = np.random.default_rng(seed)
    x = rest.reshape(N_TETS, 4, 3).copy()
    c = x.mean(axis=1, keepdims=True)
    if kind == "deformed":
        x = x + 0.15 * rng.standard_normal(x.shape)
    elif kind == "compressed":
        x = c + 0.6 * (x - c)
    elif kind == "inverted":
        x[:, 3] = 2 * x[:, 0] - x[:, 3]  # reflect corner 3 through corner 0
    return x.reshape(-1, 3).astype(np.float32)


def _batches(pkg, rest):
    idx = np.arange(4 * N_TETS, dtype=np.int32).reshape(-1, 4)
    w = np.full(N_TETS, 2000.0, np.float32)
    strain = pkg.build_tets(idx, rest, w, 0.8, 1.0)
    volume = pkg.build_tets(idx, rest, w, 1.0, 1.0)
    return strain, volume


def _torch_batch(b):
    return ttopo.to_device(b, "cpu")


@pytest.mark.parametrize("kind", ["rest", "deformed", "compressed", "inverted"])
def test_tet_force12_matches_reference(kind):
    rest = _rest()
    x = _current(kind, rest)
    if kind == "inverted":
        e = x.reshape(-1, 4, 3)
        assert np.all(np.linalg.det(np.stack([e[:, k] - e[:, 0] for k in (1, 2, 3)], -1)) < 0)
    js, jv = _batches(jtopo, rest)
    ref = np.asarray(
        jax.jit(lambda x: jproj.tet_force12_fused(x, js, jv, contiguous=True))(jnp.asarray(x))
    ).T  # [12, C]
    ts, tv = (_torch_batch(b) for b in _batches(ttopo, rest))
    out = tproj.tet_force12(torch.from_numpy(x), ts, tv).numpy()
    assert out.shape == (12, N_TETS)
    scale = max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(out, ref, atol=REL * scale)


def test_both_packages_build_identical_tets():
    rest = _rest()
    for jb, tb in zip(_batches(jtopo, rest), _batches(ttopo, rest)):
        for f in ("idx", "qinv", "g", "lo", "hi", "w"):
            np.testing.assert_array_equal(getattr(tb, f), np.asarray(getattr(jb, f)), err_msg=f)
