"""The port's constraint projections (the plain twins of kernels T12 and
T13, the unfused tet force of T9, the quaternion functions) against the JAX
package's ``constraints.projections`` and ``ops.math3d`` on the same seeded
NumPy inputs.

Tolerance 1e-5 relative to the largest value compared (float32 sums in a
different order, XLA's fused expressions; measured at most 1.9e-6, on the
shape projection).  The cases include a degenerate distance pair (coincident
endpoints: the ``(1, 0, 0)`` fallback), a flat and a degenerate bend, a
padded group, an empty goal group and groups that overlap in nodes.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pies_tpu import topology as jtopo
from pies_tpu.constraints import projections as jproj
from pies_tpu.ops import math3d as jmath
from pies_tpu_torch import topology as ttopo
from pies_tpu_torch.constraints import projections as tproj
from pies_tpu_torch.ops import math3d as tmath

RTOL = 1e-5


def _close(port, ref, rtol=RTOL, what=""):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30) if ref.size else 1.0
    assert float(np.abs(port - ref).max()) <= rtol * scale if ref.size else True, what


def _dev(batch):
    return ttopo.to_device(batch, "cpu")


def _batches_equal(port, ref, fields):
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(port, f)), np.asarray(getattr(ref, f)), f)


def _points(n=40, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)


def test_distance_rows_match_reference_with_a_degenerate_pair():
    rest_pos = _points()
    rng = np.random.default_rng(1)
    pairs = rng.integers(0, 40, (61, 2)).astype(np.int32)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    w = rng.uniform(100.0, 5000.0, pairs.shape[0]).astype(np.float32)
    jb = jtopo.build_distance(pairs, rest_pos, w)
    tb = ttopo.build_distance(pairs, rest_pos, w)
    _batches_equal(tb, jb, ("idx", "rest", "w"))
    x = rest_pos + 0.3 * rng.standard_normal(rest_pos.shape).astype(np.float32)
    x[pairs[0, 0]] = x[pairs[0, 1]]  # coincident endpoints: dist <= 1e-5
    tx = torch.from_numpy(x)
    delta = tproj.project_distance_delta(tx, _dev(tb))
    ref = np.asarray(jproj.project_distance_delta(jnp.asarray(x), jb))
    _close(delta, ref, what="delta")
    assert abs(float(delta[0, 0]) + float(jb.rest[0])) < 1e-6  # -(0 + rest * 1)
    half = 0.5 * np.asarray(jb.w)[:, None] * ref
    rows = tproj.distance_rows(tx, _dev(tb))
    _close(rows, np.concatenate([half, -half]), what="rows")
    out = torch.full((rows.shape[0], 3), np.nan)
    assert tproj.distance_rows_plain(tx, _dev(tb), out=out) is out and torch.equal(out, rows)


def test_bend_rows_match_reference_with_flat_and_degenerate_bends():
    rng = np.random.default_rng(2)
    rest_pos = _points(30, 3)
    # A flat bend (both triangles in the plane y = 0) and a degenerate one
    # (three collinear nodes: both normals vanish).
    rest_pos[:4] = [[0, 0, 0], [1, 0, 0], [0, 0, 1], [1, 0, -1]]
    rest_pos[4:8] = [[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0]]
    idx = np.concatenate([[[0, 1, 2, 3], [4, 5, 6, 7]],
                          np.stack([rng.permutation(22)[:4] + 8 for _ in range(20)])])
    idx = idx.astype(np.int32)
    w = rng.uniform(100.0, 5000.0, idx.shape[0]).astype(np.float32)
    jb = jtopo.build_bend(idx, rest_pos, w)
    tb = ttopo.build_bend(idx, rest_pos, w)
    _batches_equal(tb, jb, ("idx", "rest_angle", "w"))
    x = rest_pos.copy()
    x[8:] += 0.2 * rng.standard_normal((22, 3)).astype(np.float32)
    inv_mass = rng.uniform(0.5, 2.0, 30).astype(np.float32)
    inv_mass[9] = 0.0  # a pinned node among the bends
    p = tproj.project_bend(torch.from_numpy(x), torch.from_numpy(inv_mass), _dev(tb))
    ref = np.asarray(jproj.project_bend(jnp.asarray(x), jnp.asarray(inv_mass), jb))
    _close(p, ref, what="project_bend")
    np.testing.assert_array_equal(p[:2].numpy(), x[idx[:2]])  # at rest / degenerate: unmoved
    rows = tproj.bend_rows(torch.from_numpy(x), torch.from_numpy(inv_mass), _dev(tb))
    _close(rows, (np.asarray(jb.w)[:, None, None] * ref).reshape(-1, 3), what="rows")


def _groups(seed, n_nodes, sizes, overlap):
    rng = np.random.default_rng(seed)
    groups, at = [], 0
    for size in sizes:
        ids = (np.arange(at, at + size) % n_nodes).astype(np.int32)
        at += size - overlap  # consecutive groups share `overlap` nodes
        groups.append(ids)
    return groups, rng


@pytest.mark.parametrize("case", ["overlapping", "padded", "large"])
def test_shape_projection_matches_reference(case):
    sizes, overlap, caps = {"overlapping": ((9, 12, 5, 30), 3, {}),
                            "padded": ((8, 8), 0, dict(group_cap=4, member_cap=24)),
                            "large": ((300, 7), 2, {})}[case]
    n = 320
    rest_pos = _points(n, 5)
    groups, rng = _groups(6, n, sizes, overlap)
    inv_mass = rng.uniform(0.05, 2.0, n).astype(np.float32)
    w = rng.uniform(500.0, 4000.0, len(groups)).astype(np.float32)
    spec = [(g, rest_pos[g]) for g in groups]
    jb = jtopo.build_groups(spec, w, inv_mass, kind="shape", **caps)
    tb = ttopo.build_groups(spec, w, inv_mass, kind="shape", **caps)
    _batches_equal(tb, jb, ("node_idx", "group_idx", "mat_coords", "member_mask", "w",
                            "group_mask", "inv_count", "qinv", "transforms"))
    assert tb.max_count == max(sizes) and tb.member_start[len(sizes)] == sum(sizes)
    # A rigid motion plus noise, so that the rotation has something to find.
    ang = 0.7
    rot = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    x = (rest_pos @ rot.T + 0.05 * rng.standard_normal((n, 3)) + [0.3, 1.0, -0.2])
    x = x.astype(np.float32)
    mass = np.where(inv_mass > 0, 1.0 / inv_mass, 0.0).astype(np.float32)
    g = tb.w.shape[0]
    quats = np.tile(np.array([1, 0, 0, 0], np.float32), (g, 1))
    tx, tm, tbd = torch.from_numpy(x), torch.from_numpy(mass), _dev(tb)
    com, mom = tproj.shape_group_moments(tx, tm, tbd)
    jcom, jmom = jproj.shape_group_moments(jnp.asarray(x), jnp.asarray(mass), jb)
    _close(com, jcom, what="com")
    _close(mom, jmom, what="moment")
    for iters in (1, 20):
        p, q = tproj.project_shape(tx, tm, torch.from_numpy(quats), tbd, iters)
        jp, jq = jproj.project_shape(jnp.asarray(x), jnp.asarray(mass), jnp.asarray(quats),
                                     jb, iters)
        _close(q, jq, what=f"quats after {iters}")
        _close(p, jp, what=f"projection after {iters}")
    if case == "padded":
        np.testing.assert_array_equal(q[2:].numpy(), quats[2:])  # F = I keeps the seed
    tq = torch.from_numpy(quats.copy())
    rows = tproj.shape_rows(tx, tm, tq, tbd, 20)
    wm = np.asarray(jb.w)[np.asarray(jb.group_idx)] * np.asarray(jb.member_mask)
    _close(rows, wm[:, None] * np.asarray(jp), what="rows")
    assert torch.equal(tq, q)  # the rotations are updated in place
    frozen = torch.from_numpy(quats.copy())
    tproj.shape_rows(tx, tm, frozen, tbd, 20, failed=torch.tensor([1, 0], dtype=torch.int32))
    np.testing.assert_array_equal(frozen.numpy(), quats)  # a skipped tick keeps them


def test_goal_projection_matches_reference_with_an_empty_group():
    n = 50
    rest_pos = _points(n, 7)
    rng = np.random.default_rng(8)
    groups = [np.arange(0, 12, dtype=np.int32), np.zeros(0, np.int32),
              np.arange(8, 30, dtype=np.int32)]  # the middle one empty, the others overlap
    w = np.array([3000.0, 1000.0, 500.0], np.float32)
    spec = [(g, rest_pos[g]) for g in groups]
    jb = jtopo.build_groups(spec, w, np.ones(n), kind="goal")
    tb = ttopo.build_groups(spec, w, np.ones(n), kind="goal")
    _batches_equal(tb, jb, ("node_idx", "group_idx", "mat_coords", "member_mask", "w",
                            "group_mask", "inv_count", "qinv", "transforms"))
    np.testing.assert_array_equal(tb.member_start, [0, 12, 12, 34])
    transforms = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    transforms[:, :3, :] = rng.standard_normal((3, 3, 4)).astype(np.float32)
    jb = dataclasses.replace(jb, transforms=transforms)
    tb = dataclasses.replace(tb, transforms=transforms)
    ref = np.asarray(jproj.project_goal(jb))
    _close(tproj.project_goal(_dev(tb)), ref, what="project_goal")
    wm = w[np.asarray(jb.group_idx)] * np.asarray(jb.member_mask)
    _close(tproj.goal_rows(_dev(tb)), wm[:, None] * ref, what="rows")


@pytest.mark.parametrize("kind", ["strain", "volume"])
def test_unfused_tet_force_matches_reference(kind):
    rng = np.random.default_rng(9)
    rest_pos = _points(24, 10)
    tets = np.stack([rng.permutation(24)[:4] for _ in range(30)]).astype(np.int32)
    lo, hi = (0.8, 1.0) if kind == "strain" else (1.0, 1.0)
    w = rng.uniform(500.0, 2000.0, 30).astype(np.float32)
    jb = jtopo.build_tets(tets, rest_pos, w, lo, hi)
    tb = _dev(ttopo.build_tets(tets, rest_pos, w, lo, hi))
    x = (1.3 * rest_pos + 0.2 * rng.standard_normal(rest_pos.shape)).astype(np.float32)
    x[tets[0, 1]] = 2 * x[tets[0, 0]] - x[tets[0, 1]]  # likely inverts tet 0
    ref = np.asarray(jproj.tet_force12(jnp.asarray(x), jb, kind))  # [C, 12]
    rows = tproj.tet_force12_gathered(torch.from_numpy(x), tb, tb, kind=kind)
    want = np.concatenate([ref[:, 3 * a:3 * a + 3] for a in range(4)])
    _close(rows, want, what=kind)
    assert float(np.abs(want).max()) > 0


def test_quaternion_functions_match_reference():
    rng = np.random.default_rng(11)
    a = rng.standard_normal((16, 4)).astype(np.float32)
    b = rng.standard_normal((16, 4)).astype(np.float32)
    q = a / np.linalg.norm(a, axis=1, keepdims=True)
    _close(tmath.quat_mul(torch.from_numpy(a), torch.from_numpy(b)),
           jmath.quat_mul(jnp.asarray(a), jnp.asarray(b)), what="quat_mul")
    _close(tmath.quat_to_mat(torch.from_numpy(q)), jmath.quat_to_mat(jnp.asarray(q)),
           what="quat_to_mat")
    ang = rng.uniform(0, 3, 16).astype(np.float32)
    axis = q[:, :3] / np.linalg.norm(q[:, :3], axis=1, keepdims=True)
    _close(tmath.quat_from_axis_angle(torch.from_numpy(ang), torch.from_numpy(axis)),
           jmath.quat_from_axis_angle(jnp.asarray(ang), jnp.asarray(axis)), what="axis_angle")
    mats = (rng.standard_normal((16, 3, 3)) + 2 * np.eye(3)).astype(np.float32)
    seed = np.tile(np.array([1, 0, 0, 0], np.float32), (16, 1))
    for iters in (0, 3, 20):
        got = tmath.extract_rotation(torch.from_numpy(mats), torch.from_numpy(seed), iters)
        _close(got, jmath.extract_rotation(jnp.asarray(mats), jnp.asarray(seed), iters),
               what=f"extract_rotation {iters}")
    r = tmath.quat_to_mat(got).numpy()
    np.testing.assert_allclose(r @ r.transpose(0, 2, 1), np.tile(np.eye(3), (16, 1, 1)),
                               atol=1e-5)


def test_shape_sums_follow_the_kernels_fixed_order():
    """The twin's per-group sums are the 128-lane strided sums and the
    pairwise tree of kernel T13, whatever the group sizes: rebuilt here with
    a Python loop per group."""
    n = 400
    rest_pos = _points(n, 12)
    groups, rng = _groups(13, n, (130, 1, 257, 64), 5)
    tb = _dev(ttopo.build_groups([(g, rest_pos[g]) for g in groups], 1000.0,
                                 np.ones(n), kind="shape"))
    x = torch.from_numpy(_points(n, 14))
    mass = torch.from_numpy(rng.uniform(0.5, 3.0, n).astype(np.float32))
    got = tproj.shape_group_sums(x, mass, tb)
    for g, ids in enumerate(groups):
        start = int(tb.member_start[g])
        lanes = torch.zeros((tproj.SHAPE_BLOCK, 15))
        for k, node in enumerate(ids):
            mat = tb.mat_coords[start + k]
            xg, m = x[node], mass[node]
            mx = m * xg
            v = torch.cat([xg, torch.stack([mx[i] * mat[j] for i in range(3) for j in range(3)]),
                           m * mat])
            lane = k % tproj.SHAPE_BLOCK
            lanes[lane] = v if k < tproj.SHAPE_BLOCK else lanes[lane] + v
        s = tproj.SHAPE_BLOCK // 2
        while s:
            lanes = lanes[:s] + lanes[s:2 * s]
            s //= 2
        assert torch.equal(got[g], lanes[0]), g
