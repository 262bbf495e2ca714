"""The port's lattice mesher (``pies_tpu_torch/scene/tetmesh.py`` with its
own ``native/tetmesh.cpp``) and ``Solver.add_tri_mesh_volume`` against the
JAX package, on the CPU.

* ``tetrahedralize`` on the bench's cube (``scripts/bench_all.py:86-97``)
  at resolutions 4 and 10, on ``tests/test_tetmesh.py``'s icosphere and
  lat-long sphere, by the native and the NumPy route (the JAX package's
  route forced alike), with and without ``target_tets``: points, tets and
  surface equal.  The two routes differ from each other in the points' last
  bits (the native lattice is computed in double), so each is held to its
  own counterpart.
* The cube at resolution 47, scaled by 6, by the native route: equal to
  the JAX package's, and to the committed dump
  ``scripts/refbench/tet_cube_mesh_100k.txt`` (110,592 nodes, 622,938
  tets, 26,508 surface triangles; tets and surface equal, points within
  1e-6 of the scale 6: the dump prints 8 significant digits, measured
  9.5e-7).
* ``add_tri_mesh_volume`` on the icosphere scene of
  ``tests/test_tetmesh.py:78-100`` through both ``Solver``s (the JAX one
  with ``dense_operator_max=0``, the Jacobi-PCG path the port runs): the
  scene's arrays equal, one tick within 3e-6, and 80 ticks within 1e-3,
  with ``sim_failed`` equal on every tick; the test measures the JAX
  package's own spread (runs started one float32 ulp apart, two seeds)
  and holds it below 1e-3 too (measured 7.8e-5 and 4.5e-5; the port
  6.5e-5).
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pies_tpu
from pies_tpu.native import load as jnative
from pies_tpu.options import SolverName as JName, SolverOptions as JOptions
from pies_tpu.scene import tetmesh as jmesh
import pies_tpu_torch as pt
from pies_tpu_torch.native import load as tnative
from pies_tpu_torch.scene import tetmesh as tmesh
from pies_tpu_torch.scene.mesh_dump import load_mesh_txt

from torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)

CUBE_V = np.array([[0, 0, 0], [2, 0, 0], [2, 2, 0], [0, 2, 0],
                   [0, 0, 2], [2, 0, 2], [2, 2, 2], [0, 2, 2]],
                  np.float32) + np.array([0.0, 0.5, 0.0], np.float32)
CUBE_F = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                   [1, 2, 6], [1, 6, 5], [2, 3, 7], [2, 7, 6], [3, 0, 4], [3, 4, 7]],
                  np.int32)
DUMP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                    "refbench", "tet_cube_mesh_100k.txt")
TICKS = 80


def icosphere(radius=1.0):
    """``tests/test_tetmesh.py``'s icosahedron."""
    phi = (1 + 5 ** 0.5) / 2
    v = np.array([[-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
                  [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
                  [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]], np.float32)
    v = v / np.linalg.norm(v, axis=1, keepdims=True) * radius
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int32)
    return v, f


def latlong_sphere(n=12):
    """``tests/test_tetmesh.py``'s lat-long sphere."""
    verts, faces = [], []
    for i in range(n + 1):
        th = math.pi * i / n
        for j in range(2 * n):
            ph = math.pi * j / n
            verts.append([math.sin(th) * math.cos(ph), math.cos(th),
                          math.sin(th) * math.sin(ph)])
    for i in range(n):
        for j in range(2 * n):
            a, b = i * 2 * n + j, i * 2 * n + (j + 1) % (2 * n)
            c, d = (i + 1) * 2 * n + j, (i + 1) * 2 * n + (j + 1) % (2 * n)
            faces += [[a, b, c], [b, d, c]]
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


MESHES = {
    "cube4": (CUBE_V, CUBE_F, 4),
    "cube10": (CUBE_V, CUBE_F, 10),
    "icosphere6": icosphere() + (6,),
    "latlong8": latlong_sphere() + (8,),
}


def _jax_mesh(v, f, res, route, monkeypatch, **kw):
    """The JAX package's ``tetrahedralize`` by ``route`` (its native
    library, built by its own loader as its tests do, or its NumPy route)."""
    if route == "numpy":
        monkeypatch.setattr(jnative, "try_load", lambda: None)
    else:
        assert jnative.try_load() is not None, "the JAX package's native mesher did not build"
    return jmesh.tetrahedralize(v, f, res, **kw)


def _port_mesh(v, f, res, route, monkeypatch, **kw):
    """The port's ``tetrahedralize`` by ``route`` (its own native library, or
    its NumPy route with the loader made to find none)."""
    if route == "numpy":
        monkeypatch.setattr(tnative, "try_load", lambda: None)
    else:
        assert tnative.try_load() is not None, "the port's native mesher did not build"
    out = tmesh.tetrahedralize(v, f, res, **kw)
    assert tmesh.last_route == route
    return out


def _equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_tetrahedralize_equals_reference(mesh, route, monkeypatch):
    v, f, res = MESHES[mesh]
    _equal(_port_mesh(v, f, res, route, monkeypatch),
           _jax_mesh(v, f, res, route, monkeypatch))
    # Without the snap as well: the lattice itself.
    _equal(_port_mesh(v, f, res, route, monkeypatch, snap_surface=False),
           _jax_mesh(v, f, res, route, monkeypatch, snap_surface=False))


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_target_tets_equals_reference(route, monkeypatch):
    """The element budget overrides the resolution, as in the JAX package."""
    v, f = latlong_sphere(10)
    ours = _port_mesh(v, f, 8, route, monkeypatch, target_tets=3000)
    _equal(ours, _jax_mesh(v, f, 8, route, monkeypatch, target_tets=3000))
    assert 1000 < ours[1].shape[0] < 9000
    with pytest.raises(ValueError, match="target_tets"):
        tmesh.tetrahedralize(v, f, target_tets=5)


def test_mesh_helpers_equal_reference():
    """``enclosed_volume``, ``points_in_mesh``, ``closest_point_on_mesh``,
    ``tet_quality`` and ``surface_error`` on the snapped lat-long sphere."""
    v, f = latlong_sphere()
    p, tets, surf = tmesh.tetrahedralize(v, f, 8)
    assert tmesh.enclosed_volume(v, f) == jmesh.enclosed_volume(v, f)
    q = np.random.default_rng(0).uniform(-1.2, 1.2, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(tmesh.points_in_mesh(q, v, f), jmesh.points_in_mesh(q, v, f))
    _equal(tmesh.closest_point_on_mesh(q, v, f), jmesh.closest_point_on_mesh(q, v, f))
    assert tmesh.tet_quality(p, tets) == jmesh.tet_quality(p, tets)
    assert tmesh.surface_error(p, surf, v, f) == jmesh.surface_error(p, surf, v, f)


def test_resolution_47_equals_reference_and_the_dump(monkeypatch):
    """The full-width import (the dump's cube) by the native route."""
    v = CUBE_V * np.float32(6.0)
    ours = _port_mesh(v, CUBE_F, 47, "native", monkeypatch)
    _equal(ours, _jax_mesh(v, CUBE_F, 47, "native", monkeypatch))
    points, tets, surface = load_mesh_txt(DUMP)
    assert ours[1].shape == (622_938, 4) and ours[0].shape == (110_592, 3)
    np.testing.assert_array_equal(ours[1], tets)
    np.testing.assert_array_equal(ours[2], surface)
    np.testing.assert_allclose(ours[0], points, rtol=0, atol=1e-6 * 6.0)


def test_native_library_lives_in_the_port():
    """The port builds its own mesher under ``pies_tpu_torch/_build`` and
    never the JAX package's library."""
    path = tnative.library_path()
    assert tnative.try_load() is not None and path.exists()
    assert path.parent.name == "_build" and path.parent.parent.name == "pies_tpu_torch"


# ---------------------------------------------------------------------------
# add_tri_mesh_volume end to end


def _icosphere_scene(solver):
    v, f = icosphere(1.0)
    solver.add_tri_mesh_volume(v + np.array([0, 3.0, 0], np.float32), f, density=1.0,
                               strain_stiffness=500.0, volume_stiffness=500.0)
    return solver


@pytest.fixture(scope="module")
def icosphere_runs():
    """Both packages' icosphere scene: the JAX run's state before and after
    each of ``TICKS`` ticks and its latch per tick."""
    j = _icosphere_scene(pies_tpu.Solver(JOptions(solver=JName.PD), enable_collisions=False,
                                         dense_operator_max=0))
    j._prepare()
    states, failed = [j._state], []
    for _ in range(TICKS):
        j.tick()
        states.append(j._state)
        failed.append(bool(j.sim_failed))
    return j, states, failed


def _port_scene():
    t = _icosphere_scene(pt.Solver(pt.SolverOptions(), enable_collisions=False, device="cpu"))
    t._prepare()
    return t


def test_add_tri_mesh_volume_scene_equals_reference(icosphere_runs):
    j, states, _ = icosphere_runs
    t = _port_scene()
    s0 = jax.tree.map(np.asarray, states[0])
    for name in ("positions", "velocities", "inv_mass", "mass", "radius", "node_mask"):
        np.testing.assert_array_equal(getattr(t.state, name).numpy(), getattr(s0, name), name)
    jt, tt = jax.tree.map(np.asarray, j._topology), t.topology
    for fam in ("strain", "volume"):
        for name in ("idx", "qinv", "lo", "hi", "w"):
            np.testing.assert_array_equal(getattr(getattr(tt, fam), name).numpy(),
                                          getattr(getattr(jt, fam), name), f"{fam}.{name}")
    np.testing.assert_array_equal(tt.triangles.numpy(), jt.triangles)
    np.testing.assert_array_equal(tt.tri_mask.numpy(), jt.tri_mask)
    np.testing.assert_array_equal(t.get_triangles(), j.get_triangles())
    assert float(t.state.radius[0]) == 0.5 and float(t.state.inv_mass[0]) == 1.0


def _jax_spread(j, states, seed):
    """The JAX run from its initial state with half the live coordinates
    (positions and previous positions) moved one float32 ulp: its largest
    distance from the unmoved run after ``TICKS`` ticks."""
    n = j._builder.num_nodes
    rng = np.random.default_rng(seed)
    p = np.array(states[0].positions)
    away = np.where(rng.random(p[:n].shape) < 0.5, np.float32(np.inf), np.float32(-np.inf))
    p[:n] = np.where(rng.random(p[:n].shape) < 0.5, np.nextafter(p[:n], away), p[:n])
    j._state = dataclasses.replace(states[0], positions=jnp.asarray(p),
                                   prev_positions=jnp.asarray(p))
    for _ in range(TICKS):
        j.tick()
    return float(np.abs(np.asarray(j._state.positions)[:n]
                        - np.asarray(states[TICKS].positions)[:n]).max())


def test_add_tri_mesh_volume_ticks_match_reference(icosphere_runs):
    """One tick within 3e-6; 80 ticks within 1e-3, the latch equal per tick;
    the body falls and stays above the floor, as the JAX test asserts."""
    j, states, failed = icosphere_runs
    t = _port_scene()
    n = t._builder.num_nodes
    t.tick()
    one = np.abs(t.state.positions.numpy()[:n] - np.asarray(states[1].positions)[:n]).max()
    assert one <= 3e-6, one
    for k in range(1, TICKS):
        t.tick()
        assert t.sim_failed == failed[k]
    p = t.get_vertices()["position"]
    far = np.abs(p - np.asarray(states[TICKS].positions)[:n]).max()
    spread = [_jax_spread(j, states, seed) for seed in range(2)]
    assert far <= 1e-3 and max(spread) < 1e-3, (far, spread)
    assert np.all(np.isfinite(p)) and p[:, 1].mean() < 3.0 and p[:, 1].min() > -1.5
