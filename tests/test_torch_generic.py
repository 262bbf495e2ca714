"""The port's generic PD path against the JAX package, driven through both
packages' ``Solver``: the imported 1,331-node / 6,000-tet mesh
(``scripts/refbench/tet_cube_mesh.txt``, the scene of
``scripts/bench_all.py:116-121`` at a small size) with floor contact
(``create_tet_box``: ``tests/test_torch_tet_box.py``; the other constraint
families: ``tests/test_torch_cloth.py``).  The JAX package runs with
``dense_operator_max=0`` so that both take Jacobi-PCG.

Tolerances and why:

* one tick, 1e-5 absolute (measured 3.1e-6);
* 40 ticks of the mesh with its 4 pins, 1e-4 absolute.  With 16 trips the
  Jacobi-PCG stops far from convergence (residual ~1e2 against ~0.1 for a
  direct solve), so the trajectory follows every float32 rounding of the
  CG.  Measured on this scene over 40 ticks against a float64 run of the
  port: the JAX package parts by 4.5e-5, the port by 2.4e-5; the port
  parts from the JAX package by 4.8e-5.  (Without pins the JAX package's
  spread is 1.72e-4.)
* floor-active node counts and the failure latch: equal on every tick.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import pies_tpu
from pies_tpu.options import SolverName as JName, SolverOptions as JOptions
import pies_tpu_torch as pt
from pies_tpu_torch import convert
from pies_tpu_torch.scene.mesh_dump import add_tet_mesh, load_mesh_txt
from pies_tpu_torch.solver import pd as tpd
from pies_tpu_torch.solver import step as tstep
from pies_tpu_torch.solver import tetcols as ttetcols

from torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = os.path.join(REPO, "scripts", "refbench", "tet_cube_mesh.txt")
PINS = [0, 10, 110, 120]  # the corners of the mesh's x = 0 face
TICKS = 40
STEP_TOL, MESH_TOL = 1e-5, 1e-4


def _mesh(s, pins):
    pts, tets, surf = load_mesh_txt(MESH)
    if isinstance(s, pt.Solver):
        add_tet_mesh(s, pts, tets, surf, pins=pins or ())
        return s
    # The scene as scripts/bench_all.py builds it, pinned as add_tet_mesh pins.
    ids = s._builder._emit_nodes(pts, inv_mass=1.0, radius=0.2)
    s._builder._emit_tets(ids[tets], 1000.0)
    s._builder._emit_triangles(ids[surf])
    if pins:
        s._builder.pos_idx.append(ids[np.asarray(pins)].astype(np.int32))
        s._builder.pos_w.append(np.full(len(pins), 8000.0, np.float32))
    s._dirty = True
    return s


def _solvers(pins=PINS, **kw):
    j = pies_tpu.Solver(JOptions(solver=JName.PD), enable_collisions=False,
                        dense_operator_max=0, **kw)
    t = pt.Solver(pt.SolverOptions(), enable_collisions=False, device="cpu", **kw)
    return _mesh(j, pins), _mesh(t, pins)


def _jax_floor_active(j):
    """Floor-active nodes of the JAX package's next substep (the dense floor
    test on the predicted positions)."""
    s, p = j._state, j.current_params()
    x = np.asarray(s.positions + p.dt * s.velocities * s.node_mask[:, None])
    thr = np.float32(np.asarray(p.floor_height)) + np.float32(np.asarray(p.collision_thickness))
    return int(((x[:, 1] < thr) & (np.asarray(j._topology.floor_count) > 0)).sum())


def test_mesh_slice_matches_reference():
    j, t = _solvers()
    j._prepare()
    n = t._builder.num_nodes
    ref, port, ref_floor, floor = [], [], [], []
    for _ in range(TICKS):
        ref_floor.append(_jax_floor_active(j))
        t.counters = tpd.new_counters("cpu")
        j.tick()
        t.tick()
        floor.append(int(t.counters["floor_active"]))
        assert int(t.counters["cg_trips"]) == 4 * 16  # the exit never fires here
        assert t.sim_failed == j.sim_failed
        ref.append(np.asarray(j._state.positions)[:n])
        port.append(t.state.positions[:n].numpy().copy())
    ref, port = np.stack(ref), np.stack(port)
    assert not t.sim_failed
    assert floor == ref_floor and sum(floor) > 0
    assert np.abs(port[0] - ref[0]).max() <= STEP_TOL
    assert np.abs(port - ref).max() <= MESH_TOL
    assert abs(t.last_residual - j.last_residual) <= 0.05 * j.last_residual


def test_converter_carries_a_mesh_run_across():
    """Five JAX ticks of the unpinned mesh, carried across with convert.py,
    then one more tick in each package."""
    j, _ = _solvers(pins=None)
    for _ in range(5):
        j.tick()
    st = convert.state_from_numpy(jax.tree.map(np.asarray, j._state))
    topo = convert.topology_from_numpy(jax.tree.map(np.asarray, j._topology))
    cfg = convert.config_from(j._config)
    params = convert.params_from(jax.tree.map(np.asarray, j.current_params()))
    assert not ttetcols.applies(st, topo, cfg) and cfg.cg_rtol == 1e-4  # the generic path
    tstep.tick(st, topo, params, cfg)
    j.tick()
    for f, tol in (("positions", STEP_TOL), ("velocities", STEP_TOL / 0.012)):
        np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(j._state, f)),
                                   atol=tol, rtol=0, err_msg=f)


def test_mesh_failure_latch_matches_reference():
    """A non-finite velocity latches sim_failed on the first tick in both
    packages, and later ticks leave the port's state as it is."""
    j, t = _solvers(pins=None)
    t._prepare()
    j._prepare()
    j._state = dataclasses.replace(j._state,
                                   velocities=j._state.velocities.at[7, 0].set(np.inf))
    t.state.velocities[7, 0] = float("inf")
    for tick in range(3):
        j.tick()
        t.tick()
        assert t.sim_failed == j.sim_failed == True, tick  # noqa: E712
        if tick == 0:
            frozen = t.state.positions.clone()
        else:
            torch.testing.assert_close(t.state.positions, frozen, rtol=0, atol=0,
                                       equal_nan=True)
            assert t.last_residual == 0.0


def test_generic_cases_not_ported_yet_raise():
    # A disjoint soup off the tet-column path that keeps its block structure
    # (here through full contact coupling) ticks on the generic path with
    # the block preconditioner (tests/test_torch_coupling.py holds it to the
    # JAX package).
    s = pt.Solver(pt.SolverOptions(), contact_coupling="full", device="cpu")
    s.create_tet_soup(8, spacing=1.6, scale=0.8, w=2000.0)
    s.tick()
    assert not s.sim_failed
    assert not ttetcols.applies(s.state, s.topology, s.config)
    assert tpd.block_layout(s.state, s.topology)
    # Self-contact runs on every PD scene (tests/test_torch_tri_detect.py),
    # and so do edge-edge contacts (tests/test_torch_edges.py): a soup with
    # them prepares, leaves the tet-column path and ticks on the generic one.
    s = pt.Solver(pt.SolverOptions(), enable_edge_collisions=True, device="cpu")
    s.create_tet_soup(8, spacing=1.6, scale=0.8, w=2000.0)
    s._prepare()
    assert s.config.enable_edge_collisions
    assert not ttetcols.applies(s.state, s.topology, s.config)
    s.tick()
    assert not s.sim_failed
    # Ropes run (tests/test_torch_pbd.py): create_rope builds a chain
    # topology, one chain of 7 links from the pinned first node.
    s = pt.Solver(pt.SolverOptions(solver=pt.SolverName.PBD), enable_collisions=True,
                  device="cpu")
    ids = s.create_rope((0, 0, 0), (1, 0, 0), 8, 100.0)
    np.testing.assert_array_equal(ids, np.arange(8))
    assert s.config.distance_chain and tuple(s.topology.chains.idx0.shape) == (1, 7)
    assert int(s.topology.chains.anchor[0]) == 0 and s.topology.position.idx.tolist()[0] == 0


def test_port_and_its_scripts_import_no_jax():
    """Every module of pies_tpu_torch, chip_smoke.py and the profiler
    import neither JAX nor the JAX package."""
    code = (
        "import pkgutil, sys, importlib, pies_tpu_torch; "
        "[importlib.import_module(m.name) for m in "
        "pkgutil.walk_packages(pies_tpu_torch.__path__, 'pies_tpu_torch.')]; "
        "import chip_smoke; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'pies_tpu' or m.startswith('pies_tpu.')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)
