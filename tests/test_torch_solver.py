"""The whole ported slice against the JAX package: the PD tet-soup tick with
floor contact, driven through both packages' ``Solver``.

Tolerances and why:

* one tick, 1e-5 absolute: the per-step parity (measured 3e-6, a few
  float32 ulps at |x| ≈ 7);
* 40 ticks, 2.5e-3 absolute.  On this scene the float32 roundoff of the
  large right-hand side (~4e4, from M/h² ≈ 7e3 times positions up to 7)
  drifts the free-falling tets by a near-constant amount each tick, so any
  two float32 evaluation orders part quadratically in time.  Measured on
  this 96-tet soup over 40 ticks: the JAX package's own tet-column and
  generic paths differ by 2.0e-3, each package differs from a float64 run
  of the port by 1.3e-3, and the port differs from the JAX package by
  1.95e-3 (1.86e-3 with pins).  2.5e-3 is the reference's own spread with
  some headroom; it is not reachable from a tighter per-step agreement.
* self-contact, 30 ticks of the 96-tet soup at spacing 1.0 (contacts live
  from tick 0), 1e-3 absolute, with the contact counts and the latch equal
  on every tick.  Measured: the JAX package's tet-column path and its
  generic PCG path (64 CG iterations) part by 5.8e-4; the port parts from
  the tet-column path by 7.5e-4 and from the generic path by 4.8e-4.
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
from pies_tpu.collision.batches import empty_collision_set
from pies_tpu.collision.broadphase import detect_point_tri_collisions as jdetect
from pies_tpu.options import SolverName as JName, SolverOptions as JOptions
from pies_tpu.solver import tetcols as jcols
import pies_tpu_torch as pt
from pies_tpu_torch import convert
from pies_tpu_torch.solver import pd as tpd
from pies_tpu_torch.solver import step as tstep

from torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)

N_TETS, TICKS = 96, 40
STEP_TOL, TRAJ_TOL = 1e-5, 2.5e-3
SCENE = dict(spacing=1.6, scale=0.8, w=2000.0, height=0.5, jitter=0.05)
CONTACT_SCENE = dict(SCENE, spacing=1.0)
CONTACT_TICKS, CONTACT_TOL = 30, 1e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pin(s, pins):
    if pins:
        s._builder.pos_idx.append(np.asarray(pins, np.int32))
        s._builder.pos_w.append(np.full(len(pins), 8000.0, np.float32))
        s._dirty = True


def _jax_solver(pins=None, n=N_TETS):
    s = pies_tpu.Solver(JOptions(solver=JName.PD), enable_collisions=False,
                        dense_operator_max=0)
    s.create_tet_soup(n, **SCENE)
    _pin(s, pins)
    s._prepare()
    colls = dataclasses.replace(
        empty_collision_set(pt_cap=0, static_cap=0),
        floor_active=jax.numpy.zeros(s._state.capacity),
    )
    assert jcols.applies(s._state, s._topology, colls, s._config, None)
    return s


def _port_solver(pins=None, n=N_TETS, device="cpu"):
    s = pt.Solver(pt.SolverOptions(solver=pt.SolverName.PD), enable_collisions=False,
                  device=device)
    s.create_tet_soup(n, **SCENE)
    _pin(s, pins)
    return s


def _run(s, ticks, live):
    traj, failed = [], []
    for _ in range(ticks):
        s.tick()
        traj.append(np.array(s.get_vertices()["position"][:live]))
        failed.append(s.sim_failed)
    return np.stack(traj), failed


@pytest.mark.parametrize("pins", [None, [0, 5]], ids=["soup", "pinned_soup"])
def test_slice_matches_reference(pins):
    live = 4 * N_TETS
    ref, ref_failed = _run(_jax_solver(pins), TICKS, live)
    port, port_failed = _run(_port_solver(pins), TICKS, live)
    assert port_failed == ref_failed and not any(port_failed)
    assert np.abs(port[0] - ref[0]).max() <= STEP_TOL
    assert np.abs(port - ref).max() <= TRAJ_TOL
    assert np.isfinite(port).all()
    assert port[:, :, 1].min() < 0.05  # the floor was reached
    if pins:  # the pins held
        start = _port_solver(pins).state.positions[[0, 5]].numpy()
        np.testing.assert_allclose(port[-1, [0, 5]], start, atol=0.05)


def test_same_seed_same_scene():
    j, t = _jax_solver(), _port_solver()
    np.testing.assert_array_equal(t.state.positions.numpy(), np.asarray(j._state.positions))
    for key in ("base_color", "roughness", "metallic"):
        np.testing.assert_array_equal(t.get_vertices()[key], j.get_vertices()[key])


def test_converter_carries_a_reference_run_across():
    """Ten JAX ticks, carried across with convert.py, then one more tick in
    each package: positions agree to the per-step tolerance, velocities
    (a position difference over h = 0.012) to that over h, and the gravity
    forces exactly."""
    j = _jax_solver([0, 5])
    for _ in range(10):
        j.tick()
    st = convert.state_from_numpy(jax.tree.map(np.asarray, j._state))
    topo = convert.topology_from_numpy(jax.tree.map(np.asarray, j._topology))
    cfg = convert.config_from(j._config)
    params = convert.params_from(jax.tree.map(np.asarray, j.current_params()))
    tstep.tick(st, topo, params, cfg)
    j.tick()
    for f, tol in (("positions", STEP_TOL), ("velocities", STEP_TOL / 0.012), ("forces", 0)):
        np.testing.assert_allclose(
            getattr(st, f).numpy(), np.asarray(getattr(j._state, f)), atol=tol, rtol=0,
            err_msg=f,
        )


def test_failure_latch_matches_reference():
    """A non-finite position latches sim_failed on the same tick in both
    packages, and every later tick leaves the state unchanged."""
    j, t = _jax_solver(n=24), _port_solver(n=24)
    t._prepare()
    j._state = dataclasses.replace(
        j._state, velocities=j._state.velocities.at[7, 0].set(np.inf)
    )
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


def test_run_ticks_equals_ticks():
    a, b = _port_solver(n=24), _port_solver(n=24)
    a.run_ticks(5)
    for _ in range(5):
        b.tick()
    assert torch.equal(a.state.positions, b.state.positions)
    assert a.ticks == b.ticks == 5


def _contact_solvers(n=N_TETS, scene=CONTACT_SCENE, **kw):
    j = pies_tpu.Solver(JOptions(solver=JName.PD), enable_collisions=True,
                        dense_operator_max=0, **kw)
    t = pt.Solver(pt.SolverOptions(solver=pt.SolverName.PD), enable_collisions=True,
                  device="cpu", **kw)
    for s in (j, t):
        s.create_tet_soup(n, **scene)
        s._prepare()
    return j, t


_jdetect = jax.jit(jdetect, static_argnames=("config",))


def _jax_contacts(j):
    """The contact count the JAX package's next tick detects (the same
    deterministic detection on the same inputs)."""
    s, params = j._state, j.current_params()
    x = s.positions + params.dt * s.velocities * s.node_mask[:, None]
    _, pt_mask, _, _ = _jdetect(x, s.prev_positions, j._topology.triangles,
                                j._topology.tri_mask, params, config=j._config, cache=s.bp)
    return int(np.asarray(pt_mask).sum())


def test_self_contact_slice_matches_reference():
    j, t = _contact_solvers()
    cfg = j._config
    # The JAX run is on the tet-column path and the packed-body detection.
    colls = dataclasses.replace(
        empty_collision_set(pt_cap=cfg.budget.max_point_tri_contacts, static_cap=0),
        floor_active=jax.numpy.zeros(j._state.capacity))
    assert jcols.applies(j._state, j._topology, colls, cfg, None)
    assert cfg.budget.body_stride == 4 and cfg.body_nodes == 4 and j._state.bp is not None
    ref_counts, counts, ref, port = [], [], [], []
    for _ in range(CONTACT_TICKS):
        ref_counts.append(_jax_contacts(j))
        t.counters = tpd.new_counters("cpu")
        j.tick()
        t.tick()
        counts.append(int(t.counters["contacts"]))
        assert t.sim_failed == j.sim_failed
        ref.append(np.asarray(j._state.positions)[: 4 * N_TETS])
        port.append(t.state.positions[: 4 * N_TETS].numpy().copy())
    assert counts == ref_counts and min(counts) > 0
    assert not t.sim_failed
    assert np.abs(np.stack(port) - np.stack(ref)).max() <= CONTACT_TOL


def test_self_contact_latch_matches_reference():
    """One narrow slot per body cannot hold a dense soup's exact AABB
    overlaps: both packages latch sim_failed on the first tick."""
    j, t = _contact_solvers(n=64, scene=dict(CONTACT_SCENE, spacing=0.9),
                            budget_overrides={"max_narrow_bodies": 1})
    for tick in range(2):
        j.tick()
        t.tick()
        assert t.sim_failed == j.sim_failed == True, tick  # noqa: E712


def test_converter_carries_the_broadphase_cache():
    """Ten JAX ticks with self-contact, carried across (the broadphase cache
    included), then one more tick in each package."""
    j, _ = _contact_solvers()
    for _ in range(10):
        j.tick()
    st = convert.state_from_numpy(jax.tree.map(np.asarray, j._state))
    ref_bp = convert.cache_from_numpy(jax.tree.map(np.asarray, j._state.bp))
    for f in ("pairs", "valid", "ref", "fresh"):
        assert torch.equal(getattr(st.bp, f), getattr(ref_bp, f)), f
    topo = convert.topology_from_numpy(jax.tree.map(np.asarray, j._topology))
    cfg = convert.config_from(j._config)
    params = convert.params_from(jax.tree.map(np.asarray, j.current_params()))
    assert cfg.enable_collisions and cfg.body_faces == j._config.body_faces
    tstep.tick(st, topo, params, cfg)
    j.tick()
    np.testing.assert_allclose(st.positions.numpy(), np.asarray(j._state.positions),
                               atol=STEP_TOL, rtol=0)
    for f in ("pairs", "valid", "fresh"):
        ref = convert.cache_from_numpy(jax.tree.map(np.asarray, j._state.bp))
        assert torch.equal(getattr(st.bp, f), getattr(ref, f)), f


def test_self_contact_is_not_ported_yet():
    """Point-triangle self-contact runs on every PD scene (the soup below,
    one body per triangle, takes the all-pairs branch on the tet-column
    path; ``tests/test_torch_tri_detect.py`` holds it to the JAX package);
    so does full contact coupling on ``create_sheet``; and the other contact
    kinds, edge-edge and PD node-node, prepare and tick on the soup
    (``tests/test_torch_edges.py``, ``tests/test_torch_nodes.py`` hold them
    to the JAX package)."""
    s = pt.Solver(pt.SolverOptions(), enable_collisions=True, device="cpu",
                  budget_overrides={"body_stride": 1})
    s.create_tet_soup(8, **SCENE)
    s.tick()
    assert not s.sim_failed and s.config.body_nodes == 0
    for kind in ("enable_edge_collisions", "enable_node_collisions"):
        s = pt.Solver(pt.SolverOptions(), device="cpu", **{kind: True})
        s.create_tet_soup(8, **SCENE)
        s.tick()
        assert not s.sim_failed and getattr(s.config, kind)
    s = pt.Solver(pt.SolverOptions(), enable_collisions=True, contact_coupling="full",
                  device="cpu")
    s.create_sheet((0, 0, 0), 1.0, 1.0, 1.0)
    s.tick()
    assert not s.sim_failed and s.config.contact_coupling == "full"


def test_port_imports_no_jax():
    code = (
        "import sys, pies_tpu_torch, pies_tpu_torch.convert, pies_tpu_torch.diagnostics, "
        "pies_tpu_torch.scene.tetmesh, pies_tpu_torch.native.load; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'pies_tpu' or m.startswith('pies_tpu.')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)
