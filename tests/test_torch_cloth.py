"""The generic PD path's other constraint families (distance, bend, shape and
goal matching, unfused tets) against the JAX package, driven through both
packages' ``Solver`` on the CPU.  The JAX package runs with
``dense_operator_max=0`` so that both take Jacobi-PCG (at these sizes it
would otherwise prefactor the system, a different algorithm).

Checked per scene: the builders' arrays and the topology exactly equal; the
force and the operator on one deformed state; one tick; a run of ticks with
the floor-active counts, the CG trip counts and the failure latch equal on
the way.

Tolerances and why.  The force within 1e-5 and the operator within 2e-6 of
their largest entry (the port adds the distance term from an operator
assembled in float64 where the JAX package scatters it per constraint, and
sums the static terms in another order).  One tick within 1e-5 absolute,
the shape-matching sheet apart.  Over a run the trajectory follows every
float32 rounding, because a 16-trip Jacobi-PCG stops far from convergence;
each scene is held to 3× the JAX package's own float32 spread on it,
measured against a float64 run of the port's twins (same ticks):

    scene (ticks)              JAX − f64   port − f64   port − JAX   bound
    create_sheet (40)           3.5e-5      3.6e-5       1.9e-5      1.1e-4
    create_bend_sheet (40)      8.6e-5      9.4e-5       3.4e-5      2.6e-4
    create_box (40)             1.6e-5      8.6e-6       1.0e-5      4.8e-5
    shape-matching box (40)     3.3e-6      3.6e-6       3.6e-6      1.0e-5
    shape-matching sheet (20)   6.4e-4      1.1e-4       6.3e-4      1.9e-3
    strain-only tet box (40)    3.9e-5      3.3e-5       1.9e-5      1.2e-4
    rigged cloth 32 × 32 (40)   1.5e-5      1.8e-5       2.1e-5      4.5e-5

The shape-matching sheet's groups are planar: their moment matrix is
singular (``pinv``), the rotation about the in-plane axes is found from
roundoff, and the JAX package itself parts from float64 by 6.3e-5 in one
tick (the port by 8.7e-6), so its one-tick bound is 2e-4.

The shape-matching bodies have no triangles and so never touch the floor
(the floor acts on triangle corners): their floor counts are 0 in both.

CG trips per tick (16-trip cap, ``cg_rtol`` 1e-4): equal in both packages
on every tick but the first, where the state is at exact rest, the residual
is roundoff and so is the trip count (e.g. 20 against 12 on the rigged
cloth); measured over these runs one more tick differs, by one trip
(``create_box``, tick 3: 36 against 35), which the test allows.  With only
diagonal terms (the shape-matching scenes) Jacobi is exact and both leave
every solve after at most one trip.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pies_tpu
from pies_tpu.collision.batches import empty_collision_set
from pies_tpu.options import SolverName as JName, SolverOptions as JOptions
from pies_tpu.solver import assembly as jasm
import pies_tpu_torch as pt
from pies_tpu_torch import convert
from pies_tpu_torch.scene.rigged_cloth import add_rigged_cloth, fixed_region_matrix
from pies_tpu_torch.solver import assembly as tasm
from pies_tpu_torch.solver import pd as tpd
from pies_tpu_torch.solver import step as tstep
from pies_tpu_torch.topology import row_layout

from torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)

CLOTH_N = 32


def _strain_only_box(s):
    """``create_tet_box`` with the volume constraints taken out: strain and
    volume no longer cover the same tets, so the tets are unfused."""
    s.create_tet_box((0, 0.6, 0), 1.0, (0, 0, 0), 1500.0, 1.0)
    b = s._builder
    for lst in (b.volume_idx, b.volume_w, b.volume_lo, b.volume_hi):
        lst.clear()
    s._dirty = True


# name -> (builder, ticks, one-tick bound, run bound)
SCENES = {
    "sheet": (lambda s: s.create_sheet((0, 0.3, 0), 0.5, 1.0, 5000.0), 40, 1e-5, 1.1e-4),
    "bend_sheet": (lambda s: s.create_bend_sheet((0, 0.3, 0), 0.5, 5000.0), 40, 1e-5, 2.6e-4),
    "box": (lambda s: s.create_box((0, 0.3, 0), 0.5, 3000.0), 40, 1e-5, 4.8e-5),
    "shape_box": (lambda s: s.create_shape_matching_box(
        (0, 1.0, 0), 4, 4, 4, 1.0, (0.5, 0, 0.2), 4000.0), 40, 1e-5, 1.0e-5),
    "shape_sheet": (lambda s: s.create_shape_matching_sheet(
        (0, 1.0, 0), 0.3, (0, 0, 0.5), 2000.0), 20, 2e-4, 1.9e-3),
    "strain_only_box": (_strain_only_box, 40, 1e-5, 1.2e-4),
    "rigged_cloth": (lambda s: add_rigged_cloth(s, CLOTH_N), 40, 1e-5, 4.5e-5),
}


def _pair(name, **kw):
    j = pies_tpu.Solver(JOptions(solver=JName.PD), enable_collisions=False,
                        dense_operator_max=0, seed=5, **kw)
    t = pt.Solver(pt.SolverOptions(), enable_collisions=False, device="cpu", seed=5, **kw)
    for s in (j, t):
        SCENES[name][0](s)
    return j, t


def _same(a, b, what):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for k, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{k}]")
    elif isinstance(a, (int, float)):
        assert a == b, what
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, what)


BUILDER_LISTS = ("positions", "velocities", "inv_mass", "radius", "base_color", "roughness",
                 "metallic", "dist_idx", "dist_w", "pos_idx", "pos_w", "strain_idx",
                 "strain_w", "strain_lo", "strain_hi", "volume_idx", "volume_w", "bend_idx",
                 "bend_w", "shape_groups", "goal_groups", "fixed_regions", "triangles",
                 "tri_bodies", "tets", "lines")
BATCH_FIELDS = {
    "distance": ("idx", "rest", "w"), "position": ("idx", "target", "w"),
    "strain": ("idx", "qinv", "g", "lo", "hi", "w"),
    "volume": ("idx", "qinv", "g", "lo", "hi", "w"), "bend": ("idx", "rest_angle", "w"),
    "shape": ("node_idx", "group_idx", "mat_coords", "member_mask", "w", "group_mask",
              "inv_count", "qinv", "transforms"),
    "goal": ("node_idx", "group_idx", "mat_coords", "member_mask", "w", "group_mask",
             "inv_count", "qinv", "transforms"),
}


@pytest.mark.parametrize("name", list(SCENES))
def test_builders_and_topology_equal_reference(name):
    j, t = _pair(name)
    for f in BUILDER_LISTS:
        _same(getattr(j._builder, f), getattr(t._builder, f), f)
    j._prepare()
    jt, tt = j._topology, t.topology
    for batch, fields in BATCH_FIELDS.items():
        for f in fields:
            _same(getattr(getattr(jt, batch), f), getattr(getattr(tt, batch), f).numpy(),
                  f"{batch}.{f}")
    for f in ("stiffness_diag", "floor_count", "position_force_dense", "triangles", "tri_mask"):
        _same(getattr(jt, f), getattr(tt, f).numpy(), f)
    assert (jt.tet_block6 is None) == (tt.tet_block6 is None)
    if jt.tet_block6 is not None:
        _same(jt.tet_block6, tt.tet_block6.numpy(), "tet_block6")
    _same(j._state.shape_quats, t.state.shape_quats.numpy(), "shape_quats")
    assert j._config.tet_fused == t.config.tet_fused == tt.tet_fused
    assert j._config.rotation_iterations == t.config.rotation_iterations == 20
    # The row incidence lists every force row once, each node's ascending.
    rows = sum(r for _, r in row_layout(tt).values())
    inc = tt.row_inc
    assert int(inc.row_start[-1]) == rows == inc.entries.shape[0]
    np.testing.assert_array_equal(np.sort(inc.entries.numpy()), np.arange(rows))
    starts = inc.row_start.numpy()
    gaps = np.diff(inc.entries.numpy().astype(np.int64))
    inner = np.ones(max(rows - 1, 0), bool)
    inner[starts[1:-1][(starts[1:-1] > 0) & (starts[1:-1] < rows)] - 1] = False
    assert np.all(gaps[inner] > 0)


def test_empty_regions_survive_and_small_linked_regions_drop():
    j, t = _pair("sheet")
    far = np.eye(4, dtype=np.float32)
    far[:3, 3] = 100.0  # a region that holds no node
    two = np.diag([0.3, 1.0, 0.01, 1.0]).astype(np.float32)
    two[:3, 3] = (0.25, 0.3, 0.0)  # nodes (0, 0) and (1, 0) only
    near = np.diag([1.2, 1.0, 1.2, 1.0]).astype(np.float32)
    near[:3, 3] = (1.0, 0.3, 1.0)
    for s in (j, t):
        s.add_fixed_regions([far, near], 2000.0)
        s.add_linked_regions([far, two, near], 1500.0)
    assert [g[0].shape[0] for g in t._builder.goal_groups] == [0, 25]
    assert [g[0].shape[0] for g in t._builder.shape_groups] == [25]
    j._prepare()
    tt = t.topology
    np.testing.assert_array_equal(tt.goal.member_start.numpy(), [0, 0, 25])
    moved = near.copy()
    moved[1, 3] += 0.2
    for s in (j, t):
        s.update_fixed_regions([far, moved])
        s.tick()
    _same(j._topology.goal.transforms, t.topology.goal.transforms.numpy(), "transforms")
    n = t._builder.num_nodes
    assert np.abs(np.asarray(j._state.positions)[:n] - t.state.positions[:n].numpy()).max() <= 1e-5
    with pytest.raises(ValueError, match="expected 2 region matrices"):
        t.update_fixed_regions([far])


def _deformed(j, seed):
    """A seeded deformed state with some nodes under the floor threshold,
    and the per-node arrays both packages' functions take."""
    st, params = j._state, j.current_params()
    rng = np.random.default_rng(seed)
    x = np.array(st.positions)
    live = np.asarray(st.node_mask) > 0
    x[live] += (0.04 * rng.standard_normal((int(live.sum()), 3))).astype(np.float32)
    x[live, 1] -= np.float32(x[live, 1].min() + 0.02)
    h = np.float32(np.asarray(params.dt))
    moh2 = np.asarray(st.mass) / (h * h)
    fc = np.asarray(j._topology.floor_count)
    thr = np.float32(np.asarray(params.floor_height)) + np.float32(
        np.asarray(params.collision_thickness))
    active = ((x[:, 1] < thr) & (fc > 0)).astype(np.float32)
    wf = np.float32(1.0e4) * fc * active
    return dict(x=x, msn=x * moh2[:, None], moh2=moh2, active=active, wf=wf, h2=float(h * h))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", list(SCENES))
def test_force_and_operator_match_reference(name):
    j, t = _pair(name)
    j._prepare()
    d = _deformed(j, seed=3)
    jt, st, params, cfg = j._topology, j._state, j.current_params(), j._config
    colls = dataclasses.replace(empty_collision_set(pt_cap=0, static_cap=0),
                                floor_active=jnp.asarray(d["active"]))
    x = jnp.asarray(d["x"])
    local = jasm.local_step(x, st.inv_mass, st.mass, st.shape_quats, jt, colls,
                            params.collision_thickness, params.floor_height,
                            cfg.rotation_iterations, cfg.reference_quirks,
                            cfg.strain_contiguous, cfg.volume_contiguous, radius=st.radius,
                            pt_full=False, tet_fused=cfg.tet_fused)
    ref_f = np.asarray(jasm.assemble_force(
        jnp.asarray(d["msn"]), local, jt, colls, cfg.strain_contiguous, cfg.volume_contiguous,
        contact_coupling="recentered", x=x, pt_diag=None, tet_fused=cfg.tet_fused))
    tt, ts = t.topology, t.state
    quats = ts.shape_quats.clone()
    rows = tasm.local_step(_t(d["x"]), ts.inv_mass, ts.mass, quats, tt,
                           t.config.rotation_iterations)
    force, static = tasm.assemble_force(_t(d["x"]), _t(d["msn"]), _t(d["wf"]), rows, tt, 0.0)
    np.testing.assert_array_equal(static.numpy(), np.asarray(local.static))
    assert np.abs(force.numpy() - ref_f).max() <= 1e-5 * np.abs(ref_f).max()
    # Planar groups leave the turn about the in-plane axes to roundoff.
    assert np.abs(quats.numpy() - np.asarray(local.quats)).max() <= (
        5e-5 if name == "shape_sheet" else 1e-5)

    ref_y = np.asarray(jasm.apply_system(
        x, jnp.asarray(d["moh2"]), jt, colls, cfg.strain_contiguous, cfg.volume_contiguous,
        static_diag=jnp.asarray(d["wf"]), contact_coupling="recentered",
        tet_shared=cfg.tet_fused))
    y, _ = tasm.apply_system(_t(d["x"]), ts.mass, _t(d["wf"]), d["h2"], tt)
    assert np.abs(y.numpy() - ref_y).max() <= 2e-6 * np.abs(ref_y).max()
    if name in ("sheet", "rigged_cloth") or d["active"].sum():
        assert 0 < d["active"].sum()


def _count_jax_applies(monkeypatch):
    """Count the JAX package's operator applications through a callback in
    ``apply_system`` (one before each CG loop, one per trip)."""
    calls = []
    real = jasm.apply_system

    def counted(*args, **kwargs):
        jax.debug.callback(lambda: calls.append(1))
        return real(*args, **kwargs)

    monkeypatch.setattr(jasm, "apply_system", counted)
    # A tick traced earlier in this process for the same configuration and
    # shapes (another test file's vmapped tick of the same cloth) would be
    # reused without the callback: trace afresh.
    jax.clear_caches()
    return calls


def _jax_floor_active(j):
    s, p = j._state, j.current_params()
    x = np.asarray(s.positions + p.dt * s.velocities * s.node_mask[:, None])
    thr = np.float32(np.asarray(p.floor_height)) + np.float32(np.asarray(p.collision_thickness))
    return int(((x[:, 1] < thr) & (np.asarray(j._topology.floor_count) > 0)).sum())


@pytest.mark.parametrize("name", list(SCENES))
def test_ticks_match_reference(name, monkeypatch):
    _, ticks, tol1, tol = SCENES[name]
    calls = _count_jax_applies(monkeypatch)
    j, t = _pair(name)
    j._prepare()
    n = t._builder.num_nodes
    worst, floor, ref_floor, trips, ref_trips = 0.0, [], [], [], []
    for k in range(ticks):
        if name == "rigged_cloth" and k == ticks // 2:
            for s in (j, t):
                s.update_fixed_regions([fixed_region_matrix(CLOTH_N, 0.1, 0.3, 0.05)])
        ref_floor.append(_jax_floor_active(j))
        t.counters = tpd.new_counters("cpu")
        before = len(calls)
        j.tick()
        t.tick()
        np.asarray(j._state.positions)  # wait for the tick and its callbacks
        jax.effects_barrier()
        ref_trips.append(len(calls) - before - 4)  # 4 solves, one apply before each loop
        floor.append(int(t.counters["floor_active"]))
        trips.append(int(t.counters["cg_trips"]))
        assert t.sim_failed == j.sim_failed, k
        err = np.abs(np.asarray(j._state.positions)[:n] - t.state.positions[:n].numpy()).max()
        if k == 0:
            assert err <= tol1
        worst = max(worst, err)
    assert not t.sim_failed
    assert worst <= tol
    assert floor == ref_floor
    assert sum(trips) > 0
    if name in ("shape_box", "shape_sheet"):
        # Only diagonal terms: Jacobi is exact, so every solve leaves after
        # at most one trip in both packages (none where r = 0 exactly).
        assert max(trips) <= 4 and max(ref_trips) <= 4 and sum(floor) == 0
    else:
        # Tick 0 starts at exact rest, where the CG iterates on roundoff.
        assert sum(abs(a - b) for a, b in zip(trips[1:], ref_trips[1:])) <= 1
        assert sum(floor) > 0
    if name == "rigged_cloth":
        moved = t.topology.goal.transforms[0].numpy()
        assert not np.array_equal(moved, np.eye(4, dtype=np.float32))
        np.testing.assert_array_equal(moved, np.asarray(j._topology.goal.transforms[0]))
    q = np.asarray(j._state.shape_quats)
    assert np.abs(t.state.shape_quats.numpy() - q).max() <= 1e-3


def test_rotation_iterations_take_effect():
    runs = []
    for iters in (1, 20):
        t = pt.Solver(pt.SolverOptions(), enable_collisions=False, device="cpu",
                      rotation_iterations=iters)
        t.create_shape_matching_box((0, 1.0, 0), 3, 3, 3, 1.0, (0, 0, 0), 4000.0)
        t.state.velocities[:27, 0] = 3.0 * (t.state.positions[:27, 1] - 1.5)  # a spin
        t.run_ticks(5)
        assert t.config.rotation_iterations == iters
        runs.append(t.state.shape_quats.clone())
    assert not torch.equal(runs[0], runs[1])


def test_shape_rotations_survive_a_scene_addition():
    t = pt.Solver(pt.SolverOptions(), enable_collisions=False, device="cpu")
    t.create_shape_matching_box((0, 1.0, 0), 3, 3, 3, 1.0, (0, 0, 0), 4000.0)
    t.state.velocities[:27, 0] = 3.0 * (t.state.positions[:27, 1] - 1.5)
    t.run_ticks(5)
    turned = t.state.shape_quats.clone()
    assert not torch.equal(turned[0], torch.tensor([1.0, 0.0, 0.0, 0.0]))
    t.create_shape_matching_box((5, 1.0, 0), 3, 3, 3, 1.0, (0, 0, 0), 4000.0)
    assert torch.equal(t.state.shape_quats[0], turned[0])
    assert torch.equal(t.state.shape_quats[1], torch.tensor([1.0, 0.0, 0.0, 0.0]))


def test_converter_carries_a_cloth_run_across():
    """Five JAX ticks of the rigged cloth with its fixed region turned,
    carried across with convert.py (rotations, goal transforms and batches
    included), then one more tick in each package."""
    j, _ = _pair("rigged_cloth")
    j.update_fixed_regions([fixed_region_matrix(CLOTH_N, 0.1, 0.3, 0.05)])
    for _ in range(5):
        j.tick()
    st = convert.state_from_numpy(jax.tree.map(np.asarray, j._state))
    topo = convert.topology_from_numpy(jax.tree.map(np.asarray, j._topology),
                                       tet_fused=j._config.tet_fused)
    cfg = convert.config_from(j._config)
    params = convert.params_from(jax.tree.map(np.asarray, j.current_params()))
    np.testing.assert_array_equal(topo.goal.transforms.numpy(),
                                  np.asarray(j._topology.goal.transforms))
    assert cfg.rotation_iterations == 20
    tstep.tick(st, topo, params, cfg)
    j.tick()
    np.testing.assert_allclose(st.positions.numpy(), np.asarray(j._state.positions),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(st.shape_quats.numpy(), np.asarray(j._state.shape_quats),
                               atol=1e-5, rtol=0)
