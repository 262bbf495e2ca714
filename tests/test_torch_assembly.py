"""The generic PD path's modules against the JAX package, on the CPU: the
ELL topology and tet incidence, the mesh reader and ``create_tet_box``, the
gathered tet force with the force assembly (T9's twins), the ELL operator
(T10's twin) and the Jacobi-PCG (T11's twin).

Inputs are the committed 1,331-node / 6,000-tet mesh
(``scripts/refbench/tet_cube_mesh.txt``) with 4 pinned nodes, at a seeded
deformed state lowered onto the floor, built once with numpy and handed to
both packages.  Tolerances and why:

* topology arrays, the reader and the builder: exactly equal (the same host
  code in both packages);
* the gathered tet force and the assembled force: 1e-5 of the largest
  entry; the operator: 1e-6 of the largest entry (XLA on the CPU contracts
  multiply-adds into FMAs, eager PyTorch does not);
* the PCG: 2e-5 absolute on positions of magnitude ~2 after 16 trips
  (measured 7.2e-7), with equal trip counts; with the early exit (``rtol=1e-6``, 32 trips at most,
  on the ``create_tet_box`` scene of ``tests/test_solver.py:411``) the
  same number of trips, below the cap (13 in both).
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pies_tpu
from pies_tpu.collision.batches import empty_collision_set
from pies_tpu.constraints import projections as jproj
from pies_tpu.options import SolverName as JName, SolverOptions as JOptions
from pies_tpu.solver import assembly as jasm
import pies_tpu_torch as pt
from pies_tpu_torch import convert
from pies_tpu_torch.constraints import projections as tproj
from pies_tpu_torch.scene.mesh_dump import add_tet_mesh, load_mesh_txt
from pies_tpu_torch.solver import assembly as tasm

from torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = os.path.join(REPO, "scripts", "refbench", "tet_cube_mesh.txt")
PINS = [0, 10, 110, 120]  # the corners of the mesh's x = 0 face
W_PIN = 8000.0


def _mesh_solvers(pins=True):
    """The JAX package's and the port's solvers on the mesh, prepared."""
    pts, tets, surf = load_mesh_txt(MESH)
    j = pies_tpu.Solver(JOptions(solver=JName.PD), enable_collisions=False,
                        dense_operator_max=0)
    t = pt.Solver(pt.SolverOptions(), enable_collisions=False, device="cpu")
    ids = j._builder._emit_nodes(pts, inv_mass=1.0, radius=0.2)
    j._builder._emit_tets(ids[tets], 1000.0)
    j._builder._emit_triangles(ids[surf])
    if pins:
        j._builder.pos_idx.append(ids[np.asarray(PINS)].astype(np.int32))
        j._builder.pos_w.append(np.full(len(PINS), W_PIN, np.float32))
    add_tet_mesh(t, pts, tets, surf, pins=PINS if pins else (), pin_w=W_PIN)
    j._prepare()
    t._prepare()
    return j, t


@pytest.fixture(scope="module")
def mesh():
    return _mesh_solvers()


def _deformed(j, seed=0):
    """Seeded positions: the mesh lowered so its bottom layer sits at the
    floor threshold, jittered; plus M·x/h², the floor weight and the system
    diagonal as numpy arrays for both packages."""
    st, params = j._state, j.current_params()
    rng = np.random.default_rng(seed)
    x = np.array(st.positions)
    live = np.asarray(st.node_mask) > 0
    x[live] += np.array([0.0, -0.47, 0.0], np.float32)
    x[live] += (0.03 * rng.standard_normal((int(live.sum()), 3))).astype(np.float32)
    h = np.float32(np.asarray(params.dt))
    moh2 = np.asarray(st.mass) / (h * h)
    fc = np.asarray(j._topology.floor_count)
    thr = np.float32(np.asarray(params.floor_height)) + np.float32(
        np.asarray(params.collision_thickness))
    active = ((x[:, 1] < thr) & (fc > 0)).astype(np.float32)
    wf = np.float32(1.0e4) * fc * active
    diag = (moh2 + np.asarray(j._topology.stiffness_diag)) + wf
    return dict(x=x, msn=x * moh2[:, None], moh2=moh2, active=active, wf=wf, diag=diag,
                h2=float(h * h))


def _colls(active):
    return dataclasses.replace(empty_collision_set(pt_cap=0, static_cap=0),
                               floor_active=jnp.asarray(active))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_mesh_reader_matches_reference_reader():
    spec = importlib.util.spec_from_file_location(
        "prof_mesh", os.path.join(REPO, "scripts", "prof_mesh.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    for a, b in zip(load_mesh_txt(MESH), ref.load_mesh_txt(MESH)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pins", [False, True], ids=["free", "pinned"])
def test_mesh_topology_matches_reference(pins):
    j, t = _mesh_solvers(pins)
    jt, tt = j._topology, t.topology
    assert tt.tet_block6 is None and jt.tet_block6 is None
    np.testing.assert_array_equal(tt.ell_nbr.numpy().T, np.asarray(jt.ell_nbr))
    np.testing.assert_array_equal(tt.ell_coef.numpy().T, np.asarray(jt.ell_coef))
    assert tt.ell_nbr.shape[0] == 15
    for f in ("stiffness_diag", "floor_count", "position_force_dense"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)), f)
    assert not j._config.enable_collisions and not t.config.enable_collisions
    assert t.config.tet_fused and j._config.tet_fused
    assert (t.config.cg_iterations, t.config.cg_rtol) == (j._config.cg_iterations,
                                                          j._config.cg_rtol) == (16, 1e-4)


def test_tet_incidence_lists_every_corner_once_in_scatter_order(mesh):
    _, t = mesh
    idx = t.topology.strain.idx.numpy()
    inc = t.topology.row_inc  # tets only: the rows are the strain batch's
    rs, ent = inc.row_start.numpy(), inc.entries.numpy()
    c = idx.shape[0]
    assert rs[0] == 0 and rs[-1] == 4 * c
    np.testing.assert_array_equal(np.sort(ent), np.arange(4 * c))
    scatter = idx.T.reshape(-1)  # node of scatter index k = a*C + t
    for n in range(rs.shape[0] - 1):
        ks = ent[rs[n]:rs[n + 1]]
        assert np.all(scatter[ks] == n) and np.all(np.diff(ks) > 0)
    assert np.diff(rs).max() == 24  # incident tets of a node, at most


def test_converter_carries_the_mesh_topology(mesh):
    j, t = mesh
    topo = convert.topology_from_numpy(jax.tree.map(np.asarray, j._topology))
    mine = t.topology
    for f in ("ell_nbr", "ell_coef", "static_w", "stiffness_diag", "floor_count"):
        assert torch.equal(getattr(topo, f), getattr(mine, f)), f
    for f in ("row_start", "entries"):
        assert torch.equal(getattr(topo.row_inc, f), getattr(mine.row_inc, f)), f
    assert convert.config_from(j._config).cg_rtol == 1e-4


def test_create_tet_box_matches_reference():
    j = pies_tpu.Solver(JOptions(solver=JName.PD), enable_collisions=False,
                        dense_operator_max=0, seed=3)
    t = pt.Solver(pt.SolverOptions(), enable_collisions=False, device="cpu", seed=3)
    for s in (j, t):
        s.create_tet_box((0, 2.0, 0), 1.0, (0.5, 0, 0), w=1500.0, mass=2.0)
        s.create_tet_box((3, 2.0, 0), 0.5, (0, 0, 0), w=900.0, mass=1.0, hinged=True)
    jb, tb = j._builder, t._builder
    for f in ("positions", "velocities", "inv_mass", "radius", "strain_idx", "volume_idx",
              "strain_w", "volume_lo", "triangles", "base_color", "roughness", "metallic"):
        for a, b in zip(getattr(jb, f), getattr(tb, f)):
            np.testing.assert_array_equal(a, b, f)
    j._prepare()
    np.testing.assert_array_equal(t.topology.ell_coef.numpy().T, np.asarray(j._topology.ell_coef))
    np.testing.assert_array_equal(t.state.positions.numpy(), np.asarray(j._state.positions))


def test_gathered_tet_force_and_assembly_match_reference(mesh):
    j, t = mesh
    d = _deformed(j)
    jt, st, params = j._topology, j._state, j.current_params()
    assert 0 < d["active"].sum() < d["active"].size
    assert (d["x"][:, 1] < 0).any()  # the floor projection clamps some nodes
    x = jnp.asarray(d["x"])
    ref12 = np.asarray(jproj.tet_force12_fused(x, jt.strain, jt.volume, False))
    topo = t.topology
    blocks = tproj.tet_force12_gathered(_t(d["x"]), topo.strain, topo.volume)
    c = ref12.shape[0]
    ref_blocks = ref12.reshape(c, 4, 3).transpose(1, 0, 2).reshape(4 * c, 3)
    scale = np.abs(ref_blocks).max()
    assert np.abs(blocks.numpy() - ref_blocks).max() <= 1e-5 * scale

    colls = _colls(d["active"])
    cfg = j._config
    local = jasm.local_step(x, st.inv_mass, st.mass, st.shape_quats, jt, colls,
                            params.collision_thickness, params.floor_height,
                            cfg.rotation_iterations, cfg.reference_quirks, False, False,
                            radius=st.radius, pt_full=False, tet_fused=True)
    ref_f = np.asarray(jasm.assemble_force(jnp.asarray(d["msn"]), local, jt, colls, False,
                                           False, contact_coupling="recentered", x=x,
                                           pt_diag=None, tet_fused=True))
    force, static = tasm.assemble_force(_t(d["x"]), _t(d["msn"]), _t(d["wf"]), blocks, topo,
                                        0.0)
    np.testing.assert_array_equal(static.numpy(), np.asarray(local.static))
    scale = np.abs(ref_f).max()
    assert np.abs(force.numpy() - ref_f).max() <= 1e-5 * scale


def test_ell_operator_matches_reference(mesh):
    j, t = mesh
    d = _deformed(j, seed=1)
    jt = j._topology
    colls = _colls(d["active"])
    ref = np.asarray(jasm.apply_system(jnp.asarray(d["x"]), jnp.asarray(d["moh2"]), jt, colls,
                                       static_diag=jnp.asarray(d["wf"]),
                                       contact_coupling="recentered", tet_shared=True))
    st = t.state
    y, part = tasm.apply_system(_t(d["x"]), st.mass, _t(d["wf"]), d["h2"], t.topology,
                                part=True)
    assert np.abs(y.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
    # The partials sum x·y in the kernels' block order.
    dot = float(np.sum(d["x"].astype(np.float64) * y.numpy().astype(np.float64)))
    assert part.shape[0] == -(-st.capacity // 256)
    assert abs(float(tasm.finalize(part)) - dot) <= 1e-6 * abs(dot)


def _jax_pcg_trips(j, b, x0, diag, colls, moh2, wf, iterations, rtol):
    """JAX ``pcg_solve`` on the ELL operator; returns ``(x, residual,
    trips)`` with the trips counted by a callback in the operator (one
    apply before the loop, one per trip)."""
    calls = []

    def matvec(v):
        jax.debug.callback(lambda: calls.append(1))
        return jasm.apply_system(v, jnp.asarray(moh2), j._topology, colls,
                                 static_diag=jnp.asarray(wf), contact_coupling="recentered",
                                 tet_shared=True)

    x, res = jasm.pcg_solve(matvec, jnp.asarray(b), jnp.asarray(x0), jnp.asarray(diag),
                            iterations, rtol=rtol)
    jax.effects_barrier()
    return np.asarray(x), float(res), len(calls) - 1


def _port_pcg(t, b, x0, diag, wf, h2, iterations, rtol):
    x, prr, trips = tasm.pcg_solve(_t(b), _t(x0), _t(diag), t.state.mass, _t(wf), h2,
                                   t.state.node_mask, t.topology, iterations, rtol)
    return x.numpy(), float(torch.sqrt(torch.sum(prr))), int(trips[0])


def test_pcg_matches_reference_fixed_trips(mesh):
    j, t = mesh
    d = _deformed(j, seed=2)
    colls = _colls(d["active"])
    b, _ = tasm.apply_system(_t(d["x"]), t.state.mass, _t(d["wf"]), d["h2"], t.topology)
    n = t._builder.num_nodes
    b = b.numpy()
    b[:n] += np.float32(50.0)  # a right side far from the warm start's
    x0 = np.array(j._state.positions)
    ref_x, ref_res, ref_trips = _jax_pcg_trips(j, b, x0, d["diag"], colls, d["moh2"], d["wf"],
                                               16, 0.0)
    x, res, trips = _port_pcg(t, b, x0, d["diag"], d["wf"], d["h2"], 16, 0.0)
    assert trips == ref_trips == 16
    assert np.abs(x[:n] - ref_x[:n]).max() <= 2e-5
    assert abs(res - ref_res) <= 1e-3 * ref_res
    # The padding keeps its park positions (the mask re-select of pd.py:195,
    # which the port's solve includes).
    np.testing.assert_array_equal(x[n:], x0[n:])


def test_pcg_early_exit_matches_reference():
    """The early exit fires on the tet box of tests/test_solver.py:411: the
    same trip count below the cap of 32, on a mid-fall state."""
    kw = dict(enable_collisions=False, cg_iterations=32, cg_rtol=1e-6)
    j = pies_tpu.Solver(JOptions(solver=JName.PD), dense_operator_max=0, **kw)
    t = pt.Solver(pt.SolverOptions(), device="cpu", **kw)
    for s in (j, t):
        s.create_tet_box((0, 2.0, 0), 1.0, (0, 0, 0), w=1500.0, mass=1.0)
    for _ in range(5):
        j.tick()
    st = convert.state_from_numpy(jax.tree.map(np.asarray, j._state))
    t._prepare()
    t._state = st
    d = _deformed(j, seed=3)
    colls = _colls(d["active"])
    x0 = np.array(j._state.positions)
    b, _ = tasm.apply_system(_t(d["x"]), st.mass, _t(d["wf"]), d["h2"], t.topology)
    b = b.numpy()
    ref_x, _, ref_trips = _jax_pcg_trips(j, b, x0, d["diag"], colls, d["moh2"], d["wf"], 32,
                                         1e-6)
    x, _, trips = _port_pcg(t, b, x0, d["diag"], d["wf"], d["h2"], 32, 1e-6)
    assert 0 < trips == ref_trips < 32
    n = t._builder.num_nodes
    assert np.abs(x[:n] - ref_x[:n]).max() <= 2e-5


def test_pcg_takes_no_trip_at_rest(mesh):
    """When the warm start solves the system exactly (r = 0, so rz0 = 0),
    both packages stop before the first trip and return the warm start."""
    j, t = mesh
    d = _deformed(j, seed=4)
    colls = _colls(d["active"])
    x0 = d["x"]
    ref_b = np.asarray(jasm.apply_system(jnp.asarray(x0), jnp.asarray(d["moh2"]), j._topology,
                                         colls, static_diag=jnp.asarray(d["wf"]),
                                         contact_coupling="recentered", tet_shared=True))
    b, _ = tasm.apply_system(_t(x0), t.state.mass, _t(d["wf"]), d["h2"], t.topology)
    ref_x, ref_res, ref_trips = _jax_pcg_trips(j, ref_b, x0, d["diag"], colls, d["moh2"],
                                               d["wf"], 16, 1e-4)
    x, res, trips = _port_pcg(t, b.numpy(), x0, d["diag"], d["wf"], d["h2"], 16, 1e-4)
    assert trips == ref_trips == 0
    assert res == ref_res == 0.0
    np.testing.assert_array_equal(x, x0)
    np.testing.assert_array_equal(ref_x, x0)


def test_reductions_follow_the_kernel_order():
    """block_partials/finalize are the kernels' trees: on values whose sum
    is order-sensitive they equal a direct transcription of the two
    passes."""
    rng = np.random.default_rng(5)
    v = (rng.standard_normal(1000) * 10.0 ** rng.integers(-4, 5, 1000)).astype(np.float32)
    part = tasm.block_partials(torch.from_numpy(v)).numpy()
    want = []
    for blk in range(4):
        sm = np.zeros(256, np.float32)
        seg = v[256 * blk:256 * (blk + 1)]
        sm[: seg.shape[0]] = seg
        s = 128
        while s:
            sm[:s] = sm[:s] + sm[s:2 * s]
            s //= 2
        want.append(sm[0])
    np.testing.assert_array_equal(part, np.asarray(want, np.float32))
    acc = np.zeros(256, np.float32)
    acc[:4] = part
    s = 128
    while s:
        acc[:s] = acc[:s] + acc[s:2 * s]
        s //= 2
    assert float(tasm.finalize(torch.from_numpy(part))) == float(acc[0])
