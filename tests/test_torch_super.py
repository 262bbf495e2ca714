"""The port's super-body detection, banded tet operator and generic-path
contact terms against the JAX package, on the CPU (the plain twins of
kernels T14 and T15, and of the extended T7, T9 and T10).

Scenes, all with ``allpairs_broadphase_max=0`` so that the small sizes take
the super-body path (as ``tests/test_collisions.py:746-747,873-874`` do):

* ``mixed``: 40 tets and an 8 × 8 sheet at y = 2.2 (``test_collisions.py:
  740-771``): 40 packed rows of 4 corners, 98 loose rows, five face slots;
* ``cloth``: the 10 × 10 pure-loose sheet of ``test_collisions.py:868-894``;
* ``mesh``: the imported 1,331-node mesh, 1,200 loose rows.

Tolerances and why:

* layout, corner and adjacency tables, budgets, cache shapes, the seven
  band diagonals: equal (host arithmetic on the same arrays);
* detection on identical states sampled along a 40-tick JAX run: the cache
  (pairs under the valid mask, valid, fresh, ref), the overflow latch and
  the contact list equal, with and without the cache (integer and
  comparison work on the same float32 inputs; measured 0 differences);
* the band operator against ``apply_system``: 2e-6 of the largest entry
  (measured 6.5e-8: the distance Laplacian is coalesced in float64 on the
  host, the JAX package scatters it per constraint);
* the contact diagonal against ``point_tri_collision_diag``, the operator's
  dense diagonal and the Jacobi diagonal: equal (sums of small integers
  times 1e4, added in the JAX order);
* the force with contact terms against ``assemble_force``: 1e-6 of the
  largest entry (measured 2.1e-8: the sums differ only in where the rows
  are added).
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pies_tpu
from pies_tpu.collision.batches import empty_collision_set
from pies_tpu.collision.broadphase import detect_point_tri_collisions as jdetect
from pies_tpu.options import SolverName as JName, SolverOptions as JOptions
from pies_tpu.solver import assembly as jasm
from pies_tpu.solver.host import _detect_super_layout as jlayout
import pies_tpu_torch as pt
from pies_tpu_torch import convert
from pies_tpu_torch.collision import broadphase as tb
from pies_tpu_torch.collision.batches import CollisionSet
from pies_tpu_torch.scene.mixed_drape import add_mixed_drape
from pies_tpu_torch.solver import assembly as tasm
from pies_tpu_torch.solver import host as thost
from pies_tpu_torch.solver import pd as tpd
from pies_tpu_torch.solver import tetcols as ttetcols

from test_torch_generic import _mesh
from torch_threads import two_threads  # noqa: F401  (autouse: two torch threads)


SCENES = ("mixed", "cloth", "mesh")
SUPER_FIELDS = ("super_k", "super_packed_k", "super_packed_m", "super_packed_off",
                "super_live_k", "super_faces", "super_packed_e", "super_loose_face")


def _cloth(s, n=10):
    """The pure-loose sheet of tests/test_collisions.py:868-894."""
    sx = np.linspace(0.0, 4.0, n, dtype=np.float32)
    gx, gz = np.meshgrid(sx, sx, indexing="ij")
    pts = np.stack([gx, np.full_like(gx, 1.0), gz], -1).reshape(-1, 3)
    ids = s._builder._emit_nodes(pts, inv_mass=1.0, radius=0.2)
    g = ids.reshape(n, n)
    pairs = np.concatenate([
        np.stack([g[:-1, :].ravel(), g[1:, :].ravel()], 1),
        np.stack([g[:, :-1].ravel(), g[:, 1:].ravel()], 1),
        np.stack([g[:-1, :-1].ravel(), g[1:, 1:].ravel()], 1),
    ])
    s._builder._emit_distance(pairs, 4000.0)
    tris = np.concatenate([
        np.stack([g[:-1, :-1].ravel(), g[1:, :-1].ravel(), g[1:, 1:].ravel()], 1),
        np.stack([g[:-1, :-1].ravel(), g[1:, 1:].ravel(), g[:-1, 1:].ravel()], 1),
    ])
    s._builder._emit_triangles(tris)
    s._dirty = True


def build(s, scene):
    if scene == "mixed":
        add_mixed_drape(s, 40, 8, sheet_y=2.2)
    elif scene == "cloth":
        _cloth(s)
    else:
        _mesh(s, None)
    s._prepare()
    return s


def solvers(scene, **kw):
    """Both packages' solvers on ``scene``; the JAX one ticks with
    ``unroll_loops=False`` (the same iterations as a ``fori_loop``, traced
    once instead of four times: ``pies_tpu/options.py:122-128``)."""
    kw = dict(dict(enable_collisions=True, allpairs_broadphase_max=0), **kw)
    j = build(pies_tpu.Solver(JOptions(solver=JName.PD), dense_operator_max=0, **kw), scene)
    j._config = dataclasses.replace(j._config, unroll_loops=False)
    t = pt.Solver(pt.SolverOptions(), device="cpu", **kw)
    return j, build(t, scene)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("scene", SCENES)
def test_layout_budget_and_cache_equal(scene):
    j, t = solvers(scene)
    jc, tc = j._config, t.config
    for f in SUPER_FIELDS:
        assert getattr(tc, f) == getattr(jc, f), f
    assert tc.super_k > 0 and (tc.super_packed_k == 40) == (scene == "mixed")
    assert dataclasses.asdict(tc.budget) == dataclasses.asdict(jc.budget)
    assert tc.budget.max_narrow_bodies == 64 and tc.budget.max_candidates_per_body == 512
    jt, tt = j._topology, t.topology
    np.testing.assert_array_equal(tt.super_corners.numpy(), np.asarray(jt.super_corners))
    np.testing.assert_array_equal(tt.super_adj.numpy(), np.asarray(jt.super_adj))
    for f in ("pairs", "valid", "ref"):
        assert tuple(getattr(t.state.bp, f).shape) == tuple(getattr(j._state.bp, f).shape), f
    assert t.state.bp.ref.shape[0] == t.state.capacity and int(t.state.bp.fresh) == 0
    lay = tb.super_layout(tc, tt.super_corners, tt.super_adj)
    assert lay.n_combo == (20 if scene == "mixed" else 3)
    assert len(lay.combos()) == (20 if scene == "mixed" else 3)  # all statically live


def test_layout_function_equals_the_reference_on_seeded_scenes():
    """The port's copy of ``_detect_super_layout`` against the JAX package's
    on the raw arrays: the three scenes, a scene it refuses (bodies of two
    sizes) and one whose packed bodies are not contiguous."""
    cases = []
    for scene in SCENES:
        s = build(pt.Solver(pt.SolverOptions(), device="cpu", allpairs_broadphase_max=0), scene)
        b = s._builder
        cases.append((np.concatenate(b.triangles), np.concatenate(b.tri_bodies),
                      s.state.capacity))
    rng = np.random.default_rng(0)
    tris = rng.integers(0, 64, (24, 3)).astype(np.int32)
    cases.append((tris, np.repeat(np.arange(10), [2, 3, 2, 3, 2, 3, 2, 3, 2, 2]).astype(np.int32),
                  64))
    cases.append((tris, np.repeat(np.arange(12), 2).astype(np.int32), 64))
    for tris, bodies, cap in cases:
        ref, got = jlayout(tris, bodies, cap), thost._detect_super_layout(tris, bodies, cap)
        assert (ref is None) == (got is None)
        if ref is not None:
            assert ref[0] == got[0]
            np.testing.assert_array_equal(ref[1], got[1])
            assert (ref[2] is None) == (got[2] is None)
            if ref[2] is not None:
                np.testing.assert_array_equal(ref[2], got[2])
    assert thost._detect_super_layout(*cases[3]) is None


def test_mixed_topology_keeps_the_band_beside_the_distance_operator():
    j, t = solvers("mixed")
    jt, tt = j._topology, t.topology
    np.testing.assert_array_equal(tt.tet_band.numpy(), np.asarray(jt.tet_band))
    assert jt.ell_nbr is None and jt.tet_block6 is None  # banded: no ELL; distance: no blocks
    assert tt.tet_block6 is None and tt.ell_nbr is not None and tt.row_inc is not None
    # The port's ELL holds the distance Laplacian only: the sheet's rows.
    n_soup = 160
    assert not tt.ell_coef[:, :n_soup].any() and tt.ell_coef[:, n_soup:].any()
    assert not ttetcols.applies(t.state, tt, t.config)
    topo = convert.topology_from_numpy(_np(jt))
    for f in ("tet_band", "super_corners", "super_adj", "ell_nbr", "ell_coef"):
        assert torch.equal(getattr(topo, f), getattr(tt, f)), f
    cfg = convert.config_from(j._config)
    assert cfg == dataclasses.replace(t.config)


_jdetect = jax.jit(jdetect, static_argnames=("config",))


def _fold(j):
    """Fold the JAX solver's flat sheet over itself along x = 2, the folded
    half 0.08 under the other (inside the CCD threshold of 0.1, on the side
    the triangles face) and shifted off the lattice, so that no node lies on
    an edge of the triangle under it (a knife edge that XLA's fused rounding
    and eager PyTorch decide differently).  A flat sheet falling flat never
    touches itself."""
    p = np.array(j._state.positions)
    over = p[:, 0] > 2.0
    p[over, 0] = 4.0 - p[over, 0] + 0.13
    p[over, 1] -= 0.08
    p[over, 2] += 0.07
    j._state = dataclasses.replace(j._state, positions=jnp.asarray(p),
                                   prev_positions=jnp.asarray(p))


def _jax_detect(j, x, cache):
    topo = j._topology
    return _jdetect(x, j._state.prev_positions, topo.triangles, topo.tri_mask,
                    j.current_params(), config=j._config, cache=cache,
                    corners=topo.super_corners, adj=topo.super_adj)


CONTACT_TICK = 12  # the mixed scene's tick of the contact-state tests


@pytest.fixture(scope="module")
def jax_runs():
    """The 40-tick JAX runs of the mixed scene and of the cloth (folded over
    itself first), made once for the module: each scene's starting cache
    and, at every fourth tick, the predicted and the previous positions
    and the JAX detection there with the cache carried from sample to
    sample and without it; and the mixed run's solver with its state
    after ``CONTACT_TICK`` ticks."""
    runs = {}
    for scene in ("mixed", "cloth"):
        j, _ = solvers(scene)
        if scene == "cloth":
            _fold(j)
        jcache, samples = j._state.bp, []
        runs[scene + " cache"] = jcache
        for tick in range(40):
            if scene == "mixed" and tick == CONTACT_TICK:
                runs["mixed at contact"] = SimpleNamespace(
                    _state=j._state, _topology=j._topology, _config=j._config,
                    current_params=j.current_params)
            if tick % 4 == 0:
                s = j._state
                x = s.positions + j.current_params().dt * s.velocities * s.node_mask[:, None]
                carried = _jax_detect(j, x, jcache)
                samples.append((x, s.prev_positions, carried, _jax_detect(j, x, None)))
                jcache = carried[3]
            j.tick()
        runs[scene] = samples
    return runs


@pytest.mark.parametrize("use_cache", [True, False], ids=["cache", "no_cache"])
@pytest.mark.parametrize("scene", ["mixed", "cloth"])
def test_detection_equals_reference_along_a_run(scene, use_cache, jax_runs):
    """States sampled every 4 ticks of a 40-tick JAX run (the cloth folded
    over itself first); with the cache, both packages carry their own cache
    from sample to sample."""
    t = build(pt.Solver(pt.SolverOptions(), device="cpu", enable_collisions=True,
                        allpairs_broadphase_max=0), scene)
    topo, cfg, params = t.topology, t.config, t.current_params()
    tcache = convert.cache_from_numpy(_np(jax_runs[scene + " cache"]))
    contacts = rebuilds = 0
    for x, prev, carried, fresh in jax_runs[scene]:
        out = carried if use_cache else fresh
        ji, jm, jo = np.asarray(out[0]), np.asarray(out[1]), bool(out[2])
        pi, pm, pc, po, rb = tb.detect_point_tri_collisions(
            torch.from_numpy(np.array(x)), torch.from_numpy(np.array(prev)),
            topo.tri_mask, params, cfg, cache=tcache if use_cache else None,
            corners=topo.super_corners, adj=topo.super_adj)
        n = int(pc[0])
        assert n == int(jm.sum()) and bool(po[0]) == jo
        np.testing.assert_array_equal(pi.numpy(), ji)
        np.testing.assert_array_equal(pm.numpy(), jm)
        contacts += n
        if use_cache:
            ref = convert.cache_from_numpy(_np(out[3]))
            for f in ("pairs", "valid", "ref", "fresh"):
                assert torch.equal(getattr(tcache, f), getattr(ref, f)), f
            rebuilds += int(rb[0])
    assert contacts > 0
    if use_cache:
        # The mixed scene's samples reuse cached pairs; the sheet, with its
        # small cell, moves past the slack between any two samples.
        assert 0 < rebuilds < 10 if scene == "mixed" else rebuilds == 10


def test_latches_fire_as_in_the_reference():
    """Each capacity of the super-body broadphase, made too small, latches in
    both packages on the scene as built: the truncated raw gather (2
    candidates per row) and the exact tier (1 narrow slot); the default
    budget does not."""
    for over, expect in (({}, False), ({"max_candidates_per_body": 2}, True),
                         ({"max_narrow_bodies": 1}, True)):
        j, t = solvers("mixed", budget_overrides=over)
        s = j._state
        out = _jax_detect(j, s.positions, None)
        _, _, _, po, _ = tb.detect_point_tri_collisions(
            t.state.positions, t.state.prev_positions, t.topology.tri_mask, t.current_params(),
            t.config, corners=t.topology.super_corners, adj=t.topology.super_adj)
        assert bool(po[0]) == bool(out[2]) == expect, over


@pytest.mark.parametrize("scene", ["mixed", "cloth"])
def test_broadphase_twin_in_blocks_of_rows_equals_one_block(scene, monkeypatch):
    """The T14 twin gathers and packs its rows in blocks (a large scene's
    [rows, 512] intermediates); blocks of 7 rows give the cache, latch and
    contacts of one block over all rows."""
    _, t = solvers(scene)
    if scene == "cloth":
        p = t.state.positions.numpy().copy()
        over = p[:, 0] > 2.0
        p[over] = p[over] * np.float32([-1, 1, 1]) + np.float32([4.13, -0.08, 0.07])
        t.state.positions.copy_(torch.from_numpy(p))
        t.state.prev_positions.copy_(torch.from_numpy(p))
    st, topo = t.state, t.topology
    lay = tb.super_layout(t.config, topo.super_corners, topo.super_adj)
    sc = tb.scalars(t.current_params())
    out = []
    for rows in (tb.SUPER_TWIN_ROWS, 7):
        monkeypatch.setattr(tb, "SUPER_TWIN_ROWS", rows)
        cache, over = st.bp.clone(), torch.zeros(1, dtype=torch.int32)
        rb = tb.super_broadphase_plain(st.positions, st.prev_positions, topo.super_corners,
                                       topo.super_adj, cache, lay, sc, over)
        contacts = tb.super_narrowphase_plain(st.positions, st.prev_positions,
                                              topo.super_corners, cache, lay, sc, over)
        out.append((cache, int(over[0]), int(rb[0]), contacts))
    (c1, o1, r1, p1), (c7, o7, r7, p7) = out
    assert lay.k > 7 and r1 == r7 == 1 and o1 == o7 == 0
    for f in ("pairs", "valid", "ref", "fresh"):
        assert torch.equal(getattr(c1, f), getattr(c7, f)), f
    assert int(c1.valid.sum()) > 0 and int(p1[2][0]) > 0
    for a, b in zip(p1, p7):
        assert torch.equal(a, b)


def _contact_state(jax_runs):
    """The mixed scene after ``CONTACT_TICK`` JAX ticks (the module's run),
    with its detection, and the port's solver of the scene."""
    j = jax_runs["mixed at contact"]
    t = build(pt.Solver(pt.SolverOptions(), device="cpu", enable_collisions=True,
                        allpairs_broadphase_max=0), "mixed")
    s, p = j._state, j.current_params()
    x = s.positions + p.dt * s.velocities * s.node_mask[:, None]
    pt_idx, pt_mask, _, _ = _jax_detect(j, x, s.bp)
    assert int(np.asarray(pt_mask).sum()) > 0
    return j, t, x, pt_idx, pt_mask


def test_band_operator_and_contact_diagonal_match_reference(jax_runs):
    j, t, x, pt_idx, pt_mask = _contact_state(jax_runs)
    s, p, cfg = j._state, j.current_params(), j._config
    n = s.capacity
    colls = dataclasses.replace(
        empty_collision_set(pt_cap=0, static_cap=0), pt_idx=pt_idx, pt_mask=pt_mask,
        floor_active=jnp.asarray((np.asarray(x)[:, 1] < 0.3).astype(np.float32)))
    moh2 = s.mass / (p.dt * p.dt)
    ptd_ref = np.asarray(jasm.point_tri_collision_diag(colls, n, x.dtype))
    static_diag = jasm.static_collision_diag(colls, n, x.dtype, j._topology.floor_count) + ptd_ref
    rng = np.random.default_rng(3)
    v = rng.standard_normal((n, 3)).astype(np.float32)
    ref = np.asarray(jasm.apply_system(
        jnp.asarray(v), moh2, j._topology, colls, cfg.strain_contiguous, cfg.volume_contiguous,
        static_diag=static_diag, contact_coupling="recentered", tet_shared=cfg.tet_fused))

    topo, st = t.topology, t.state
    tcolls = CollisionSet(
        floor_active=torch.from_numpy(np.asarray(colls.floor_active)),
        pt_idx=torch.from_numpy(np.array(pt_idx)), pt_mask=torch.from_numpy(np.array(pt_mask)),
        pt_count=torch.tensor([int(np.asarray(pt_mask).sum())], dtype=torch.int32))
    _, h2 = tpd._h_h2(t.current_params())
    wf = tasm.static_collision_diag(tcolls, topo.floor_count)
    diag = tasm.system_diag(st.mass / h2, topo, tcolls)
    sd = wf.clone()
    inc, ptd = ttetcols.pt_coupling_setup(tcolls, st.mass, topo, h2, diag, wf, None, sd)
    np.testing.assert_array_equal(ptd.numpy(), ptd_ref)
    np.testing.assert_array_equal(sd.numpy(), np.asarray(static_diag))
    np.testing.assert_array_equal(diag.numpy(),
                                  np.asarray(jasm.system_diag(moh2, j._topology, colls)))
    got, _ = tasm.apply_system(torch.from_numpy(v), st.mass, sd, h2, topo)
    assert np.abs(got.numpy() - ref).max() <= 2e-6 * np.abs(ref).max()
    # Without the band the product is another one: the tets are in it.
    no_band = dataclasses.replace(topo, tet_band=None)
    other, _ = tasm.apply_system(torch.from_numpy(v), st.mass, sd, h2, no_band)
    assert np.abs(other.numpy() - ref).max() > 1e-2 * np.abs(ref).max()


def test_force_with_contact_terms_matches_reference(jax_runs):
    j, t, x, pt_idx, pt_mask = _contact_state(jax_runs)
    s, p, cfg = j._state, j.current_params(), j._config
    n = s.capacity
    floor = (np.asarray(x)[:, 1] < 0.3).astype(np.float32)
    colls = dataclasses.replace(empty_collision_set(pt_cap=0, static_cap=0), pt_idx=pt_idx,
                                pt_mask=pt_mask, floor_active=jnp.asarray(floor))
    ptd_ref = jasm.point_tri_collision_diag(colls, n, x.dtype)
    msn = x * (s.mass / (p.dt * p.dt))[:, None]
    local = jasm.local_step(
        x, s.inv_mass, s.mass, s.shape_quats, j._topology, colls, p.collision_thickness,
        p.floor_height, cfg.rotation_iterations, cfg.reference_quirks, cfg.strain_contiguous,
        cfg.volume_contiguous, radius=s.radius, pt_full=False, tet_fused=cfg.tet_fused)
    ref = np.asarray(jasm.assemble_force(
        msn, local, j._topology, colls, cfg.strain_contiguous, cfg.volume_contiguous,
        contact_coupling="recentered", x=x, pt_diag=ptd_ref, tet_fused=cfg.tet_fused))

    topo, st, params = t.topology, t.state, t.current_params()
    xt = torch.from_numpy(np.array(x))
    tcolls = CollisionSet(
        floor_active=torch.from_numpy(floor), pt_idx=torch.from_numpy(np.array(pt_idx)),
        pt_mask=torch.from_numpy(np.array(pt_mask)),
        pt_count=torch.tensor([int(np.asarray(pt_mask).sum())], dtype=torch.int32))
    _, h2 = tpd._h_h2(params)
    wf = tasm.static_collision_diag(tcolls, topo.floor_count)
    diag = tasm.system_diag(st.mass / h2, topo, tcolls)
    inc, ptd = ttetcols.pt_coupling_setup(tcolls, st.mass, topo, h2, diag, wf)
    contact = ttetcols.pt_force(xt, tcolls, inc, params.collision_thickness)
    rows = tasm.local_step(xt, st.inv_mass, st.mass, st.shape_quats.clone(), topo,
                           t.config.rotation_iterations)
    msn_t = torch.from_numpy(np.array(msn))
    pt_args = (ptd, contact, inc.row_start, tcolls.pt_count)
    got, static = tasm.assemble_force(xt, msn_t, wf, rows, topo, 0.0, None, pt_args)
    assert np.abs(got.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
    np.testing.assert_array_equal(static.numpy(), np.asarray(local.static))
    # The contact terms are in it: without them the force is another one.
    bare, _ = tasm.assemble_force(xt, msn_t, wf, rows, topo, 0.0)
    assert np.abs(bare.numpy() - ref).max() > 1e-3 * np.abs(ref).max()


def test_branches_not_ported_raise_and_name_their_item():
    """The detection branches of item 6b now prepare (the cloth at most
    1,024 triangles, the reference sweep, a layout the super-body detection
    refuses), and so does the PBD solver of item 7, full contact coupling
    and a soup off the tet-column path (item 5c); what is still not ported
    raises and names its item."""
    kw = dict(device="cpu", allpairs_broadphase_max=0)
    assert tb.tri_mode(build(pt.Solver(pt.SolverOptions(), device="cpu"), "cloth").config,
                       168) == "allpairs"
    s = build(pt.Solver(pt.SolverOptions(), broadphase_mode="reference", **kw), "cloth")
    assert tb.tri_mode(s.config, 168) == "reference"
    s = pt.Solver(pt.SolverOptions(), **kw)
    s.create_tet_soup(8, spacing=1.6, scale=0.8, w=2000.0)
    s._builder.tri_bodies[0] = np.repeat(np.arange(16), 2).astype(np.int32)  # half tets
    s._prepare()
    assert s.config.super_k == 0 and tb.tri_mode(s.config, 32) == "bodies"
    # Full contact coupling on the mixed scene ticks (tests/test_torch_coupling.py
    # holds it to the JAX package).
    s = build(pt.Solver(pt.SolverOptions(), contact_coupling="full", **kw), "mixed")
    s.tick()
    assert not s.sim_failed and s.config.super_k > 0
    # PD node-node contacts run (tests/test_torch_nodes.py holds them to the
    # JAX package): a soup with them prepares, leaves the tet-column path
    # and ticks on the generic one.
    s = pt.Solver(pt.SolverOptions(), enable_node_collisions=True, **kw)
    s.create_tet_soup(8, spacing=1.6, scale=0.8, w=2000.0)
    s._prepare()
    assert s.config.enable_node_collisions
    assert not ttetcols.applies(s.state, s.topology, s.config)
    s.tick()
    assert not s.sim_failed
    # The PBD solver is ported (tests/test_torch_pbd.py): a PBD cloth
    # prepares (colour classes, the node-pair cache) and ticks.
    s = build(pt.Solver(pt.SolverOptions(solver=pt.SolverName.PBD), **kw), "cloth")
    assert len(s.config.distance_colors) > 1 and s.state.nn is not None
    s.tick()
    assert not s.sim_failed and int(s.state.nn.count[0]) > 0
    # A soup off the tet-column path keeps its block structure and ticks on
    # the generic path with the block preconditioner.
    s = pt.Solver(pt.SolverOptions(), enable_collisions=False, device="cpu")
    s.create_tet_soup(8, spacing=1.6, scale=0.8, w=2000.0)
    s._prepare()
    s._config = dataclasses.replace(s.config, tet_cols=False)
    assert not ttetcols.applies(s.state, s.topology, s.config)
    s.tick()
    assert not s.sim_failed
