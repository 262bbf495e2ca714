"""The port's CUDA kernels against their plain PyTorch twins.

This file imports nothing of JAX or of the JAX package; on a GPU machine:

    python -m pytest -m gpu tests/test_torch_kernels.py -q

Tests marked ``gpu`` skip without a CUDA device.  The library is built with
``-fmad=false`` and IEEE division and square root, and each kernel does its
twin's float32 operations in the same order, so the tolerances are tight: T3
and T4 exact, T1 1e-6 of the largest force and T2 1e-6 absolute (allowing
only for library-math differences), and a 40-tick trajectory 1e-5.  The
self-contact kernels T5-T8 are held to their twins exactly: equal caches,
contacts and incidence, and bit-equal forces and positions (their sums run
in one fixed order on both sides, and their library math is the same
libdevice ``powf``/``acosf``/``cosf``).  The generic path's kernels T9-T11
are held to their twins exactly too, with equal CG trip counts: the CG's dot
products are summed in the same fixed block order on both sides.  Of the
constraint kernels, T12's distance rows, T13's goal rows, the unfused tet
force and the CSR operator are held exactly; T12's bend rows and T13's shape
rows and rotations within 1e-6 of the largest row (they pass through
``acosf``, ``sinf`` and ``cosf``; measured equal on an H100).
"""

import dataclasses

import numpy as np
import pytest
import torch

import os

import pies_tpu_torch as pt
from pies_tpu_torch.collision import broadphase
from pies_tpu_torch.collision.batches import CollisionSet, incident
from pies_tpu_torch.constraints import projections as proj
from pies_tpu_torch.options import CollisionBudget
from pies_tpu_torch.scene.mesh_dump import add_tet_mesh, load_mesh_txt
from pies_tpu_torch.solver import assembly, pd, step, tetcols

SCENE = dict(spacing=1.6, scale=0.8, w=2000.0, height=0.5, jitter=0.05)
CONTACT_SCENE = dict(SCENE, spacing=1.0)
WRAPPERS = (pd.substep_head, proj.tet_force12, tetcols.substep_cols, pd.substep_tail)
CONTACT_WRAPPERS = (broadphase.body_broadphase, broadphase.pt_narrowphase,
                    tetcols.pt_coupling_setup, tetcols.pt_force, tetcols.contact_substep,
                    pd.pt_tail)
GENERIC_WRAPPERS = (pd.substep_head, proj.tet_force12_gathered, assembly.assemble_force,
                    assembly.apply_system, assembly.pcg_solve, pd.substep_tail)
MESH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "scripts", "refbench", "tet_cube_mesh.txt")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _solver(device, n=96):
    s = pt.Solver(pt.SolverOptions(), enable_collisions=False, device=device)
    s.create_tet_soup(n, **SCENE)
    return s


def _clone(state):
    return dataclasses.replace(
        state, **{f.name: getattr(state, f.name).clone() for f in dataclasses.fields(state)
                  if getattr(state, f.name) is not None}
    )


def _head_inputs(s):
    """A state whose predicted positions put the bottom layer on the floor."""
    st = s.state
    rng = np.random.default_rng(0)
    vel = 0.5 * rng.standard_normal((st.capacity, 3)) + np.array([0.0, -40.0, 0.0])
    st.velocities.copy_(torch.from_numpy(vel.astype(np.float32)).to(st.device)
                        * st.node_mask[:, None])
    return st, s.topology, s._config, s.current_params()


def test_cpu_tensors_take_the_twin_and_count_nothing():
    s = _solver("cpu")
    before = [f.launches for f in WRAPPERS]
    s.run_ticks(2)
    assert [f.launches for f in WRAPPERS] == before
    assert not s.sim_failed


def _mesh_solver(device, pins=(0, 10, 110, 120), **kw):
    s = pt.Solver(pt.SolverOptions(), enable_collisions=False, device=device, **kw)
    add_tet_mesh(s, *load_mesh_txt(MESH), pins=pins or ())
    return s


def test_cpu_tensors_take_the_generic_twins():
    s = _mesh_solver("cpu")
    before = [f.launches for f in GENERIC_WRAPPERS]
    s.run_ticks(1)
    assert [f.launches for f in GENERIC_WRAPPERS] == before
    assert not s.sim_failed


def test_cpu_tensors_take_the_contact_twins():
    s = pt.Solver(pt.SolverOptions(), enable_collisions=True, device="cpu")
    s.create_tet_soup(96, **CONTACT_SCENE)
    wrappers = WRAPPERS + CONTACT_WRAPPERS
    before = [f.launches for f in wrappers]
    s.counters = pd.new_counters("cpu")
    s.run_ticks(2)
    assert [f.launches for f in wrappers] == before
    assert not s.sim_failed and int(s.counters["contacts"]) > 0


def test_cuda_solver_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.Solver(pt.SolverOptions(), enable_collisions=False)


@pytest.mark.gpu
def test_head_and_tail_kernels_are_exact(cuda):
    s = _solver(cuda)
    st, topo, cfg, params = _head_inputs(s)
    a, b = _clone(st), _clone(st)
    hk = pd.substep_head(a, topo, params, cfg, True)
    hp = pd.substep_head_plain(b, topo, params, cfg, True)
    for u, v in zip(hk, hp):
        assert torch.equal(u, v)
    assert hk[4].sum().item() > 0  # floor-active nodes
    x, static, _ = tetcols.substep_cols(hk[0], hk[1], hk[2], st.node_mask, hk[3], topo,
                                        0.0, cfg.iterations, st.sim_failed)
    pd.substep_tail(a, topo, params, hk[4], x, static)
    pd.substep_tail_plain(b, topo, params, hk[4], x, static)
    for f in ("positions", "prev_positions", "velocities", "forces", "sim_failed"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.gpu
def test_tet_force12_kernel_matches_twin(cuda):
    s = _solver(cuda, n=1024)
    st, topo, cfg, params = _head_inputs(s)
    x = pd.substep_head_plain(_clone(st), topo, params, cfg, True)[0]
    out = proj.tet_force12(x, topo.strain, topo.volume, st.sim_failed)
    ref = proj.tet_force12_plain(x, topo.strain, topo.volume)
    assert (out - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("pins", [None, [0, 5]], ids=["soup", "pinned_soup"])
def test_substep_cols_kernel_matches_twin(cuda, pins):
    s = pt.Solver(pt.SolverOptions(), enable_collisions=False, device=cuda, node_capacity=4112)
    s.create_tet_soup(1024, **SCENE)  # 4 padding blocks past the live tets
    if pins:
        s._builder.pos_idx.append(np.asarray(pins, np.int32))
        s._builder.pos_w.append(np.full(len(pins), 8000.0, np.float32))
    st, topo, cfg, params = _head_inputs(s)
    x, msn, diag, wf, _ = pd.substep_head_plain(_clone(st), topo, params, cfg, True)
    args = (x, msn, diag, st.node_mask, wf, topo, 0.0, cfg.iterations, st.sim_failed)
    out = tetcols.substep_cols(*args)
    ref = tetcols.substep_cols_plain(*args)
    for u, v in zip(out[:2], ref[:2]):
        assert (u - v).abs().max().item() <= 1e-6
    assert torch.equal(out[0][4 * 1024:], x[4 * 1024:])  # padding stays parked


@pytest.mark.gpu
def test_kernels_match_twins_over_a_trajectory(cuda):
    """40 ticks of the soup, kernels against twins: T3, T2 and T4 launched
    every tick, T1 never (T2 computes the first iteration's tet force)."""
    before = [f.launches for f in WRAPPERS]
    a, b = _solver(cuda), _solver(cuda)
    a.run_ticks(40)
    step.tick_n(b.state, b.topology, b.current_params(), b._config, 40, plain=True)
    assert [f.launches - n for f, n in zip(WRAPPERS, before)] == [40, 0, 40, 40]
    assert not a.sim_failed and not b.sim_failed
    assert (a.state.positions - b.state.positions).abs().max().item() <= 1e-5
    assert a.state.positions[:, 1].min().item() < 0.05


@pytest.mark.gpu
def test_failure_latch_on_the_card(cuda):
    """A non-finite position latches on the card and freezes the state,
    with no host sync inside run_ticks."""
    s = _solver(cuda, n=24)
    s.state.velocities[7, 0] = float("inf")
    s.run_ticks(1)
    assert s.sim_failed
    frozen = s.state.positions.clone()
    s.run_ticks(3)
    torch.testing.assert_close(s.state.positions, frozen, rtol=0, atol=0, equal_nan=True)
    assert s.last_residual == 0.0


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    s = _solver(cuda, n=24)
    topo = s.topology
    with pytest.raises(ValueError):
        proj.tet_force12(s.state.positions.double(), topo.strain, topo.volume)
    with pytest.raises(ValueError):
        proj.tet_force12(s.state.positions.t().contiguous().t(), topo.strain, topo.volume)


def _contact_state(device, n=512, ticks=25):
    """A self-contact soup after ``ticks`` ticks of the kernels, with the
    predicted positions of its next substep."""
    s = pt.Solver(pt.SolverOptions(), enable_collisions=True, device=device)
    s.create_tet_soup(n, **CONTACT_SCENE)
    s.run_ticks(ticks)
    st, topo, cfg, params = s.state, s.topology, s.config, s.current_params()
    head = pd.substep_head_plain(_clone(st), topo, params, cfg, True)
    return s, head


@pytest.mark.gpu
@pytest.mark.parametrize("force_rebuild", [False, True], ids=["as_found", "rebuild"])
def test_broadphase_and_narrowphase_kernels_equal_twins(cuda, force_rebuild):
    s, (x, *_rest) = _contact_state(cuda)
    st, topo = s.state, s.topology
    lay = broadphase.body_layout(s.config, topo.tri_mask.shape[0])
    sc = broadphase.scalars(s.current_params())
    out = []
    for bf, nf in ((broadphase.body_broadphase, broadphase.pt_narrowphase),
                   (broadphase.body_broadphase_plain, broadphase.pt_narrowphase_plain)):
        cache = st.bp.clone()
        if force_rebuild:
            cache.fresh.zero_()
        over = torch.zeros(1, dtype=torch.int32, device=cuda)
        rebuilt = bf(x, st.prev_positions, topo.tri_mask, cache, lay, sc, over, st.sim_failed)
        contacts = nf(x, st.prev_positions, topo.tri_mask, cache, lay, sc, over, st.sim_failed)
        out.append((cache, over, rebuilt, contacts))
    (ck, ok, rk, pk), (cp, op, rp, pp) = out
    for f in ("pairs", "valid", "ref", "fresh"):
        assert torch.equal(getattr(ck, f), getattr(cp, f)), f
    assert torch.equal(ok, op) and int(rk[0]) == int(rp[0]) == int(force_rebuild or rk[0])
    for a, b in zip(pk, pp):
        assert torch.equal(a, b)
    assert int(pk[2][0]) > 0


@pytest.mark.gpu
def test_coupling_and_tail_kernels_equal_twins(cuda):
    s, (x, msn, diag, wf, active) = _contact_state(cuda)
    st, topo, cfg, params = s.state, s.topology, s.config, s.current_params()
    pt_idx, pt_mask, pt_count, over, _ = broadphase.detect_point_tri_collisions(
        x, st.prev_positions, topo.tri_mask, params, cfg, cache=st.bp.clone(),
        failed=st.sim_failed)
    colls = CollisionSet(floor_active=active, pt_idx=pt_idx, pt_mask=pt_mask,
                         pt_count=pt_count, overflow=over)
    _, h2 = pd._h_h2(params)
    dk, dp = diag.clone(), diag.clone()
    inc_k, ptd_k = tetcols.pt_coupling_setup(colls, st.mass, topo, h2, dk, wf, st.sim_failed)
    inc_p, ptd_p = tetcols.pt_coupling_setup_plain(colls, st.mass, topo, h2, dp, wf,
                                                   st.sim_failed)
    nnz, on = int(inc_p.row_start[-1]), incident(inc_p)
    assert nnz == 4 * int(pt_count[0]) > 0
    assert torch.equal(inc_k.row_start, inc_p.row_start)
    assert torch.equal(inc_k.entries[:nnz], inc_p.entries[:nnz])
    assert torch.equal(ptd_k[on], ptd_p[on]) and torch.equal(dk, dp)
    thick = params.collision_thickness
    fk = tetcols.pt_force(x, colls, inc_k, thick, st.sim_failed)
    fp = tetcols.pt_force_plain(x, colls, inc_p, thick, st.sim_failed)
    assert torch.equal(fk[on], fp[on])

    pt_args = (ptd_k, fk, inc_k.row_start, pt_count)
    args = (x, msn, dk, st.node_mask, wf, topo, 0.0, 1, st.sim_failed, pt_args)
    x_new, static, _ = tetcols.substep_cols(*args)
    x_ref, static_ref, _ = tetcols.substep_cols_plain(*args)
    assert torch.equal(x_new, x_ref) and torch.equal(static, static_ref)

    a, b = _clone(st), _clone(st)
    xa, xb = x_new.clone(), x_new.clone()
    fa = pd.pt_tail(a, params, cfg, colls, inc_k, xa, static)
    fb = pd.pt_tail_plain(b, params, cfg, colls, inc_p, xb, static)
    assert torch.equal(xa, xb) and torch.equal(a.prev_positions, b.prev_positions)
    assert torch.equal(fa[on], fb[on])


@pytest.mark.gpu
def test_contact_kernels_match_twins_over_a_trajectory(cuda):
    """40 ticks of a self-contact soup, kernels against twins: the same
    contacts every tick and the same positions, and every kernel of the
    path launched on every tick (T7's force inside T2's contact substep,
    so its own wrapper never, nor T2's contact-free form, nor T1: T2
    computes the first iteration's tet force)."""
    runs = []
    for plain in (False, True):
        s = pt.Solver(pt.SolverOptions(), enable_collisions=True, device=cuda)
        s.create_tet_soup(512, **CONTACT_SCENE)
        before = [f.launches for f in WRAPPERS + CONTACT_WRAPPERS]
        counts = []
        for _ in range(40):
            c = pd.new_counters(cuda)
            if plain:
                step.tick(s.state, s.topology, s.current_params(), s.config, plain=True,
                          counters=c)
            else:
                s.counters = c
                s.tick()
            counts.append(int(c["contacts"]))
        launched = [f.launches - n for f, n in zip(WRAPPERS + CONTACT_WRAPPERS, before)]
        assert not s.sim_failed
        runs.append((counts, s.state.positions.clone(), launched))
    (ck, xk, lk), (cp, xp, lp) = runs
    assert ck == cp and sum(ck) > 0
    assert torch.equal(xk, xp)
    unused = [(WRAPPERS + CONTACT_WRAPPERS).index(f) for f in (tetcols.pt_force,
                                                                tetcols.substep_cols,
                                                                proj.tet_force12)]
    assert all((n == 0) == (i in unused) for i, n in enumerate(lk))
    assert not any(lp)


@pytest.mark.gpu
def test_contact_latch_on_the_card(cuda):
    """One narrow slot per body cannot hold a dense soup's exact overlaps:
    the kernels latch sim_failed on the first tick, as the twins do, and
    later ticks leave the state and the broadphase cache as they are."""
    runs = []
    for plain in (False, True):
        s = pt.Solver(pt.SolverOptions(), enable_collisions=True, device=cuda,
                      budget_overrides={"max_narrow_bodies": 1})
        s.create_tet_soup(64, **dict(CONTACT_SCENE, spacing=0.9))
        step.tick(s.state, s.topology, s.current_params(), s.config, plain=plain)
        assert s.sim_failed
        frozen = (s.state.positions.clone(), s.state.bp.clone())
        step.tick_n(s.state, s.topology, s.current_params(), s.config, 3, plain=plain)
        assert torch.equal(s.state.positions, frozen[0])
        for f in ("pairs", "valid", "ref", "fresh"):
            assert torch.equal(getattr(s.state.bp, f), getattr(frozen[1], f)), f
        runs.append(frozen)
    assert torch.equal(runs[0][0], runs[1][0])


def _mesh_floor_state(device, ticks=30):
    """The pinned 1,331-node mesh after ``ticks`` ticks of the kernels (its
    far side rests on the floor from tick ~27), with its next substep's
    head."""
    s = _mesh_solver(device)
    s.run_ticks(ticks)
    st, topo, cfg, params = s.state, s.topology, s.config, s.current_params()
    return s, pd.substep_head_plain(_clone(st), topo, params, cfg, True)


@pytest.mark.gpu
def test_generic_kernels_equal_twins(cuda):
    s, (x, msn, diag, wf, active) = _mesh_floor_state(cuda)
    st, topo, cfg, params = s.state, s.topology, s.config, s.current_params()
    assert active.sum().item() > 0
    failed = st.sim_failed
    bk = proj.tet_force12_gathered(x, topo.strain, topo.volume, failed)
    bp = proj.tet_force12_gathered_plain(x, topo.strain, topo.volume)
    assert torch.equal(bk, bp)
    fk = assembly.assemble_force(x, msn, wf, bk, topo, 0.0, failed)
    fp = assembly.assemble_force_plain(x, msn, wf, bk, topo, 0.0)
    for a, b in zip(fk, fp):
        assert torch.equal(a, b)
    _, h2 = pd._h_h2(params)
    yk, pk = assembly.apply_system(x, st.mass, wf, h2, topo, failed, part=True)
    yp, pp = assembly.apply_system_plain(x, st.mass, wf, h2, topo, part=True)
    assert torch.equal(yk, yp) and torch.equal(pk, pp)
    for iters, rtol in ((16, 1e-4), (16, 0.0), (64, 1e-6)):
        args = (fk[0], x, diag, st.mass, wf, h2, st.node_mask, topo, iters, rtol)
        ok = assembly.pcg_solve(*args, failed)
        op = assembly.pcg_solve_plain(*args, failed)
        assert torch.equal(ok[0], op[0]) and torch.equal(ok[1], op[1]), (iters, rtol)
        assert int(ok[2][0]) == int(op[2][0]), (iters, rtol)


@pytest.mark.gpu
def test_generic_kernels_match_twins_over_a_trajectory(cuda):
    """40 ticks of the pinned mesh, kernels against twins: equal floor
    counts and CG trips, equal positions, and every kernel of the path
    launched."""
    runs = []
    for plain in (False, True):
        s = _mesh_solver(cuda)
        before = [f.launches for f in GENERIC_WRAPPERS]
        c = pd.new_counters(cuda)
        step.tick_n(s.state, s.topology, s.current_params(), s.config, 40, plain=plain,
                    counters=c)
        launched = [f.launches - n for f, n in zip(GENERIC_WRAPPERS, before)]
        assert not s.sim_failed
        runs.append(({k: int(v) for k, v in c.items()}, s.state.positions.clone(), launched))
    (ck, xk, lk), (cp, xp, lp) = runs
    assert ck == cp and ck["floor_active"] > 0 and ck["cg_trips"] == 40 * 4 * 16
    assert torch.equal(xk, xp)
    assert all(n > 0 for n in lk) and not any(lp)


@pytest.mark.gpu
def test_generic_early_exit_on_the_card(cuda):
    """The tet box of tests/test_solver.py:411 with a 32-trip cap and
    rtol 1e-6: the kernels stop after the same trips as the twins, and a
    skipped tick (the latch) reports residual 0."""
    runs = []
    for plain in (False, True):
        s = pt.Solver(pt.SolverOptions(), enable_collisions=False, device=cuda,
                      cg_iterations=32, cg_rtol=1e-6)
        s.create_tet_box((0, 2.0, 0), 1.0, (0, 0, 0), w=1500.0, mass=1.0)
        trips = []
        for _ in range(20):
            c = pd.new_counters(cuda)
            step.tick(s.state, s.topology, s.current_params(), s.config, plain=plain, counters=c)
            trips.append(int(c["cg_trips"]))
        runs.append((trips, s.state.positions.clone()))
    assert runs[0][0] == runs[1][0] and sum(runs[0][0]) < 20 * 4 * 32
    assert torch.equal(runs[0][1], runs[1][1])
    s.state.velocities[3, 0] = float("inf")
    s.run_ticks(2)
    assert s.sim_failed and s.last_residual == 0.0


# ---------------------------------------------------------------------------
# T12, T13, the unfused T9 mode and the CSR operator


def _cloth_solver(device, n=32):
    from pies_tpu_torch.scene.rigged_cloth import add_rigged_cloth

    s = pt.Solver(pt.SolverOptions(), enable_collisions=False, device=device)
    add_rigged_cloth(s, n)
    return s


def _star_solver(device, spokes=80):
    """A hub joined to ``spokes`` rim nodes and the rim closed to a ring: the
    hub's operator row has more than 64 entries, so the operator is CSR."""
    s = pt.Solver(pt.SolverOptions(), enable_collisions=False, device=device)
    ang = np.linspace(0.0, 2 * np.pi, spokes, endpoint=False)
    pts = np.concatenate([[[0.0, 2.0, 0.0]],
                          np.stack([np.cos(ang), 2.0 + 0.1 * np.sin(3 * ang), np.sin(ang)], 1)])
    ids = s._builder._emit_nodes(pts.astype(np.float32), inv_mass=1.0, radius=0.05)
    rim = ids[1:]
    s._builder._emit_distance(np.stack([np.full(spokes, ids[0]), rim], 1), 3000.0)
    s._builder._emit_distance(np.stack([rim, np.roll(rim, -1)], 1), 3000.0)
    s._builder._emit_triangles(np.stack([np.full(spokes, ids[0]), rim, np.roll(rim, -1)], 1))
    s._dirty = True
    return s


NEW_WRAPPERS = (proj.distance_rows, proj.bend_rows, proj.shape_rows, proj.goal_rows,
                assembly.assemble_force, assembly.apply_system, assembly.pcg_solve)


def test_cpu_tensors_take_the_constraint_twins():
    s = _cloth_solver("cpu", 16)
    before = [f.launches for f in NEW_WRAPPERS]
    s.run_ticks(1)
    assert [f.launches for f in NEW_WRAPPERS] == before
    assert not s.sim_failed


def test_star_scene_stores_its_operator_as_csr():
    s = _star_solver("cpu")
    topo = s.topology
    assert topo.ell_nbr is None and topo.csr_start is not None
    assert int((topo.csr_start[1:] - topo.csr_start[:-1]).max()) == 81
    s.run_ticks(3)
    assert not s.sim_failed


@pytest.mark.gpu
def test_constraint_row_kernels_match_twins(cuda):
    """T12 and T13 on a moving rigged cloth (20 ticks in, the fixed region
    turned): distance and goal rows bit-equal; bend and shape rows and the
    new quaternions within 1e-6 of the largest row (``acosf``, ``sinf`` and
    ``cosf`` against torch's)."""
    from pies_tpu_torch.scene.rigged_cloth import fixed_region_matrix

    s = _cloth_solver(cuda, 64)
    s.run_ticks(20)
    s.update_fixed_regions([fixed_region_matrix(64, 0.1, 0.3, 0.05)])
    s.run_ticks(2)
    st, topo, cfg = s.state, s.topology, s.config
    x, failed = st.positions, st.sim_failed
    assert torch.equal(proj.distance_rows(x, topo.distance, failed),
                       proj.distance_rows_plain(x, topo.distance))
    assert torch.equal(proj.goal_rows(topo.goal, failed), proj.goal_rows_plain(topo.goal))
    bk = proj.bend_rows(x, st.inv_mass, topo.bend, failed)
    bp = proj.bend_rows_plain(x, st.inv_mass, topo.bend)
    assert float((bk - bp).abs().max()) <= 1e-6 * float(bp.abs().max())
    qk, qp = st.shape_quats.clone(), st.shape_quats.clone()
    sk = proj.shape_rows(x, st.mass, qk, topo.shape, cfg.rotation_iterations, failed)
    sp = proj.shape_rows_plain(x, st.mass, qp, topo.shape, cfg.rotation_iterations)
    assert float((sk - sp).abs().max()) <= 1e-6 * float(sp.abs().max())
    assert float((qk - qp).abs().max()) <= 1e-6
    assert not torch.equal(qk, st.shape_quats)  # the groups did turn
    assert torch.equal(proj.shape_group_sums(x, st.mass, topo.shape),
                       proj.shape_group_sums(x.cpu(), st.mass.cpu(),
                                             pt.topology.to_device(topo.shape, "cpu")).to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["strain", "volume"])
def test_unfused_tet_force_kernel_equals_twin(cuda, kind):
    s = pt.Solver(pt.SolverOptions(), enable_collisions=False, device=cuda)
    pts, tets, surf = load_mesh_txt(MESH)
    ids = s._builder._emit_nodes(pts, inv_mass=1.0, radius=0.2)
    s._builder._emit_tets(ids[tets], 1000.0, **{("volume_w" if kind == "strain" else
                                                 "strain_w"): 0.0})
    s._builder._emit_triangles(ids[surf])
    s._dirty = True
    s.run_ticks(10)
    st, topo = s.state, s.topology
    assert not topo.tet_fused and not s.sim_failed
    bk = proj.tet_force12_gathered(st.positions, topo.strain, topo.volume, st.sim_failed,
                                   kind=kind)
    bp = proj.tet_force12_gathered_plain(st.positions, topo.strain, topo.volume, kind=kind)
    assert torch.equal(bk, bp) and float(bk.abs().max()) > 0


@pytest.mark.gpu
def test_csr_operator_kernel_equals_twin(cuda):
    s = _star_solver(cuda)
    s.run_ticks(5)
    st, topo, params = s.state, s.topology, s.current_params()
    x, msn, diag, wf, active = pd.substep_head_plain(_clone(st), topo, params, s.config, True)
    _, h2 = pd._h_h2(params)
    yk, pk = assembly.apply_system(x, st.mass, wf, h2, topo, st.sim_failed, part=True)
    yp, pp = assembly.apply_system_plain(x, st.mass, wf, h2, topo, part=True)
    assert torch.equal(yk, yp) and torch.equal(pk, pp)


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["cloth", "star", "blob"])
def test_constraint_kernels_match_twins_over_a_trajectory(cuda, scene):
    """30 ticks, kernels against twins: equal counters (floor, CG trips) and
    positions within 1e-5 (bit-equal where no bend or shape group is)."""
    runs = []
    for plain in (False, True):
        if scene == "cloth":
            s = _cloth_solver(cuda, 32)
        elif scene == "star":
            s = _star_solver(cuda)
        else:
            s = pt.Solver(pt.SolverOptions(), enable_collisions=False, device=cuda)
            s.create_shape_matching_box((0, 1.0, 0), 5, 5, 5, 1.0, (0.5, 0.0, 0.2), 4000.0)
        c = pd.new_counters(cuda)
        step.tick_n(s.state, s.topology, s.current_params(), s.config, 30, plain=plain,
                    counters=c)
        assert not s.sim_failed
        runs.append(({k: int(v) for k, v in c.items()}, s.state.positions.clone()))
    (ck, xk), (cp, xp) = runs
    assert ck == cp and ck["cg_trips"] > 0
    if scene == "star":
        assert torch.equal(xk, xp)
    else:
        assert float((xk - xp).abs().max()) <= 1e-5


# ---------------------------------------------------------------------------
# the super-body detection (T14, T15), the band form of T10, and the contact
# terms of T7 and T9 on the generic path


SUPER_WRAPPERS = (broadphase.super_broadphase, broadphase.super_narrowphase,
                  tetcols.pt_coupling_setup, tetcols.pt_force, pd.pt_tail)


def _mixed_solver(device, n_tets=512, sheet_n=24, **kw):
    """A sheet over a soup (``scene/mixed_drape.py``), its sheet low enough
    to touch the soup from the first ticks."""
    from pies_tpu_torch.scene.mixed_drape import add_mixed_drape

    s = pt.Solver(pt.SolverOptions(), device=device, allpairs_broadphase_max=0, **kw)
    add_mixed_drape(s, n_tets, sheet_n, sheet_y=2.2)
    return s


def test_cpu_tensors_take_the_super_twins():
    s = _mixed_solver("cpu", 40, 8)
    before = [f.launches for f in SUPER_WRAPPERS + GENERIC_WRAPPERS]
    s.counters = pd.new_counters("cpu")
    s.run_ticks(2)
    assert [f.launches for f in SUPER_WRAPPERS + GENERIC_WRAPPERS] == before
    assert int(s.counters["contacts"]) > 0 and not s.sim_failed


def _super_state(device, ticks=6):
    s = _mixed_solver(device)
    s.run_ticks(ticks)
    st, topo, cfg, params = s.state, s.topology, s.config, s.current_params()
    head = pd.substep_head_plain(_clone(st), topo, params, cfg, True)
    return s, head


def _super_kernels_against_twins(s, x, prev, force_rebuild):
    """T14 then T15 on ``(x, prev)`` from the solver's cache, kernels and
    twins: asserts equal cache, latches and contact lists; returns the
    rebuild flag, the contact count and the twin's work counts."""
    st, topo = s.state, s.topology
    lay = broadphase.super_layout(s.config, topo.super_corners, topo.super_adj)
    sc = broadphase.scalars(s.current_params())
    out, stats = [], {}
    for bf, nf, kw in ((broadphase.super_broadphase, broadphase.super_narrowphase, {}),
                       (broadphase.super_broadphase_plain, broadphase.super_narrowphase_plain,
                        dict(stats=stats))):
        cache = st.bp.clone()
        if force_rebuild:
            cache.fresh.zero_()
        over = torch.zeros(1, dtype=torch.int32, device=x.device)
        rebuilt = bf(x, prev, topo.super_corners, topo.super_adj, cache, lay, sc, over,
                     st.sim_failed)
        contacts = nf(x, prev, topo.super_corners, cache, lay, sc, over, st.sim_failed, **kw)
        out.append((cache, over, rebuilt, contacts))
    (ck, ok, rk, pk), (cp, op, rp, pp) = out
    for f in ("pairs", "valid", "ref", "fresh"):
        assert torch.equal(getattr(ck, f), getattr(cp, f)), f
    assert torch.equal(ok, op) and int(rk[0]) == int(rp[0])
    for a, b in zip(pk, pp):
        assert torch.equal(a, b)
    assert int(ck.valid.sum()) > 0
    return int(rk[0]), int(pk[2][0]), stats


@pytest.mark.gpu
@pytest.mark.parametrize("jitter", [0.0, 0.05], ids=["as_found", "jittered"])
@pytest.mark.parametrize("force_rebuild", [False, True], ids=["cached", "rebuild"])
def test_super_broadphase_and_narrowphase_kernels_equal_twins(cuda, force_rebuild, jitter):
    """T14 and T15 against their twins on a mixed scene with live contacts:
    equal cache, latches and contact lists; with the positions jittered,
    points cross face planes and phase 2's cubic runs."""
    s, (x, *_rest) = _super_state(cuda)
    st = s.state
    if jitter:
        rng = np.random.default_rng(1)
        x = x + torch.from_numpy((jitter * rng.standard_normal(x.shape)).astype(np.float32)
                                 ).to(cuda) * st.node_mask[:, None]
    rebuilt, n_contacts, stats = _super_kernels_against_twins(s, x, st.prev_positions,
                                                              force_rebuild)
    assert rebuilt == 1 or not (force_rebuild or jitter)
    assert n_contacts > 0
    if jitter:
        assert stats["cross_combos"] > 0


def _folded_cloth(device, n=32):
    """A pure-loose layout in self-contact: the rigged cloth (one row per
    triangle, W = 3, one face slot), its last tenth in x mirrored back over
    the part beside it, shifted off the lattice, every folded node a seeded
    distance of at most 0.2 cells above or under where it lands, before and
    now independently (points within the threshold of a face, and points
    crossing faces)."""
    from pies_tpu_torch.scene.rigged_cloth import add_rigged_cloth

    s = pt.Solver(pt.SolverOptions(), device=device, allpairs_broadphase_max=0)
    add_rigged_cloth(s, n)
    st = s.state
    sc = broadphase.scalars(s.current_params())
    xs = st.positions[:, 0]
    live = st.node_mask > 0
    edge = float(torch.quantile(xs[live], 0.9))
    over = live & (xs > edge)
    amp = min(sc.thr, 0.2 * sc.cell)
    rng = np.random.default_rng(5)
    lift = torch.from_numpy(rng.uniform(-amp, amp, (2, st.capacity)).astype(np.float32)
                            ).to(device) * over
    flat = st.positions.clone()
    flat[:, 0] = torch.where(over, 2.0 * edge - xs + 0.13 * sc.cell, xs)
    flat[:, 2] += 0.07 * sc.cell * over
    x, prev = flat.clone(), flat.clone()
    x[:, 1] += lift[0]
    prev[:, 1] += lift[1]
    return s, x, prev


def test_folded_cloth_is_in_self_contact_on_the_twins():
    """The folded pure-loose cloth on the CPU: the twins find pairs, contacts
    and crossing combos, without a latch."""
    s, x, prev = _folded_cloth("cpu")
    topo = s.topology
    lay = broadphase.super_layout(s.config, topo.super_corners, topo.super_adj)
    sc = broadphase.scalars(s.current_params())
    assert lay.kp == 0 and lay.w == 3 and lay.n_face == 1
    cache, over, stats = s.state.bp.clone(), torch.zeros(1, dtype=torch.int32), {}
    rb = broadphase.super_broadphase(x, prev, topo.super_corners, topo.super_adj, cache, lay, sc,
                                     over)
    out = broadphase.super_narrowphase_plain(x, prev, topo.super_corners, cache, lay, sc, over,
                                             stats=stats)
    assert int(rb[0]) == 1 and int(over[0]) == 0
    assert int(out[2][0]) > 0 and stats["cross_combos"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("n", [32, 128])
def test_super_kernels_equal_twins_on_a_folded_pure_loose_cloth(cuda, n):
    """T14 (rebuild forced) and T15 against their twins on the pure-loose
    layout (W = 3, one face slot, no packed row): equal cache, latches and
    contact lists, with contacts and crossing combos present."""
    s, x, prev = _folded_cloth(cuda, n)
    lay = broadphase.super_layout(s.config, s.topology.super_corners, s.topology.super_adj)
    assert lay.kp == 0 and lay.w == 3 and lay.n_face == 1
    rebuilt, n_contacts, stats = _super_kernels_against_twins(s, x, prev, True)
    assert rebuilt == 1 and n_contacts > 0 and stats["cross_combos"] > 0


@pytest.mark.gpu
def test_super_broadphase_latches_equal_twins(cuda):
    """A raw-candidate budget of 2 truncates the gather and one narrow slot
    evicts exact overlaps: kernel and twin latch alike."""
    for over_kw in ({"max_candidates_per_body": 2}, {"max_narrow_bodies": 1}):
        s = _mixed_solver(cuda, budget_overrides=over_kw)
        st, topo = s.state, s.topology
        lay = broadphase.super_layout(s.config, topo.super_corners, topo.super_adj)
        sc = broadphase.scalars(s.current_params())
        res = []
        for bf in (broadphase.super_broadphase, broadphase.super_broadphase_plain):
            cache, over = st.bp.clone(), torch.zeros(1, dtype=torch.int32, device=cuda)
            bf(st.positions, st.prev_positions, topo.super_corners, topo.super_adj, cache, lay,
               sc, over, st.sim_failed)
            res.append((cache, int(over[0])))
        assert res[0][1] == res[1][1] == 1, over_kw
        for f in ("pairs", "valid", "fresh"):
            assert torch.equal(getattr(res[0][0], f), getattr(res[1][0], f)), (over_kw, f)


@pytest.mark.gpu
def test_band_operator_and_contact_terms_equal_twins(cuda):
    """T10's band form, T7's dense operator diagonal and T9 stage 2 with the
    contact terms, against their twins on a contact-live mixed state."""
    s, (x, msn, diag, wf, active) = _super_state(cuda)
    st, topo, cfg, params = s.state, s.topology, s.config, s.current_params()
    assert topo.tet_band is not None and not tetcols.applies(st, topo, cfg)
    colls = pd.detect_point_tri(_clone(st), x, topo, params, cfg, active)
    assert int(colls.pt_count[0]) > 0
    _, h2 = pd._h_h2(params)
    dk, dp, sk, sp = diag.clone(), diag.clone(), wf.clone(), wf.clone()
    inc_k, ptd_k = tetcols.pt_coupling_setup(colls, st.mass, topo, h2, dk, wf, st.sim_failed, sk)
    inc_p, ptd_p = tetcols.pt_coupling_setup_plain(colls, st.mass, topo, h2, dp, wf,
                                                   st.sim_failed, sp)
    on = incident(inc_p)
    assert torch.equal(dk, dp) and torch.equal(sk, sp) and not torch.equal(sk, wf)
    assert torch.equal(ptd_k[on], ptd_p[on])
    yk, pk = assembly.apply_system(x, st.mass, sk, h2, topo, st.sim_failed, part=True)
    yp, pp = assembly.apply_system_plain(x, st.mass, sp, h2, topo, part=True)
    assert torch.equal(yk, yp) and torch.equal(pk, pp)
    con_k = tetcols.pt_force(x, colls, inc_k, params.collision_thickness, st.sim_failed)
    con_p = tetcols.pt_force_plain(x, colls, inc_p, params.collision_thickness)
    rows = assembly.local_step(x, st.inv_mass, st.mass, st.shape_quats.clone(), topo,
                               cfg.rotation_iterations, st.sim_failed)
    fk = assembly.assemble_force(x, msn, wf, rows, topo, 0.0, st.sim_failed,
                                 (ptd_k, con_k, inc_k.row_start, colls.pt_count))
    fp = assembly.assemble_force_plain(x, msn, wf, rows, topo, 0.0, None,
                                       (ptd_p, con_p, inc_p.row_start, colls.pt_count))
    bare = assembly.assemble_force_plain(x, msn, wf, rows, topo, 0.0)
    assert torch.equal(fk[0], fp[0]) and torch.equal(fk[1], fp[1])
    assert not torch.equal(fk[0], bare[0])


@pytest.mark.gpu
def test_super_kernels_match_twins_over_a_trajectory(cuda):
    """30 ticks of a mixed scene, kernels against twins: the same contacts,
    rebuilds and CG trips on every tick, positions within 1e-5, and every
    kernel of the path launched."""
    wrappers = SUPER_WRAPPERS + GENERIC_WRAPPERS
    runs = []
    for plain in (False, True):
        s = _mixed_solver(cuda)
        before = [f.launches for f in wrappers]
        counts = []
        for _ in range(30):
            c = pd.new_counters(cuda)
            step.tick(s.state, s.topology, s.current_params(), s.config, plain=plain,
                      counters=c)
            counts.append({k: int(v) for k, v in c.items()})
        assert not s.sim_failed
        runs.append((counts, s.state.positions.clone(),
                     [f.launches - n for f, n in zip(wrappers, before)]))
    (ck, xk, lk), (cp, xp, lp) = runs
    assert ck == cp and sum(c["contacts"] for c in ck) > 0
    assert float((xk - xp).abs().max()) <= 1e-5
    assert all(n > 0 for n in lk) and not any(lp)


# ---------------------------------------------------------------------------
# the per-triangle branches: T16 and T17

TRI_WRAPPERS = (broadphase.tri_candidates, broadphase.tri_ccd)
TRI_MODES_OFF = dict(super_k=0, super_packed_k=0, super_packed_m=0, super_packed_off=0,
                     super_live_k=0, super_faces=(), super_packed_e=0, super_loose_face=-1)


def _box_pile(device, gap=0.3, **kw):
    """``scene.contact_piles.add_box_pile``: 960 triangles, the all-pairs
    branch with the default arguments."""
    from pies_tpu_torch.scene.contact_piles import add_box_pile

    return add_box_pile(pt.Solver(pt.SolverOptions(), device=device, **kw), gap=gap)


def _mini_pile(device, n_tets=40, spread=1.0, seed=0):
    """``n_tets`` random tets of side 0.5 crowded into a box of side
    ``spread``, every node moved a little: rows with more overlaps than
    ``max_narrow_candidates``.  Returns ``(x, prev, tris, mask)``."""
    rng = np.random.default_rng(seed)
    origins = rng.uniform(0.0, spread, (n_tets, 3)).astype(np.float32)
    unit = np.float32([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]]) * np.float32(0.5)
    prev = (origins[:, None] + unit[None]).reshape(-1, 3).astype(np.float32)
    x = prev + rng.uniform(-0.05, 0.05, prev.shape).astype(np.float32)
    faces = np.int32([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]])
    tris = (np.arange(n_tets, dtype=np.int32)[:, None, None] * 4 + faces[None]).reshape(-1, 3)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t(x), t(prev), t(tris), t(np.ones(tris.shape[0], np.float32))


def _tri_kernels_against_twins(x, prev, tris, mask, params, config, mode):
    """T16 then T17 on ``(x, prev)``, kernels and twins: asserts equal
    candidate rows, counts, flag words, latch and contact lists; returns the
    flag words and the contact count."""
    lay = broadphase.tri_layout(config, tris.shape[0], mode)
    sc = broadphase.tri_scalars(params, config)
    failed = torch.zeros(2, dtype=torch.int32, device=x.device)
    out = []
    for cf, df in ((broadphase.tri_candidates, broadphase.tri_ccd),
                   (broadphase.tri_candidates_plain, broadphase.tri_ccd_plain)):
        over = torch.zeros(1, dtype=torch.int32, device=x.device)
        cand, count, flags = cf(x, prev, tris, mask, lay, sc, over, failed)
        contacts = df(x, prev, tris, cand, count, flags, lay, sc, failed)
        out.append((cand, count, flags, over, contacts))
    (ck, nk, fk, ok, pk), (cp, np_, fp, op, pp) = out
    assert torch.equal(nk, np_) and torch.equal(ck, cp)
    assert torch.equal(fk, fp) and torch.equal(ok, op)
    for a, b in zip(pk, pp):
        assert torch.equal(a, b)
    return fk.tolist(), int(pk[2][0])


def test_cpu_tensors_take_the_tri_twins():
    s = _box_pile("cpu", gap=0.05)
    assert broadphase.tri_mode(s.config, s.topology.tri_mask.shape[0]) == "allpairs"
    before = [f.launches for f in TRI_WRAPPERS + GENERIC_WRAPPERS]
    s.counters = pd.new_counters("cpu")
    s.run_ticks(2)
    assert [f.launches for f in TRI_WRAPPERS + GENERIC_WRAPPERS] == before
    assert int(s.counters["contacts"]) > 0 and not s.sim_failed


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["allpairs", "celllist"])
@pytest.mark.parametrize("n", [32, 128])
def test_tri_kernels_equal_twins_on_a_folded_cloth(cuda, mode, n):
    """The folded rigged cloth with the super-body path off, through the
    all-pairs and the cell-list branches: contacts present."""
    s, x, prev = _folded_cloth(cuda, n)
    cfg = dataclasses.replace(s.config, allpairs_broadphase_max=1 << 20 if mode == "allpairs"
                              else 0, **TRI_MODES_OFF)
    topo = s.topology
    flags, n_contacts = _tri_kernels_against_twins(x, prev, topo.triangles, topo.tri_mask,
                                                   s.current_params(), cfg, mode)
    assert n_contacts > 0 and flags[0] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["n2", "latch", "cut"])
def test_tri_kernels_equal_twins_on_a_mini_pile(cuda, case):
    """The all-pairs branch on dense mini-piles: rows past ``n1 = 32``
    overlaps (the ``n2`` width), past ``n2`` (the ``narrow_over`` latch), and
    a contact cap of 40 that cuts the list."""
    x, prev, tris, mask = _mini_pile(cuda, 40, 0.2) if case == "latch" else _mini_pile(cuda, 24)
    cap = 40 if case == "cut" else 4096
    cfg = pt.StepConfig(budget=CollisionBudget(max_point_tri_contacts=cap))
    params = pt.make_params(pt.SolverOptions(), broadphase_cell=1.0)
    flags, n_contacts = _tri_kernels_against_twins(x, prev, tris, mask, params, cfg,
                                                   "allpairs")
    assert bool(flags[4]) == (case == "latch")
    assert n_contacts == 40 if case == "cut" else n_contacts > 0


@pytest.mark.gpu
@pytest.mark.parametrize("move", [0.0, 0.07])
def test_tri_kernels_equal_twins_on_bodies(cuda, move):
    """The per-body branch: the 96-tet contact soup with ``body_nodes = 0``,
    as built and moved (the ``exact_over`` latch)."""
    s = pt.Solver(pt.SolverOptions(), device=cuda)
    s.create_tet_soup(96, **CONTACT_SCENE)
    cfg = dataclasses.replace(s.config, body_nodes=0, body_node_offset=0, body_faces=())
    st, topo = s.state, s.topology
    rng = np.random.default_rng(4)
    x = st.positions + torch.from_numpy(
        rng.uniform(-move, move, (st.capacity, 3)).astype(np.float32)).to(cuda) * st.node_mask[:, None]
    flags, n_contacts = _tri_kernels_against_twins(x, st.prev_positions, topo.triangles,
                                                   topo.tri_mask, s.current_params(), cfg,
                                                   "bodies")
    assert n_contacts > 0 and bool(flags[3]) == (move > 0.05)


@pytest.mark.gpu
@pytest.mark.parametrize("quirks", [True, False])
def test_tri_kernels_equal_twins_in_reference_mode(cuda, quirks):
    """The reference sweep on the box pile with gaps of 0.05 (inside the CCD
    threshold), every node moved a little, with world-unit cells and with
    ``grid_spacing`` cells."""
    s = _box_pile(cuda, gap=0.05, broadphase_mode="reference", reference_quirks=quirks)
    st, topo = s.state, s.topology
    rng = np.random.default_rng(3)
    x = st.positions + torch.from_numpy(
        rng.uniform(-0.02, 0.02, (st.capacity, 3)).astype(np.float32)).to(cuda) * st.node_mask[:, None]
    flags, n_contacts = _tri_kernels_against_twins(x, st.prev_positions, topo.triangles,
                                                   topo.tri_mask, s.current_params(), s.config,
                                                   "reference")
    assert n_contacts > 0


@pytest.mark.gpu
def test_tri_kernels_on_a_failed_state_write_empty_outputs(cuda):
    x, prev, tris, mask = _mini_pile(cuda, 24)
    cfg = pt.StepConfig()
    params = pt.make_params(pt.SolverOptions(), broadphase_cell=1.0)
    lay = broadphase.tri_layout(cfg, tris.shape[0], "allpairs")
    sc = broadphase.tri_scalars(params, cfg)
    failed = torch.ones(2, dtype=torch.int32, device=cuda)
    over = torch.zeros(1, dtype=torch.int32, device=cuda)
    cand, count, flags = broadphase.tri_candidates(x, prev, tris, mask, lay, sc, over, failed)
    pt_idx, pt_mask, pt_count = broadphase.tri_ccd(x, prev, tris, cand, count, flags, lay, sc,
                                                   failed)
    assert not cand.any() and not count.any() and not flags.any() and not over.any()
    assert not pt_idx.any() and not pt_mask.any() and int(pt_count[0]) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["celllist", "reference"], ids=["allpairs", "reference"])
def test_tri_kernels_match_twins_over_a_trajectory(cuda, mode):
    """40 ticks of the box pile with the default arguments (all-pairs; with
    ``broadphase_mode="reference"`` the reference sweep), kernels against
    twins: the same contacts and CG trips on every tick, positions within
    1e-5, and every kernel of the path launched (the boxes have distance
    constraints and no tets)."""
    wrappers = TRI_WRAPPERS + (pd.substep_head, proj.distance_rows, assembly.assemble_force,
                               assembly.apply_system, assembly.pcg_solve, pd.substep_tail)
    runs = []
    for plain in (False, True):
        s = _box_pile(cuda, broadphase_mode=mode)
        before = [f.launches for f in wrappers]
        counts = []
        for _ in range(40):
            c = pd.new_counters(cuda)
            step.tick(s.state, s.topology, s.current_params(), s.config, plain=plain,
                      counters=c)
            counts.append({k: int(v) for k, v in c.items()})
        assert not s.sim_failed
        runs.append((counts, s.state.positions.clone(),
                     [f.launches - n for f, n in zip(wrappers, before)]))
    (ck, xk, lk), (cp, xp, lp) = runs
    assert ck == cp and sum(c["contacts"] for c in ck) > 0
    assert float((xk - xp).abs().max()) <= 1e-5
    assert all(n > 0 for n in lk) and not any(lp)


# ---------------------------------------------------------------------------
# T18-T21: the PBD solver

from pies_tpu_torch.solver import pbd  # noqa: E402

PBD = pt.SolverOptions(solver=pt.SolverName.PBD)
PBD_WRAPPERS = (pbd.substep_head, proj.jacobi_rows, pbd.apply_jacobi, pbd.chain_scan,
                pbd.floor_clamp, pbd.substep_tail, broadphase.node_pairs,
                broadphase.node_response)


def _pbd_scene(device, scene, **kw):
    s = pt.Solver(PBD, device=device, **kw)
    if scene == "ropes":  # two lengths: the shorter chain has padding links
        s.create_rope((0.0, 8.0, 0.0), (12.0, 8.0, 0.0), 128, w=0.9)
        s.create_rope((0.0, 8.0, 0.7), (9.0, 8.0, 0.7), 97, w=0.9)
    elif scene == "pile":
        rng = np.random.default_rng(3)
        s.add_nodes(rng.uniform([-4, 0.5, -4], [4, 6.0, 4], (8192, 3)).astype(np.float32))
    elif scene == "net":
        s.create_sheet((0.0, 3.0, 0.0), 1.0, 1.0, 0.5)
    elif scene == "tet_box":
        s.create_tet_box((0.0, 3.0, 0.0), 1.0, (0, 0, 0), w=0.1, mass=1.0)
    else:
        s.create_bend_sheet((0, 2.0, 0), 0.5, w=0.1)
    s._prepare()
    return s


def _jittered(s, seed=7, scale=0.05):
    n = s._builder.num_nodes
    x = s.state.positions.clone()
    x[:n] += torch.from_numpy(np.random.default_rng(seed).normal(0.0, scale, (n, 3))
                              .astype(np.float32)).to(x.device)
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("kind,scene,quirks", [
    ("position", "ropes", True), ("distance", "net", True), ("strain", "tet_box", True),
    ("strain", "tet_box", False), ("bend", "bend_sheet", True)])
def test_pbd_rows_and_apply_match_twins(cuda, kind, scene, quirks):
    """T18: a family's rows equal the twin's (the bend rows within 1e-6 of
    the largest, through acosf), and the count-averaged application of the
    same rows is exact."""
    s = _pbd_scene(cuda, scene, enable_collisions=False, reference_quirks=quirks)
    st, topo, x = s.state, s.topology, _jittered(s)
    batch = getattr(topo, kind)
    vk = proj.jacobi_rows(kind, x, st.inv_mass, batch, recenter=not quirks,
                          failed=st.sim_failed)
    vp = proj.jacobi_rows_plain(kind, x, st.inv_mass, batch, recenter=not quirks)
    tol = 1e-6 * float(vp.abs().max()) if kind == "bend" else 0.0
    assert float((vk - vp).abs().max()) <= tol and float(vp[:, 3].sum()) > 0
    xk, xp = x.clone(), x.clone()
    pbd.apply_jacobi(xk, getattr(topo.jacobi, kind), vp, st.sim_failed)
    pbd.apply_jacobi_plain(xp, getattr(topo.jacobi, kind), vp)
    assert torch.equal(xk, xp) and not torch.equal(xk, x)


@pytest.mark.gpu
def test_pbd_head_floor_tail_exact(cuda):
    """T18's head, floor clamp and tail equal their twins bit for bit."""
    s = _pbd_scene(cuda, "pile", enable_collisions=False)
    params = s.current_params()
    a, b = _clone(s.state), _clone(s.state)
    a.velocities.copy_(torch.randn_like(a.velocities) * 5.0 * a.node_mask[:, None])
    b.velocities.copy_(a.velocities)
    pbd.substep_head(a, params, True)
    pbd.substep_head_plain(b, params, True)
    assert torch.equal(a.positions, b.positions) and torch.equal(a.prev_positions,
                                                                 b.prev_positions)
    a.positions[:, 1] -= 0.6  # some nodes under the floor
    b.positions.copy_(a.positions)
    pbd.floor_clamp(a.positions, a.radius, a.node_mask, params.floor_height, a.sim_failed)
    pbd.floor_clamp_plain(b.positions, b.radius, b.node_mask, params.floor_height)
    assert torch.equal(a.positions, b.positions)
    x = a.positions + 0.01
    pbd.substep_tail(a, x.clone(), params)
    pbd.substep_tail_plain(b, x.clone(), params)
    for f in ("positions", "prev_positions", "velocities", "sim_failed"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.gpu
def test_pbd_sequential_distance_kernels(cuda):
    """T19: the chain walk and the colour classes equal their twins.  A
    padding link (w = 0, the shorter rope's tail) writes nothing in the
    kernel, where the twin, as the JAX package, adds its zero delta to node
    0; the two agree (+0.0 == -0.0)."""
    s = _pbd_scene(cuda, "ropes", enable_collisions=False)
    ch = s.topology.chains
    assert s.config.distance_chain and float((ch.w == 0).sum()) > 0
    x = _jittered(s)
    xk, xp = x.clone(), x.clone()
    pbd.chain_scan(xk, ch, s.state.sim_failed)
    pbd.chain_scan_plain(xp, ch)
    assert torch.equal(xk, xp) and not torch.equal(xk, x)
    s = _pbd_scene(cuda, "net", enable_collisions=False)
    assert len(s.config.distance_colors) > 1
    x = _jittered(s)
    xk, xp = x.clone(), x.clone()
    pbd.color_classes(xk, s.topology.distance, s.config.distance_colors, s.state.sim_failed)
    pbd.color_classes_plain(xp, s.topology.distance, s.config.distance_colors)
    assert torch.equal(xk, xp) and not torch.equal(xk, x)


@pytest.mark.gpu
def test_node_pair_kernels_match_twins(cuda):
    """T20 and T21 on the 8,192-node pile: the rebuild, the pair prefix,
    count and incidence equal; the response bit-equal with the same
    touching count; a drift under the slack keeps the cache, one past it
    rebuilds."""
    s = _pbd_scene(cuda, "pile", enable_collisions=True)
    st, params, cfg = s.state, s.current_params(), s.config
    ck, cp = st.nn.clone(), st.nn.clone()
    x = st.positions
    args = (st.radius, st.node_mask)
    rk = broadphase.node_pairs(x, *args, ck, params, cfg, st.sim_failed)
    rp = broadphase.node_pairs_plain(x, *args, cp, params, cfg, st.sim_failed)
    c = int(cp.count[0])
    assert int(rk[0]) == int(rp[0]) == 1 and int(ck.count[0]) == c > 1000
    for f in ("pi", "pj", "inc_pair"):
        assert torch.equal(getattr(ck, f)[:c], getattr(cp, f)[:c]), f
    for f in ("row_off", "inc_start", "ref", "fresh"):
        assert torch.equal(getattr(ck, f), getattr(cp, f)), f
    vel = torch.randn_like(st.velocities)
    out_k = broadphase.node_response(x, vel, st.radius, st.inv_mass, st.node_mask, ck, params,
                                     st.sim_failed)
    out_p = broadphase.node_response_plain(x, vel, st.radius, st.inv_mass, st.node_mask, cp,
                                           params, st.sim_failed)
    assert torch.equal(out_k[0], out_p[0]) and torch.equal(out_k[1], out_p[1])
    assert int(out_k[2][0]) == int(out_p[2][0]) > 0
    small = x + 0.4
    assert int(broadphase.node_pairs(small, *args, ck, params, cfg, st.sim_failed)[0]) == 0
    big = x.clone()
    big[5, 0] += 0.6
    assert int(broadphase.node_pairs(big, *args, ck, params, cfg, st.sim_failed)[0]) == 1
    assert torch.equal(ck.ref, big)


@pytest.mark.gpu
def test_uncached_node_response_launches_the_kernels(cuda):
    """A state on the card without a pair cache (``nn`` None, the JAX
    package's uncached form) rebuilds through T20 and responds through T21
    on every iteration, with the twins' counters and positions within
    1e-5."""
    pair_wrappers = (broadphase.node_pairs, broadphase.node_response)
    runs = []
    for plain in (False, True):
        s = _pbd_scene(cuda, "pile", enable_collisions=True)
        s.state.nn = None
        before = [f.launches for f in pair_wrappers]
        counts = []
        for _ in range(5):
            c = pbd.new_counters(cuda)
            step.tick(s.state, s.topology, s.current_params(), s.config, plain=plain,
                      counters=c)
            counts.append({k: int(v) for k, v in c.items()})
        assert not s.sim_failed
        runs.append((counts, s.state.positions.clone(),
                     [f.launches - n for f, n in zip(pair_wrappers, before)]))
    (ck, xk, lk), (cp, xp, lp) = runs
    per_tick = s.config.iterations * s.config.time_substeps
    assert ck == cp and all(c["rebuilds"] == per_tick for c in ck)
    assert sum(c["touching"] for c in ck) > 0
    assert float((xk - xp).abs().max()) <= 1e-5
    assert lk == [5 * per_tick] * 2 and not any(lp)


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["ropes", "pile"])
def test_pbd_kernels_match_twins_over_a_trajectory(cuda, scene):
    """30 ticks with collisions on, kernels against twins: the same
    counters on every tick (pairs, touching pairs, rebuilds, floor nodes),
    positions within 1e-5, every kernel of the path launched; the pile's
    nodes touch (the two ropes' do not in 30 ticks)."""
    skip = () if scene == "ropes" else (proj.jacobi_rows, pbd.apply_jacobi, pbd.chain_scan)
    wrappers = tuple(f for f in PBD_WRAPPERS if f not in skip)
    runs = []
    for plain in (False, True):
        s = _pbd_scene(cuda, scene, enable_collisions=True)
        before = [f.launches for f in wrappers]
        counts = []
        for _ in range(30):
            c = pbd.new_counters(cuda)
            step.tick(s.state, s.topology, s.current_params(), s.config, plain=plain,
                      counters=c)
            counts.append({k: int(v) for k, v in c.items()})
        assert not s.sim_failed
        runs.append((counts, s.state.positions.clone(),
                     [f.launches - n for f, n in zip(wrappers, before)]))
    (ck, xk, lk), (cp, xp, lp) = runs
    assert ck == cp and sum(c["pairs"] for c in ck) > 0
    assert scene == "ropes" or sum(c["touching"] for c in ck) > 0
    assert float((xk - xp).abs().max()) <= 1e-5
    assert all(n > 0 for n in lk) and not any(lp)


# ---------------------------------------------------------------------------
# full contact coupling (T23), the block preconditioner (T22) and the
# entry-list floor (T24)


COUPLING_WRAPPERS = (assembly.tet_block_factor, pd.floor_entries, assembly.pt_full)


def _coupling_solver(device, scene):
    """The scenes of ``tests/coupling_scenes.py`` at the kernels' test
    sizes: a soup under full coupling or off the tet-column path, a tet box
    on the entry-list floor, and a sheet over a soup under full coupling."""
    if scene in ("soup_full", "soup_block"):
        s = pt.Solver(pt.SolverOptions(), device=device,
                      contact_coupling="full" if scene == "soup_full" else "recentered")
        s.create_tet_soup(96, **CONTACT_SCENE)
    elif scene == "box_entry":
        s = pt.Solver(pt.SolverOptions(), enable_collisions=False, device=device)
        s.create_tet_box((0.0, 0.5, 0.0), 1.0, (0, 0, 0), w=1500.0, mass=1.0)
    else:
        s = _mixed_solver(device, contact_coupling="full")
    s._prepare()
    if scene == "soup_block":
        s._config = dataclasses.replace(s.config, tet_cols=False)
    if scene == "box_entry":
        s._config = dataclasses.replace(s.config, dense_floor=False)
    return s


def test_cpu_tensors_take_the_coupling_twins():
    """Full coupling, the block preconditioner and the entry-list floor on
    CPU tensors take the twins: no launch is counted."""
    for scene in ("soup_full", "box_entry"):
        s = _coupling_solver("cpu", scene)
        before = [f.launches for f in COUPLING_WRAPPERS + GENERIC_WRAPPERS]
        s.run_ticks(2)
        assert [f.launches for f in COUPLING_WRAPPERS + GENERIC_WRAPPERS] == before
        assert not s.sim_failed


def _generic_head(s):
    """The generic path's substep inputs on the solver's state (twins):
    the head, the entry-list floor, the contacts and T7's setup.  Returns
    ``wf`` as the operator's dense diagonal: the floor weight, plus the
    contacts' diagonal unless the coupling is full."""
    st, topo, cfg, params = s.state, s.topology, s.config, s.current_params()
    x, msn, diag, wf, active = pd.substep_head_plain(_clone(st), topo, params, cfg, True)
    floor = None
    if not cfg.dense_floor:
        wf, floor = pd.floor_entries_plain(x, topo, params, cfg, diag)
    colls = inc = full = None
    if cfg.enable_collisions:
        colls = pd.detect_point_tri(_clone(st), x, topo, params, cfg, active, plain=True)
        _, h2 = pd._h_h2(params)
        if cfg.contact_coupling == "full":
            inc, _ = tetcols.pt_coupling_setup_plain(colls, st.mass, topo, h2, diag, wf)
            full = assembly.FullCoupling(colls, inc, params.collision_thickness)
        else:
            sd = wf.clone()
            tetcols.pt_coupling_setup_plain(colls, st.mass, topo, h2, diag, wf,
                                            static_diag=sd)
            wf = sd
    return x, msn, diag, wf, floor, colls, full


@pytest.mark.gpu
def test_tet_block_factor_and_block_pcg_equal_twins(cuda):
    """T22's factor and T11 with the block solve, on the soup off the
    tet-column path with live contacts: equal factors, solution, residual
    partials and trips (one: the preconditioner is exact)."""
    s = _coupling_solver(cuda, "soup_block")
    s.run_ticks(36)
    st, topo, params = s.state, s.topology, s.current_params()
    x, msn, diag, wf, _, colls, _ = _generic_head(s)
    assert int(colls.pt_count[0]) > 0
    fk = assembly.tet_block_factor(diag, topo.tet_block6, st.sim_failed)
    fp = assembly.tet_block_factor_plain(diag, topo.tet_block6)
    assert torch.equal(fk, fp)
    _, h2 = pd._h_h2(params)
    b = assembly.apply_system_plain(x, st.mass, wf, h2, topo)[0] + 7.0
    args = (b, x, diag, st.mass, wf, h2, st.node_mask, topo, 16, 1e-4, st.sim_failed, fk)
    xk, rk, tk = assembly.pcg_solve(*args)
    xp, rp, tp = assembly.pcg_solve_plain(*args)
    assert torch.equal(xk, xp) and torch.equal(rk, rp) and torch.equal(tk, tp)
    assert int(tk[0]) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["soup_full", "mixed_full"])
def test_full_coupling_terms_equal_twins(cuda, scene):
    """T23 inside T10 (the contacts' blocks, beside the band and the ELL)
    and inside T9's stage 2 (the stacked force), and the PCG over it: equal
    to the twins on a state with live contacts."""
    s = _coupling_solver(cuda, scene)
    s.run_ticks(36 if scene == "soup_full" else 6)
    st, topo, params, cfg = s.state, s.topology, s.current_params(), s.config
    x, msn, diag, wf, _, colls, full = _generic_head(s)
    assert int(colls.pt_count[0]) > 0
    _, h2 = pd._h_h2(params)
    before = assembly.pt_full.launches
    yk, pk = assembly.apply_system(x, st.mass, wf, h2, topo, st.sim_failed, part=True,
                                   full=full)
    yp, pp = assembly.apply_system_plain(x, st.mass, wf, h2, topo, part=True, full=full)
    assert torch.equal(yk, yp) and torch.equal(pk, pp)
    bare, _ = assembly.apply_system_plain(x, st.mass, wf, h2, topo)
    assert not torch.equal(bare, yp)
    rows = assembly.local_step(x, st.inv_mass, st.mass, st.shape_quats, topo,
                               cfg.rotation_iterations, st.sim_failed, plain=True)
    plane = pd.floor_plane(params, cfg.reference_quirks)
    fk, sk = assembly.assemble_force(x, msn, wf, rows, topo, plane, st.sim_failed, None, full)
    fp, sp = assembly.assemble_force_plain(x, msn, wf, rows, topo, plane, None, None, full)
    assert torch.equal(fk, fp) and torch.equal(sk, sp)
    block = (assembly.tet_block_factor_plain(diag, topo.tet_block6)
             if pd.block_layout(st, topo) else None)
    args = (fk, x, diag, st.mass, wf, h2, st.node_mask, topo, 16, 1e-4, st.sim_failed, block,
            full)
    xk, rk, tk = assembly.pcg_solve(*args)
    xp, rp, tp = assembly.pcg_solve_plain(*args)
    assert torch.equal(xk, xp) and torch.equal(rk, rp) and torch.equal(tk, tp)
    assert assembly.pt_full.launches > before


@pytest.mark.gpu
def test_floor_entry_kernels_equal_twins(cuda):
    """T24 (the corner entries, weights, counts and snap flags, the
    diagonal), T9's stage 2 with the entry-list floor and T4 with its
    counts, on the box on the floor: equal to the twins, and the per-node
    values the dense floor's."""
    s = _coupling_solver(cuda, "box_entry")
    s.run_ticks(30)
    st, topo, params, cfg = s.state, s.topology, s.current_params(), s.config
    x, msn, diag, wf, active = pd.substep_head(_clone(st), topo, params, cfg, True)
    xp_, _, diag_p, _, _ = pd.substep_head_plain(_clone(st), topo, params, cfg, True)
    assert torch.equal(x, xp_) and torch.equal(diag, diag_p)
    dk, dp = diag.clone(), diag.clone()
    wk, fk = pd.floor_entries(x, topo, params, cfg, dk, st.sim_failed)
    wp, fp = pd.floor_entries_plain(x, topo, params, cfg, dp)
    assert torch.equal(dk, dp) and torch.equal(wk, wp)
    for f in ("static_idx", "static_mask", "floor_active", "floor_counts"):
        assert torch.equal(getattr(fk, f), getattr(fp, f)), f
    assert int(fk.static_mask.sum()) > 0
    dense = dataclasses.replace(cfg, dense_floor=True)
    hd = pd.substep_head_plain(_clone(st), topo, params, dense, True)
    assert torch.equal(fk.floor_active, hd[4]) and torch.equal(wk, hd[3])
    rows = assembly.local_step(x, st.inv_mass, st.mass, st.shape_quats, topo,
                               cfg.rotation_iterations, st.sim_failed, plain=True)
    plane = pd.floor_plane(params, cfg.reference_quirks)
    ak = assembly.assemble_force(x, msn, wk, rows, topo, plane, st.sim_failed, floor=fk)
    ap = assembly.assemble_force_plain(x, msn, wk, rows, topo, plane, floor=fp)
    assert torch.equal(ak[0], ap[0]) and torch.equal(ak[1], ap[1])
    a, b = _clone(st), _clone(st)
    pd.substep_tail(a, topo, params, fk.floor_active, x, ak[1], floor_counts=fk.floor_counts)
    pd.substep_tail_plain(b, topo, params, fp.floor_active, x, ak[1],
                          floor_counts=fp.floor_counts)
    for f in ("positions", "prev_positions", "velocities", "forces", "sim_failed"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["soup_full", "soup_block", "box_entry", "mixed_full"])
def test_coupling_paths_match_twins_over_a_trajectory(cuda, scene):
    """40 ticks, kernels against twins: equal counters (floor, contacts, CG
    trips), positions within 1e-5, and every new kernel of the scene's path
    launched."""
    runs = []
    for plain in (False, True):
        s = _coupling_solver(cuda, scene)
        before = [f.launches for f in COUPLING_WRAPPERS]
        c = pd.new_counters(cuda)
        step.tick_n(s.state, s.topology, s.current_params(), s.config, 40, plain=plain,
                    counters=c)
        assert not s.sim_failed
        runs.append(({k: int(v) for k, v in c.items()}, s.state.positions.clone(),
                     [f.launches - b for f, b in zip(COUPLING_WRAPPERS, before)]))
    (ck, xk, lk), (cp, xp, lp) = runs
    assert ck == cp and ck["floor_active"] > 0
    assert float((xk - xp).abs().max()) <= 1e-5
    assert lp == [0, 0, 0]
    want = {"soup_full": [1, 0, 1], "soup_block": [1, 0, 0], "box_entry": [0, 1, 0],
            "mixed_full": [0, 0, 1]}[scene]
    assert [int(n > 0) for n in lk] == want


# ---------------------------------------------------------------------------
# edge-edge and PD node-node contacts: T25 (the edge CCD), T26 (the edge
# terms, inside T8, T9's stage 2 and T10) and T27 (the node pairs' setup,
# friction and force inside T9's stage 2)

EDGE_NODE_WRAPPERS = (broadphase.edge_ccd, assembly.edge_terms, assembly.node_terms)


def _nets_solver(device, nn=8, coupling="full", quirks=False, caps=2048):
    from pies_tpu_torch.scene.edge_nets import add_crossing_nets, solver_args

    kw = solver_args(caps)
    kw.update(contact_coupling=coupling, reference_quirks=quirks)
    s = pt.Solver(pt.SolverOptions(solver=pt.SolverName.PD), device=device, **kw)
    return add_crossing_nets(s, nn)


def _cloud_solver(device, n=4096, cap=1 << 17):
    from pies_tpu_torch.scene.pbd_scenes import add_node_pile

    s = pt.Solver(pt.SolverOptions(solver=pt.SolverName.PD), enable_collisions=False,
                  enable_node_collisions=True,
                  budget_overrides=dict(max_node_node_contacts=cap), device=device)
    return add_node_pile(s, n)


def _until_contacts(s, least, limit=120):
    """Tick ``s`` until its next substep has at least ``least`` edge
    contacts; returns the ticks run."""
    for t in range(limit):
        s.run_ticks(1)
        if int(_edge_inputs(s)[-1].edge_count[0]) >= least:
            return t + 1
    raise AssertionError("too few edge contacts")


def _until_active(s, limit=120):
    """Tick ``s`` until its next substep's edge contacts include one within
    the thickness (its projection and stabilization move nodes); returns
    the ticks run."""
    from pies_tpu_torch.collision.batches import edge_closest_disp

    for t in range(limit):
        s.run_ticks(1)
        c, x, _, _, _, colls = _edge_inputs(s)
        idx = colls.edge_idx[: int(colls.edge_count[0])].long()
        active, _, _ = edge_closest_disp(x[idx], c.inv_mass[idx],
                                         s.current_params().collision_thickness,
                                         s.config.reference_quirks)
        if bool(active.any()):
            return t + 1
    raise AssertionError("no active edge contact")


def _edge_inputs(s, plain=True):
    """The generic path's substep inputs with this substep's point-triangle
    and edge contacts (twins, or kernels with ``plain=False``)."""
    st, topo, cfg, params = s.state, s.topology, s.config, s.current_params()
    c = _clone(st)
    x, msn, diag, wf, active = pd.substep_head_plain(c, topo, params, cfg, True)
    colls = pd.detect_point_tri(c, x, topo, params, cfg, active, plain=True)
    out = broadphase.detect_edge_edge_collisions(x, c.prev_positions, topo.triangles,
                                                 topo.tri_mask, params, cfg, colls.overflow,
                                                 c.sim_failed, plain=plain)
    colls.edge_idx, colls.edge_mask, colls.edge_count, colls.edge_hits = out
    return c, x, msn, diag, wf, colls


@pytest.mark.gpu
@pytest.mark.parametrize("quirks", [False, True], ids=["fixed", "quirks"])
def test_edge_ccd_matches_twin(cuda, quirks):
    """T25 on the nets once they have more than 8 edge contacts, with and
    without the quirks: the contacts, their order, the count and the hits
    before the cap equal the twin's; with a cap of 8 the truncated prefix
    too."""
    s = _nets_solver(cuda, quirks=quirks)
    _until_contacts(s, 9)
    st, topo, cfg, params = s.state, s.topology, s.config, s.current_params()
    x = st.positions + 0.012 * st.velocities
    lay = broadphase.tri_layout(cfg, topo.triangles.shape[0], "celllist")
    sc = broadphase.scalars(params)
    ov = torch.zeros(1, dtype=torch.int32, device=cuda)
    cand, count, flags = broadphase.tri_candidates(x, st.prev_positions, topo.triangles,
                                                   topo.tri_mask, lay, sc, ov, st.sim_failed)
    for cap in (cfg.budget.max_edge_contacts, 8):
        before = broadphase.edge_ccd.launches
        k = broadphase.edge_ccd(x, st.prev_positions, topo.triangles, cand, count, flags, cap,
                                quirks, st.sim_failed)
        p = broadphase.edge_ccd_plain(x, st.prev_positions, topo.triangles, cand, count, flags,
                                      cap, quirks, st.sim_failed)
        assert broadphase.edge_ccd.launches == before + 1
        for a, b in zip(k, p):
            assert torch.equal(a, b)
        assert int(k[3][0]) > 0 and int(k[2][0]) == min(int(k[3][0]), cap)


@pytest.mark.gpu
@pytest.mark.parametrize("coupling", ["full", "recentered"])
def test_edge_terms_equal_twins(cuda, coupling):
    """T26's setup (incidence, the edges' diagonal, the system and operator
    diagonals), its terms in T9's stage 2 and T10, and T8's stabilization
    with its pass, on the nets with live edge and point-triangle contacts:
    equal to the twins."""
    s = _nets_solver(cuda, coupling=coupling)
    _until_active(s)
    st, topo, cfg, params = s.state, s.topology, s.config, s.current_params()
    c, x, msn, diag, wf, colls = _edge_inputs(s)
    assert int(colls.edge_count[0]) > 0
    _, h2 = pd._h_h2(params)
    full = coupling == "full"
    out = []
    for setup in (assembly.edge_setup, assembly.edge_setup_plain):
        dg, sd = diag.clone(), wf.clone()
        e = setup(colls, st.mass, st.inv_mass, topo, h2, dg, wf, params.collision_thickness,
                  False, full, st.sim_failed, sd)
        out.append((e, dg, sd))
    (ek, dk, sk), (ep, dp, sp) = out
    live = int(ep.inc.row_start[-1])
    assert torch.equal(ek.inc.row_start, ep.inc.row_start)
    assert torch.equal(ek.inc.entries[:live], ep.inc.entries[:live])
    on = incident(ep.inc)
    assert torch.equal(ek.ed[on], ep.ed[on]) and torch.equal(dk, dp) and torch.equal(sk, sp)
    rows = assembly.local_step(x, st.inv_mass, st.mass, st.shape_quats, topo,
                               cfg.rotation_iterations, st.sim_failed, plain=True)
    plane = pd.floor_plane(params, cfg.reference_quirks)
    fk = assembly.assemble_force(x, msn, sp, rows, topo, plane, st.sim_failed, edges=ek)
    fp = assembly.assemble_force_plain(x, msn, sp, rows, topo, plane, edges=ep)
    assert torch.equal(fk[0], fp[0]) and torch.equal(fk[1], fp[1])
    yk, _ = assembly.apply_system(x, st.mass, sp, h2, topo, st.sim_failed, edges=ek)
    yp, _ = assembly.apply_system_plain(x, st.mass, sp, h2, topo, edges=ep)
    assert torch.equal(yk, yp)
    edges_only = dataclasses.replace(colls, pt_idx=None)
    a, b = _clone(c), _clone(c)
    xa, xb = x.clone(), x.clone()
    pd.pt_tail(a, params, cfg, edges_only, None, xa, fk[1], ek, None, pd.STABILIZE)
    pd.pt_tail_plain(b, params, cfg, edges_only, None, xb, fk[1], ep, None, pd.STABILIZE)
    assert torch.equal(xa, xb) and torch.equal(a.prev_positions, b.prev_positions)
    assert not torch.equal(xa, x)


@pytest.mark.gpu
def test_node_contact_kernels_equal_twins(cuda):
    """T20's fresh pair prefix, T27's setup and friction, its force in T9's
    stage 2 and T4 with its impulse, on a PD node cloud with a cap below the
    pair count: equal to the twins."""
    s = _cloud_solver(cuda, cap=1024)
    s.run_ticks(3)
    st, topo, cfg, params = s.state, s.topology, s.config, s.current_params()
    x, msn, diag, wf, active = pd.substep_head_plain(_clone(st), topo, params, cfg, True)
    nk = broadphase.detect_node_node_pairs(x, st.radius, st.node_mask, params, cfg,
                                           st.sim_failed)
    np_ = broadphase.detect_node_node_pairs(x, st.radius, st.node_mask, params, cfg,
                                            st.sim_failed, plain=True)
    count = int(np_.count[0])
    assert int(nk.count[0]) == count > 1024
    for f in ("pi", "pj"):
        assert torch.equal(getattr(nk, f)[:count], getattr(np_, f)[:count])
    _, h2 = pd._h_h2(params)
    out = []
    for setup, nn in ((assembly.node_setup, nk), (assembly.node_setup_plain, np_)):
        dg, sd = diag.clone(), wf.clone()
        t = setup(nn, 1024, st.mass, st.radius, st.inv_mass, topo, h2, dg, wf, st.sim_failed,
                  sd)
        out.append((t, dg, sd))
    (tk, dk, sk), (tp, dp, sp) = out
    assert int(tk.lim[0]) == int(tp.lim[0]) == 1024
    assert torch.equal(dk, dp) and torch.equal(sk, sp)
    rows = assembly.local_step(x, st.inv_mass, st.mass, st.shape_quats, topo,
                               cfg.rotation_iterations, st.sim_failed, plain=True)
    plane = pd.floor_plane(params, cfg.reference_quirks)
    fk = assembly.assemble_force(x, msn, sp, rows, topo, plane, st.sim_failed, nodes=tk)
    fp = assembly.assemble_force_plain(x, msn, sp, rows, topo, plane, nodes=tp)
    assert torch.equal(fk[0], fp[0])
    ik, ck = pd.node_friction(x, st, params, tk, st.sim_failed)
    ip, cp = pd.node_friction_plain(x, st, params, tp, st.sim_failed)
    assert torch.equal(ik, ip) and torch.equal(ck, cp) and int(ck[0]) > 0
    a, b = _clone(st), _clone(st)
    pd.substep_tail(a, topo, params, active, x, fk[1], nn_imp=ik)
    pd.substep_tail_plain(b, topo, params, active, x, fk[1], nn_imp=ip)
    for f in ("positions", "prev_positions", "velocities", "forces", "sim_failed"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["nets_full", "nets_recentered", "cloud"])
def test_edge_node_paths_match_twins_over_a_trajectory(cuda, scene):
    """Ticks through the contacts, kernels against twins: equal counters,
    positions within 1e-5, and T25-T27 launched on their scene's path."""
    runs = []
    for plain in (False, True):
        s = (_cloud_solver(cuda) if scene == "cloud"
             else _nets_solver(cuda, coupling=scene.split("_")[1]))
        ticks = 20 if scene == "cloud" else 55
        before = [f.launches for f in EDGE_NODE_WRAPPERS]
        c = pd.new_counters(cuda)
        step.tick_n(s.state, s.topology, s.current_params(), s.config, ticks, plain=plain,
                    counters=c)
        assert not s.sim_failed
        runs.append(({k: int(v) for k, v in c.items()}, s.state.positions.clone(),
                     [f.launches - b for f, b in zip(EDGE_NODE_WRAPPERS, before)]))
    (ck, xk, lk), (cp, xp, lp) = runs
    assert ck == cp
    assert float((xk - xp).abs().max()) <= 1e-5
    assert lp == [0, 0, 0]
    if scene == "cloud":
        assert ck["node_pairs"] > 0 and ck["touching_pairs"] > 0 and lk == [0, 0, lk[2]] \
            and lk[2] > 0
    else:
        assert ck["edge_contacts"] > 0 and lk[0] > 0 and lk[1] > 0 and lk[2] == 0


def test_every_entry_point_has_its_signature():
    """Each ``extern "C"`` entry point of ``csrc`` has its ctypes argument
    list in ``kernels.SIGNATURES``, of its length (without one ctypes
    passes a pointer as a 32-bit int)."""
    import re

    from pies_tpu_torch import kernels

    found = {}
    for src in kernels._CSRC.glob("*.cu"):
        for name, args in re.findall(r'extern "C" int (pies_\w+)\(([^)]*)\)',
                                     src.read_text()):
            found[name] = len([a for a in args.split(",") if a.strip()])
    assert found and set(found) == set(kernels.SIGNATURES)
    for name, n in found.items():
        assert len(kernels.SIGNATURES[name]) == n, name
