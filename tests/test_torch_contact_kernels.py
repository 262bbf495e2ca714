"""The main path's point-triangle kernels T5 (the packed-body broadphase),
T6 (narrowphase), T7 (coupling), T2's contact substep and T8 (the tail)
against their plain twins, bit for bit, in every branch of their design.

This file imports nothing of JAX or of the JAX package.  On a GPU machine:

    python -m pytest -m gpu tests/test_torch_contact_kernels.py -q

Tests marked ``gpu`` skip without a CUDA device.  T6 is one cooperative
launch whose blocks each own a range of lanes and sweep it 4,096 lanes at a
time, with one group of threads per live lane; T7's setup is one
cooperative launch whose blocks each own a range of nodes, and its force a
launch over the incident nodes the setup lists.  The cases: a contact soup
as found and jittered (the cubic runs) at sizes whose grids are one block
and several per member, other body shapes (fewer faces: combo groups of 4
and 16 threads with idle threads), B = 3 with a member latched, more
members than one cooperative launch keeps resident (several launches,
several sweeps and scan passes a block), no live lane, live lanes without
a contact, and caps the contacts overflow (the first ``cap`` contacts, and
the latch when the proximity lanes alone overflow the pair buffer).  Every output is held equal to the twin's: contacts, mask, count
and latch; row_start, the entries and nodes, the diagonals and the force.
T2's contact substep is one cooperative launch: the contact tets first,
walking T7's node list iteration by iteration (each waiting for the tets
it shares a contact with), then the free tets' iterations in registers;
T8 runs all its stages in one cooperative launch.  T5 is one cooperative
launch a call: bounds and flags, then, when a member rebuilds, the grid
build, a warp a body's query and the cache update.  Its cases: the soup
as found, moved past the slack, stale, with a NaN position (moved: no
rebuild; stale: a rebuild), the oversize latch, dead bodies, a narrow row
of 2 slots, a dense pile past 127 entries a bucket (packed and unpacked
mode), B = 3 with a latched member and members that do and do not
rebuild, and more members than one launch keeps resident.  T2's and T8's
cases: the soup's contacts as found and jittered with 1 and 4
iterations, with and without T1's first force, with pins, no live
contact, every tet a contact tet (several tets a thread), B = 3 with a
member latched, more members than one launch keeps resident; T8 with 0, 1
and 4 passes, each stage alone and both, the accumulate-only mode, and
the generic path's edge contacts with the node-node impulse.  The CPU
tests cover the face table the wrappers keep on the device, the scratch
they keep across calls, T5's grid query, and T2's contact substep as the
per-iteration loop it replaces.
"""

import dataclasses

import numpy as np
import pytest
import torch

import pies_tpu_torch as pt
from pies_tpu_torch import kernels
from pies_tpu_torch.collision import broadphase
from pies_tpu_torch.collision.batches import CollisionSet, incident
from pies_tpu_torch.parallel import ensemble
from pies_tpu_torch.solver import pd, tetcols
from pies_tpu_torch.state import clone_state, member, stack_members

SCENE = dict(spacing=1.0, scale=0.8, w=2000.0, height=0.5, jitter=0.05)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def test_face_table_is_made_once_per_pattern_and_device():
    faces = ((0, 2, 1), (0, 1, 3), (1, 2, 3), (0, 3, 2))
    table = broadphase.face_table(faces, torch.device("cpu"))
    assert table.dtype == torch.int32 and tuple(table.shape) == (4, 3)
    assert table.tolist() == [list(f) for f in faces]
    again = broadphase.face_table([list(f) for f in np.array(faces)], torch.device("cpu"))
    assert again is table
    other = broadphase.face_table(faces[:2], torch.device("cpu"))
    assert other is not table and other.tolist() == [list(f) for f in faces[:2]]


def test_soup_layout_face_table_matches_the_config():
    s = pt.Solver(pt.SolverOptions(), enable_collisions=True, device="cpu")
    s.create_tet_soup(8, **SCENE)
    s._prepare()
    lay = broadphase.body_layout(s.config, s.topology.tri_mask.shape[0])
    table = broadphase.face_table(lay.faces, torch.device("cpu"))
    assert (lay.m, lay.e) == (4, 4)
    assert table.tolist() == [list(f) for f in s.config.body_faces]


def test_scratch_is_kept_per_key_and_stream(monkeypatch):
    monkeypatch.setattr(kernels, "stream", lambda: 7)
    cpu = torch.device("cpu")
    a = kernels.scratch("test scratch", (3, 5), torch.int32, cpu, zeroed=True)
    assert a.dtype == torch.int32 and tuple(a.shape) == (3, 5) and int(a.abs().sum()) == 0
    assert kernels.scratch("test scratch", (3, 5), torch.int32, cpu) is a
    assert kernels.scratch("test scratch", (3, 6), torch.int32, cpu) is not a
    assert kernels.scratch("test scratch", (3, 5), torch.int64, cpu) is not a
    monkeypatch.setattr(kernels, "stream", lambda: 8)
    assert kernels.scratch("test scratch", (3, 5), torch.int32, cpu) is not a


def test_broadphase_grid_is_asked_once_per_key(monkeypatch):
    """T5's grid and scratch width come from the library once per device,
    member count and layout; a grid of 0 (no block resident) raises."""
    asked = []

    class Lib:
        def pies_body_broadphase_grid(self, members, k):
            asked.append((members, k))
            return 0 if k == 7 else 3

        def pies_body_broadphase_words(self, k, h, grid):
            return 2 * h + 1 + grid + 14 * k + 18

    monkeypatch.setattr(kernels, "lib", lambda: Lib())
    broadphase.broadphase_grid.cache_clear()
    cpu = torch.device("cpu")
    try:
        assert broadphase.broadphase_grid(cpu, 2, 64, 256) == (3, 2 * 256 + 1 + 3 + 14 * 64 + 18)
        assert broadphase.broadphase_grid(cpu, 2, 64, 256) == (3, 1430)
        assert asked == [(2, 64)]
        with pytest.raises(RuntimeError, match="resident"):
            broadphase.broadphase_grid(cpu, 1, 7, 16)
    finally:
        broadphase.broadphase_grid.cache_clear()


def _contact_state(device, n=512, ticks=25, pins=None):
    """A self-contact soup (``pins``: node ids held by position
    constraints) after ``ticks`` ticks of the kernels, with the predicted
    positions of its next substep."""
    s = pt.Solver(pt.SolverOptions(), enable_collisions=True, device=device)
    s.create_tet_soup(n, **SCENE)
    if pins:
        s._builder.pos_idx.append(np.asarray(pins, np.int32))
        s._builder.pos_w.append(np.full(len(pins), 8000.0, np.float32))
    s.run_ticks(ticks)
    st, topo, cfg, params = s.state, s.topology, s.config, s.current_params()
    head = pd.substep_head_plain(clone_state(st), topo, params, cfg, True)
    return s, head


def test_broadphase_flag_is_the_caches_own_word():
    """T5 (its twin on CPU tensors) writes the rebuilt flag into the cache
    it was given and returns that word: a call on another cache leaves it
    alone, the next call on the same cache overwrites it, a latched call
    writes 0, and an ensemble's members each get their own flag."""
    s = pt.Solver(pt.SolverOptions(), enable_collisions=True, device="cpu")
    s.create_tet_soup(64, **dict(SCENE, spacing=3.0))  # (no row past its narrow slots)
    s._prepare()
    st, topo = s.state, s.topology
    lay = broadphase.body_layout(s.config, topo.tri_mask.shape[0])
    sc = broadphase.scalars(s.current_params())
    x, prev, tmask = st.positions, st.prev_positions, topo.tri_mask
    over = torch.zeros(1, dtype=torch.int32)
    ok, latched = torch.zeros(2, dtype=torch.int32), torch.tensor([1, 0], dtype=torch.int32)
    a, b = st.bp.clone(), st.bp.clone()
    assert int(a.fresh[0]) == 0 and int(a.rebuilt[0]) == 0
    flag = broadphase.body_broadphase(x, prev, tmask, a, lay, sc, over, ok)
    assert flag is a.rebuilt and int(flag[0]) == 1 and int(a.fresh[0]) == 1
    assert int(broadphase.body_broadphase(x, prev, tmask, b, lay, sc, over, ok)[0]) == 1
    assert int(broadphase.body_broadphase(x, prev, tmask, b, lay, sc, over, ok)[0]) == 0
    assert int(flag[0]) == 1  # (b's calls leave a's word alone)
    assert int(broadphase.body_broadphase(x, prev, tmask, a, lay, sc, over, ok)[0]) == 0
    assert int(flag[0]) == 0  # (a's next call overwrites it)
    a.fresh.zero_()
    a.rebuilt.fill_(1)
    pairs = a.pairs.clone()
    assert int(broadphase.body_broadphase(x, prev, tmask, a, lay, sc, over, latched)[0]) == 0
    assert int(a.fresh[0]) == 0 and torch.equal(a.pairs, pairs)
    c = stack_members([st.bp.clone(), b.clone()])
    two = lambda t: stack_members([t, t])  # noqa: E731
    flags = broadphase.body_broadphase(two(x), two(prev), tmask, c, lay, sc, two(over),
                                       two(ok))
    assert flags is c.rebuilt and flags.tolist() == [[1], [0]]


def test_contact_substep_on_the_cpu_is_the_per_iteration_loop():
    """On CPU tensors T2's contact substep takes its twin: the loop that
    ``pd_substep`` runs with ``plain=True``, one ``substep_cols_plain`` call
    an iteration given T7's plain force at the iterate it starts from; the
    result is that loop's, bit for bit, and differs from the contact-free
    iterations."""
    s, head = _contact_state("cpu", 96, 2)
    st, topo, params = s.state, s.topology, s.current_params()
    x, msn, diag, wf, active = head
    colls = pd.detect_point_tri(clone_state(st), x, topo, params, s.config, active, True)
    assert int(colls.pt_count[0]) > 0
    _, h2 = pd._h_h2(params)
    inc, ptd = tetcols.pt_coupling_setup(colls, st.mass, topo, h2, diag, wf, st.sim_failed)
    thick = params.collision_thickness
    args = (msn, diag, st.node_mask, wf)
    got = tetcols.contact_substep(x, *args, topo, 0.0, 4, st.sim_failed, ptd, colls, inc,
                                  thick)
    x_it = x
    for it in range(4):
        contact = tetcols.pt_force_plain(x_it, colls, inc, thick, st.sim_failed)
        want = tetcols.substep_cols_plain(x_it, *args, topo, 0.0, 1, st.sim_failed,
                                          (ptd, contact, inc.row_start, colls.pt_count))
        x_it = want[0]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    free = tetcols.substep_cols_plain(x, *args, topo, 0.0, 4, st.sim_failed)
    assert not torch.equal(got[0], free[0])


def _jitter(x, mask, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    j = torch.from_numpy((scale * rng.standard_normal(tuple(x.shape))).astype(np.float32))
    return x + j.to(x.device) * mask[..., None]


def _t6(x, prev, tmask, cache, lay, sc, failed):
    """T6 and its twin on the same inputs: ``[(contacts, overflow)] * 2``."""
    out = []
    for fn in (broadphase.pt_narrowphase, broadphase.pt_narrowphase_plain):
        over = torch.zeros(failed.shape[:-1] + (1,), dtype=torch.int32, device=x.device)
        out.append((fn(x, prev, tmask, cache, lay, sc, over, failed), over))
    return out


def _assert_t6_equal(out):
    (pk, ok), (pp, op) = out
    for a, b in zip(pk, pp):
        assert torch.equal(a, b)
    assert torch.equal(ok, op)
    return pk, ok


def _t7(colls, mass, topo, h2, diag, wf, failed, x, thick):
    """T7's setup and force and their twins: ``[(inc, ptd, diag, force)] * 2``."""
    out = []
    for setup, force in ((tetcols.pt_coupling_setup, tetcols.pt_force),
                         (tetcols.pt_coupling_setup_plain, tetcols.pt_force_plain)):
        d = diag.clone()
        inc, ptd = setup(colls, mass, topo, h2, d, wf, failed)
        out.append((inc, ptd, d, force(x, colls, inc, thick, failed)))
    return out


def _assert_t7_equal(out, count):
    """One scene's (or member's) setup and force equal to the twins' where
    the twins define them: the incidence when the contact count is not 0,
    ptd and the force at the incident nodes, the diagonal everywhere."""
    (ik, pk, dk, fk), (ip, pp, dp, fp) = out
    assert torch.equal(dk, dp)
    if count == 0:
        assert int(ik.node_count[0]) == 0
        return
    nnz, on = int(ip.row_start[-1]), incident(ip)
    assert nnz == 4 * count
    assert torch.equal(ik.row_start, ip.row_start)
    assert torch.equal(ik.entries[:nnz], ip.entries[:nnz])
    assert torch.equal(ik.nodes[:nnz], ip.nodes[:nnz])
    listed = int(ik.node_count[0])
    assert torch.equal(ik.node_list[:listed].long(), torch.nonzero(on).reshape(-1))
    assert torch.equal(pk[on], pp[on]) and torch.equal(fk[on], fp[on])


def _coupling_inputs(s, head, contacts, failed):
    st, topo, params = s.state, s.topology, s.current_params()
    x, _, diag, wf, active = head
    colls = CollisionSet(floor_active=active, pt_idx=contacts[0], pt_mask=contacts[1],
                         pt_count=contacts[2], overflow=torch.zeros_like(contacts[2]))
    _, h2 = pd._h_h2(params)
    return colls, st.mass, topo, h2, diag, wf, failed, x, params.collision_thickness


@pytest.mark.gpu
@pytest.mark.parametrize("jittered", [False, True], ids=["as_found", "jittered"])
@pytest.mark.parametrize("n_tets", [256, 512, 1024],
                         ids=["one_block", "t6_two_blocks", "several_blocks"])
def test_narrowphase_and_coupling_equal_twins(cuda, jittered, n_tets):
    """The contact soup as found, and jittered so that points cross face
    planes (phase 2's cubic; the pair buffer fills), at sizes whose grids
    are one block per member for T6 and T7's setup (256 tets: 4,096 lanes,
    1,024 nodes), two T6 blocks and one setup block (512), and four T6
    blocks and two setup blocks (1,024)."""
    s, head = _contact_state(cuda, n_tets)
    st, topo = s.state, s.topology
    lay = broadphase.body_layout(s.config, topo.tri_mask.shape[0])
    sc = broadphase.scalars(s.current_params())
    x = _jitter(head[0], st.node_mask, 1) if jittered else head[0]
    stats = {}
    pk, _ = _assert_t6_equal(_t6(x, st.prev_positions, topo.tri_mask, st.bp, lay, sc,
                                 st.sim_failed))
    broadphase.pt_narrowphase_plain(x, st.prev_positions, topo.tri_mask, st.bp, lay, sc,
                                    torch.zeros_like(st.sim_failed[:1]), st.sim_failed,
                                    stats=stats)
    count = int(pk[2][0])
    assert count > 0 and (stats["cross_combos"] > 0 or not jittered)
    inputs = _coupling_inputs(s, (x,) + tuple(head[1:]), pk, st.sim_failed)
    _assert_t7_equal(_t7(*inputs), count)


@pytest.mark.gpu
@pytest.mark.parametrize("faces", [1, 3], ids=["one_face", "three_faces"])
def test_narrowphase_equals_twin_on_other_body_shapes(cuda, faces):
    """Layouts with fewer faces a body: 4 and 12 combos a lane, in groups
    of 4 and 16 threads (four idle)."""
    s, head = _contact_state(cuda)
    st, topo = s.state, s.topology
    lay = broadphase.body_layout(s.config, topo.tri_mask.shape[0])
    lay = dataclasses.replace(lay, e=faces, faces=lay.faces[:faces])
    sc = broadphase.scalars(s.current_params())
    x = _jitter(head[0], st.node_mask, 2)
    pk, _ = _assert_t6_equal(_t6(x, st.prev_positions, topo.tri_mask, st.bp, lay, sc,
                                 st.sim_failed))
    assert int(pk[2][0]) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("share", [0.0, 0.5, 1.0], ids=["cap_1", "cap_half", "cap_all_but_one"])
def test_narrowphase_over_the_cap_equals_twin(cuda, share):
    """Caps the contacts overflow (1, half of them, all but one), each with
    at least 2·cap lanes with a bit, so that the pair buffer is full and the
    count is the kept slots' hits: the first ``cap`` contacts, the count and
    the latch equal the twin's, and the coupling on them."""
    s, head = _contact_state(cuda)
    st, topo = s.state, s.topology
    lay = broadphase.body_layout(s.config, topo.tri_mask.shape[0])
    sc = broadphase.scalars(s.current_params())
    stats = {}
    full = broadphase.pt_narrowphase_plain(head[0], st.prev_positions, topo.tri_mask, st.bp, lay,
                                           sc, torch.zeros_like(st.sim_failed[:1]),
                                           st.sim_failed, stats=stats)
    found = int(full[2][0])
    assert found >= 3
    cap = max(1, min(found - 1, round(share * (found - 1))))
    assert stats["compacted_lanes"] >= 2 * cap
    lay = dataclasses.replace(lay, cap=cap)
    pk, _ = _assert_t6_equal(_t6(head[0], st.prev_positions, topo.tri_mask, st.bp, lay, sc,
                                 st.sim_failed))
    assert int(pk[2][0]) == cap
    inputs = _coupling_inputs(s, head, pk, st.sim_failed)
    _assert_t7_equal(_t7(*inputs), cap)


@pytest.mark.gpu
def test_narrowphase_latch_equals_twin(cuda):
    """Points that did not move cross no face plane, so every lane with a
    bit is a proximity lane: with a cap whose 2·cap pair slots they
    overflow, kernel and twin both latch and keep the same first
    contacts."""
    s, head = _contact_state(cuda)
    st, topo = s.state, s.topology
    lay = broadphase.body_layout(s.config, topo.tri_mask.shape[0])
    sc = broadphase.scalars(s.current_params())
    x = head[0]
    stats = {}
    broadphase.pt_narrowphase_plain(x, x, topo.tri_mask, st.bp, lay, sc,
                                    torch.zeros_like(st.sim_failed[:1]), st.sim_failed,
                                    stats=stats)
    n_prox = stats["compacted_lanes"]
    assert stats["cross_combos"] == 0 and n_prox >= 3
    lay = dataclasses.replace(lay, cap=(n_prox - 1) // 2)
    pk, ok = _assert_t6_equal(_t6(x, x, topo.tri_mask, st.bp, lay, sc, st.sim_failed))
    assert int(ok[0]) == 1 and int(pk[2][0]) == lay.cap


@pytest.mark.gpu
def test_no_live_lane_and_no_contact_equal_twins(cuda):
    """No live lane (every cached pair invalid), and live lanes without a
    contact (the soup spread three times apart, the pairs kept): empty
    contact buffers, no latch, and an incidence left unwritten with the
    diagonal unchanged."""
    s, head = _contact_state(cuda)
    st, topo = s.state, s.topology
    lay = broadphase.body_layout(s.config, topo.tri_mask.shape[0])
    sc = broadphase.scalars(s.current_params())
    none = st.bp.clone()
    none.valid.zero_()
    centre = head[0].mean(0)
    spread = (head[0] - centre) * 3.0 + centre
    prev = (st.prev_positions - centre) * 3.0 + centre
    for x, pv, cache in ((head[0], st.prev_positions, none), (spread, prev, st.bp)):
        pk, ok = _assert_t6_equal(_t6(x, pv, topo.tri_mask, cache, lay, sc, st.sim_failed))
        assert int(pk[2][0]) == 0 and int(ok[0]) == 0 and float(pk[1].sum()) == 0.0
        inputs = _coupling_inputs(s, (x,) + tuple(head[1:]), pk, st.sim_failed)
        _assert_t7_equal(_t7(*inputs), 0)


@pytest.mark.gpu
def test_ensemble_with_a_latched_member_equals_twins(cuda):
    """B = 3 jittered members of the contact soup, member 1 latched: each
    member's contacts, latch and coupling equal the twins' member by
    member; the latched member writes an empty contact buffer."""
    s, head = _contact_state(cuda)
    st, topo = s.state, s.topology
    lay = broadphase.body_layout(s.config, topo.tri_mask.shape[0])
    sc = broadphase.scalars(s.current_params())
    states = ensemble.stack_ensemble(st, 3)
    x = torch.stack([_jitter(head[0], st.node_mask, 10 + b, 0.01) for b in range(3)])
    states.sim_failed[1, 0] = 1
    pk, ok = _assert_t6_equal(_t6(x, states.prev_positions, topo.tri_mask, states.bp, lay, sc,
                                  states.sim_failed))
    counts = [int(c) for c in pk[2][:, 0]]
    assert counts[1] == 0 and counts[0] > 0 and counts[2] > 0
    x_, msn, diag, wf, active = head
    colls = CollisionSet(floor_active=stack_members([active] * 3), pt_idx=pk[0],
                         pt_mask=pk[1], pt_count=pk[2], overflow=torch.zeros_like(ok))
    _, h2 = pd._h_h2(s.current_params())
    out = _t7(colls, states.mass, topo, h2, stack_members([diag] * 3),
              stack_members([wf] * 3), states.sim_failed, x,
              s.current_params().collision_thickness)
    for b in range(3):
        _assert_t7_equal([tuple(member(v, b) for v in side) for side in out], counts[b])


@pytest.mark.gpu
def test_more_members_than_one_launch_keeps_resident_equal_twins(cuda):
    """1,100 jittered members of the 1,024-tet soup, every seventh latched:
    more members than a cooperative launch of 256-thread blocks keeps
    resident on any card (at most 8 such blocks an SM), so T6 and T7's
    setup each take several launches at one block a member (four sweeps a
    T6 block, two scan passes a setup block).  Each member's contacts,
    latch and coupling equal the twins' member by member."""
    members = 1100
    s, head = _contact_state(cuda, 1024)
    st, topo = s.state, s.topology
    lay = broadphase.body_layout(s.config, topo.tri_mask.shape[0])
    sc = broadphase.scalars(s.current_params())
    states = ensemble.stack_ensemble(st, members)
    rng = np.random.default_rng(30)
    j = torch.from_numpy((0.01 * rng.standard_normal((members,) + tuple(head[0].shape))).astype(
        np.float32)).to(cuda)
    x = head[0] + j * st.node_mask[..., None]
    states.sim_failed[::7, 0] = 1
    pk, ok = _assert_t6_equal(_t6(x, states.prev_positions, topo.tri_mask, states.bp, lay, sc,
                                  states.sim_failed))
    counts = pk[2][:, 0].tolist()
    assert all(c == 0 for c in counts[::7]) and sum(c > 0 for c in counts) > members // 2
    x_, msn, diag, wf, active = head
    colls = CollisionSet(floor_active=stack_members([active] * members), pt_idx=pk[0],
                         pt_mask=pk[1], pt_count=pk[2], overflow=torch.zeros_like(ok))
    _, h2 = pd._h_h2(s.current_params())
    out = _t7(colls, states.mass, topo, h2, stack_members([diag] * members),
              stack_members([wf] * members), states.sim_failed, x,
              s.current_params().collision_thickness)
    for b in range(members):
        _assert_t7_equal([tuple(member(v, b) for v in side) for side in out], counts[b])


def _t5(x, prev, tmask, cache, lay, sc, failed):
    """T5 and its twin on copies of ``cache``: ``[(cache, overflow,
    rebuilt)] * 2``, the flag each call returns being its cache's own
    word."""
    out = []
    for fn in (broadphase.body_broadphase, broadphase.body_broadphase_plain):
        c = cache.clone()
        over = torch.zeros(failed.shape[:-1] + (1,), dtype=torch.int32, device=x.device)
        flag = fn(x, prev, tmask, c, lay, sc, over, failed)
        assert flag.data_ptr() == c.rebuilt.data_ptr()
        out.append((c, over, flag))
    return out


def _assert_t5_equal(out):
    """The cache rows, reference, freshness, latch and rebuilt flag equal,
    bit for bit; returns the kernel's side."""
    (ck, ok, rk), (cp, op, rp) = out
    for f in ("pairs", "valid", "ref", "fresh"):  # (bits: a NaN copied is equal)
        assert torch.equal(getattr(ck, f).view(torch.int32), getattr(cp, f).view(torch.int32)), f
    assert torch.equal(ok, op) and torch.equal(rk, rp)
    return ck, ok, rk


def _t5_state(cuda, n=512):
    s, head = _contact_state(cuda, n)
    lay = broadphase.body_layout(s.config, s.topology.tri_mask.shape[0])
    return s, head, lay, broadphase.scalars(s.current_params())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["as_found", "moved", "fresh_0", "nan_moved", "nan_fresh_0"])
@pytest.mark.parametrize("n_tets", [512, 4096])
def test_broadphase_equals_twin(cuda, case, n_tets):
    """T5 on the contact soup (one and several blocks a member): as found;
    every node moved past the slack (a rebuild by displacement); the cache
    marked stale; a NaN position with nodes moved (the displacement test
    false: no rebuild) and with the cache stale (a rebuild on NaN
    bounds).  Cache, latch and rebuilt flag equal the twin's."""
    s, head, lay, sc = _t5_state(cuda, n_tets)
    st, topo = s.state, s.topology
    x, cache = head[0], st.bp.clone()
    if case in ("moved", "nan_moved"):  # (a fresh cache: only the displacement decides)
        x = _jitter(x, st.node_mask, 40, 0.5)
        cache.fresh.fill_(1)
    if case in ("fresh_0", "nan_fresh_0"):
        cache.fresh.zero_()
    if case.startswith("nan"):
        x = x.clone()
        x[5, 1] = float("nan")
    ck, ok, rk = _assert_t5_equal(_t5(x, st.prev_positions, topo.tri_mask, cache, lay, sc,
                                      st.sim_failed))
    if case == "nan_moved":
        assert int(rk[0]) == 0
    else:
        assert int(ck.valid.sum()) > 0 and (case == "as_found" or int(rk[0]) == 1)


@pytest.mark.gpu
def test_broadphase_latches_equal_twin(cuda):
    """The oversize latch (one body stretched past 2 - margin cells), dead
    bodies (every third body's faces masked), a narrow row of 2 slots (more
    unique candidates than slots, and more exact ones), each on a stale
    cache: equal to the twin, with the latches the twin sets."""
    s, head, lay, sc = _t5_state(cuda)
    st, topo = s.state, s.topology
    stale = st.bp.clone()
    stale.fresh.zero_()
    big = head[0].clone()
    big[lay.off + 4 * 10 + 2, 0] += 3.0 * sc.cell
    _, ok, _ = _assert_t5_equal(_t5(big, st.prev_positions, topo.tri_mask, stale, lay, sc,
                                    st.sim_failed))
    assert int(ok[0]) == 1
    dead = topo.tri_mask.clone()
    dead[: lay.k * lay.e].view(lay.k, lay.e)[::3] = 0.0
    ck, _, _ = _assert_t5_equal(_t5(head[0], st.prev_positions, dead, stale, lay, sc,
                                    st.sim_failed))
    assert int(ck.valid[::3].sum()) == 0 and int(ck.valid.sum()) > 0
    narrow = dataclasses.replace(lay, nb=2)
    cache2 = broadphase.empty_broadphase_cache(lay.k, 2, lay.k * lay.m, cuda)
    ck, _, _ = _assert_t5_equal(_t5(head[0], st.prev_positions, topo.tri_mask, cache2, narrow,
                                    sc, st.sim_failed))
    assert int(ck.fresh[0]) == 0  # (the narrow latch)


@pytest.mark.gpu
@pytest.mark.parametrize("unpacked", [False, True], ids=["packed", "unpacked"])
def test_broadphase_dense_pile_equals_twin(cuda, unpacked, monkeypatch):
    """A dense pile: 300 tets of the soup moved onto one cell, so buckets
    hold 300 or more entries (past the packed table's 127, ordered by a
    warp) on a stale cache, in the packed mode (the bucket latches at 127)
    and the unpacked one (as with 2^24 entries or more: only past 1,000).
    Equal to the twin, latch included."""
    if unpacked:
        from pies_tpu_torch.collision import grid

        monkeypatch.setattr(broadphase, "PACKED_MAX_ENTRIES", 1)
        monkeypatch.setattr(grid, "PACKED_MAX_ENTRIES", 1)
    s, head, lay, sc = _t5_state(cuda)
    st, topo = s.state, s.topology
    x, prev = head[0].clone(), st.prev_positions.clone()
    pile = slice(lay.off + 4 * 100, lay.off + 4 * 400)
    corner = x[pile][:4] - x[pile][:4].mean(0)
    x[pile] = corner.repeat(300, 1) * 0.05 + torch.tensor([0.3, 2.0, 0.3], device=cuda)
    prev[pile] = x[pile]
    stale = st.bp.clone()
    stale.fresh.zero_()
    ck, _, rk = _assert_t5_equal(_t5(x, prev, topo.tri_mask, stale, lay, sc, st.sim_failed))
    assert int(rk[0]) == 1 and int(ck.valid.sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("anyone", [False, True], ids=["none_rebuilds", "one_rebuilds"])
def test_broadphase_ensemble_with_a_latched_member_equals_twin(cuda, anyone):
    """B = 3: member 0 as found, member 1 latched on a stale cache, member
    2 stale (rebuilding) or not; each member's cache, latch and rebuilt
    flag equal the twin's; the latched member's cache is left as it was."""
    s, head, lay, sc = _t5_state(cuda)
    st, topo = s.state, s.topology
    states = ensemble.stack_ensemble(st, 3)
    x = stack_members([head[0]] * 3)
    states.sim_failed[1, 0] = 1
    states.bp.fresh[1] = 0
    if anyone:
        states.bp.fresh[2] = 0
    for _ in range(2):  # (the second call as found after the first's rebuilds)
        before = states.bp.clone()
        ck, ok, rk = _assert_t5_equal(_t5(x, states.prev_positions, topo.tri_mask, states.bp,
                                          lay, sc, states.sim_failed))
        assert int(rk[1, 0]) == 0 and torch.equal(ck.pairs[1], before.pairs[1])
        if anyone:
            assert int(rk[2, 0]) == 1
        states.bp = ck


@pytest.mark.gpu
def test_broadphase_past_one_resident_launch_equals_twin(cuda):
    """1,100 jittered members of the 512-tet soup, every seventh latched
    and every third stale: more members than one cooperative launch keeps
    resident, so T5 takes several launches at one block a member.  Each
    member's cache, latch and rebuilt flag equal the twin's."""
    members = 1100
    s, head, lay, sc = _t5_state(cuda)
    st, topo = s.state, s.topology
    states = ensemble.stack_ensemble(st, members)
    rng = np.random.default_rng(31)
    j = torch.from_numpy((0.01 * rng.standard_normal((members,) + tuple(head[0].shape))).astype(
        np.float32)).to(cuda)
    x = head[0] + j * st.node_mask[..., None]
    states.sim_failed[::7, 0] = 1
    states.bp.fresh[::3] = 0
    _, _, rk = _assert_t5_equal(_t5(x, states.prev_positions, topo.tri_mask, states.bp, lay, sc,
                                    states.sim_failed))
    assert int(rk[::7].sum()) == 0 and int(rk.sum()) > 0


def _t2_fused(x, head, topo, mask, colls, setups, thick, failed, iterations=1):
    """T2's contact substep (T7's force inside its launches, on the kernel's
    setup) and its plain twin (T7's plain force an iteration, on the twin's
    setup): ``(kernel's, twin's)`` outputs.  ``setups`` is ``[(inc, ptd)]``
    of the kernel and of the twin."""
    _, msn, diag, wf, _ = head
    args = (msn, diag, mask, wf, topo, 0.0, iterations, failed)
    (ik, dk), (ip, dp) = setups
    fused = tetcols.contact_substep(x, *args, dk, colls, ik, thick)
    plain = tetcols.contact_substep_plain(x, *args, dp, colls, ip, thick)
    return fused, plain


def _setups(colls, mass, topo, h2, diag, wf, failed):
    """T7's setup by the kernel and by the twin, each on its own copy of
    the diagonal (equal after it: the coupling tests hold that)."""
    out = []
    for setup in (tetcols.pt_coupling_setup, tetcols.pt_coupling_setup_plain):
        d = diag.clone()
        out.append((setup(colls, mass, topo, h2, d, wf, failed), d))
    return [s for s, _ in out], out[0][1]


@pytest.mark.gpu
@pytest.mark.parametrize("jittered", [False, True], ids=["as_found", "jittered"])
def test_fused_contact_force_in_t2_equals_twin(cuda, jittered):
    """T2's fused mode (T7's force computed inside the launch from the
    iterate it reads) against the plain twin given T7's plain force:
    positions, static projection and residual shares bit for bit."""
    s, head = _contact_state(cuda)
    st, topo = s.state, s.topology
    lay = broadphase.body_layout(s.config, topo.tri_mask.shape[0])
    sc = broadphase.scalars(s.current_params())
    x = _jitter(head[0], st.node_mask, 3, 0.01) if jittered else head[0]
    pk = broadphase.pt_narrowphase(x, st.prev_positions, topo.tri_mask, st.bp, lay, sc,
                                   torch.zeros_like(st.sim_failed[:1]), st.sim_failed)
    colls, mass, topo_, h2, diag, wf, failed, _, thick = _coupling_inputs(
        s, (x,) + tuple(head[1:]), pk, st.sim_failed)
    assert int(pk[2][0]) > 0
    setups, d = _setups(colls, mass, topo_, h2, diag, wf, failed)
    fused, plain = _t2_fused(x, (x, head[1], d, wf, None), topo, st.node_mask, colls, setups,
                             thick, failed)
    for a, b in zip(fused, plain):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_fused_contact_force_in_t2_over_an_ensemble(cuda):
    """B = 3 jittered members, member 1 latched: T2's fused mode equals the
    twin on the live members, and writes the latched member's residual
    shares as 0 (it leaves that member's positions unwritten)."""
    s, head = _contact_state(cuda)
    st, topo = s.state, s.topology
    lay = broadphase.body_layout(s.config, topo.tri_mask.shape[0])
    sc = broadphase.scalars(s.current_params())
    states = ensemble.stack_ensemble(st, 3)
    x = torch.stack([_jitter(head[0], st.node_mask, 20 + b, 0.01) for b in range(3)])
    states.sim_failed[1, 0] = 1
    over = torch.zeros((3, 1), dtype=torch.int32, device=cuda)
    pk = broadphase.pt_narrowphase(x, states.prev_positions, topo.tri_mask, states.bp, lay, sc,
                                   over, states.sim_failed)
    _, msn, diag, wf, active = head
    colls = CollisionSet(floor_active=stack_members([active] * 3), pt_idx=pk[0],
                         pt_mask=pk[1], pt_count=pk[2], overflow=over)
    _, h2 = pd._h_h2(s.current_params())
    w3 = stack_members([wf] * 3)
    setups, d = _setups(colls, states.mass, topo, h2, stack_members([diag] * 3), w3,
                        states.sim_failed)
    fused, plain = _t2_fused(x, (x, stack_members([msn] * 3), d, w3, None), topo,
                             states.node_mask, colls, setups,
                             s.current_params().collision_thickness, states.sim_failed)
    for a, b in zip(fused[:2], plain[:2]):
        assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    assert torch.equal(fused[2], plain[2]) and float(fused[2][1].abs().sum()) == 0.0


def _soup_contacts(cuda, n=512, jitter_seed=None, pins=None):
    """The contact soup, its predicted positions (jittered by
    ``jitter_seed``), T6's contacts there and T7's setup by the kernel and
    by the twin: ``(solver, head, colls, setups, diag)``, ``diag`` the
    system diagonal with the contacts' diagonal folded in."""
    s, head = _contact_state(cuda, n, pins=pins)
    st, topo = s.state, s.topology
    lay = broadphase.body_layout(s.config, topo.tri_mask.shape[0])
    sc = broadphase.scalars(s.current_params())
    x = head[0] if jitter_seed is None else _jitter(head[0], st.node_mask, jitter_seed, 0.01)
    pk = broadphase.pt_narrowphase(x, st.prev_positions, topo.tri_mask, st.bp, lay, sc,
                                   torch.zeros_like(st.sim_failed[:1]), st.sim_failed)
    colls, mass, topo_, h2, diag, wf, failed, _, thick = _coupling_inputs(
        s, (x,) + tuple(head[1:]), pk, st.sim_failed)
    setups, d = _setups(colls, mass, topo_, h2, diag, wf, failed)
    return s, (x, head[1], d, wf, head[4]), colls, setups, d


def _assert_t2_equal(fused, plain, live=None):
    """T2's contact substep equal to its twin: positions and static
    projection (of the ``live`` members), residual shares everywhere."""
    for a, b in zip(fused[:2], plain[:2]):
        if live is not None:
            a, b = a[live], b[live]
        assert torch.equal(a, b)
    assert torch.equal(fused[2], plain[2])


@pytest.mark.gpu
@pytest.mark.parametrize("iterations", [1, 4])
@pytest.mark.parametrize("jittered", [False, True], ids=["as_found", "jittered"])
def test_contact_substep_equals_twin(cuda, jittered, iterations):
    """T2's contact substep on the soup's contacts (as found and jittered):
    one cooperative launch, the contact tets iteration by iteration and
    then the free tets, bit for bit the twin's one-iteration calls, with 1
    and 4 iterations, the first iteration's tet force computed inside."""
    s, head, colls, setups, _ = _soup_contacts(cuda, jitter_seed=4 if jittered else None)
    st, topo = s.state, s.topology
    inc = setups[0][0]
    assert int(colls.pt_count[0]) > 0 and 0 < int(inc.node_count[0]) < st.capacity
    _assert_t2_equal(*_t2_fused(head[0], head, topo, st.node_mask, colls, setups,
                                s.current_params().collision_thickness, st.sim_failed,
                                iterations))


@pytest.mark.gpu
def test_contact_substep_with_pins_equals_twin(cuda):
    """A soup with two pinned nodes (the pin force folded into the
    right-hand side of every tet, contact tets too): equal to the twin."""
    s, head, colls, setups, _ = _soup_contacts(cuda, pins=[0, 5])
    st, topo = s.state, s.topology
    assert int((topo.position.w > 0).sum()) == 2 and int(colls.pt_count[0]) > 0
    _assert_t2_equal(*_t2_fused(head[0], head, topo, st.node_mask, colls, setups,
                                s.current_params().collision_thickness, st.sim_failed, 4))


@pytest.mark.gpu
def test_contact_substep_without_contacts_equals_twin(cuda):
    """No live contact (the soup spread three times apart): every tet is a
    free tet, the launch finds no listed node, and the result is the
    twin's (the contact-free iterations)."""
    s, head = _contact_state(cuda)
    st, topo = s.state, s.topology
    lay = broadphase.body_layout(s.config, topo.tri_mask.shape[0])
    sc = broadphase.scalars(s.current_params())
    centre = head[0].mean(0)
    x = (head[0] - centre) * 3.0 + centre
    prev = (st.prev_positions - centre) * 3.0 + centre
    pk = broadphase.pt_narrowphase(x, prev, topo.tri_mask, st.bp, lay, sc,
                                   torch.zeros_like(st.sim_failed[:1]), st.sim_failed)
    assert int(pk[2][0]) == 0
    colls, mass, topo_, h2, diag, wf, failed, _, thick = _coupling_inputs(
        s, (x,) + tuple(head[1:]), pk, st.sim_failed)
    setups, d = _setups(colls, mass, topo_, h2, diag, wf, failed)
    _assert_t2_equal(*_t2_fused(x, (x, head[1], d, wf, None), topo, st.node_mask, colls,
                                setups, thick, failed, 4))


@pytest.mark.gpu
def test_contact_substep_walks_several_tets_a_thread(cuda):
    """Every tet a contact tet (a contact from each tet's first node to the
    next tet's other three, 12,288 tets): 49,152 listed nodes, more than
    the cooperative grid's threads on any card (at most 2 blocks of 128
    an SM), so each thread walks several tets an iteration, re-deriving
    each from device memory: equal to the twin."""
    k = 12_288
    s = pt.Solver(pt.SolverOptions(), enable_collisions=True, device=cuda)
    s.create_tet_soup(k, **SCENE)
    s._prepare()
    st, topo, params = s.state, s.topology, s.current_params()
    head = pd.substep_head_plain(clone_state(st), topo, params, s.config, True)
    x = _jitter(head[0], st.node_mask, 5, 0.01)
    t = torch.arange(k, device=cuda)
    nxt = (t + 1) % k
    idx = torch.stack([4 * t, 4 * nxt + 1, 4 * nxt + 2, 4 * nxt + 3], 1).to(torch.int32)
    count = torch.tensor([k], dtype=torch.int32, device=cuda)
    contacts = (idx.contiguous(), torch.ones(k, device=cuda), count)
    colls, mass, topo_, h2, diag, wf, failed, _, thick = _coupling_inputs(
        s, (x,) + tuple(head[1:]), contacts, st.sim_failed)
    setups, d = _setups(colls, mass, topo_, h2, diag, wf, failed)
    assert int(setups[0][0].node_count[0]) == 4 * k
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert 4 * k > 2 * sms * 128
    _assert_t2_equal(*_t2_fused(x, (x, head[1], d, wf, None), topo, st.node_mask, colls,
                                setups, thick, failed, 4))


def _tail_pair(s, colls, setups, x, static, cfg=None, edges=None, nn_imp=None,
               stages=pd.STABILIZE | pd.FRICTION, acc=False):
    """T8 by the kernel and by the twin on copies of the state and of ``x``:
    ``[(x, prev, out)] * 2``, ``out`` the friction impulse or, with
    ``acc``, the sums."""
    out = []
    for tail, (inc, _) in zip((pd.pt_tail, pd.pt_tail_plain), setups):
        st, x_ = clone_state(s.state), x.clone()
        r = tail(st, s.current_params(), cfg or s.config, colls, inc, x_, static, edges,
                 nn_imp, stages, acc)
        out.append((x_, st.prev_positions, r))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("stages", [1, 2, 3], ids=["stabilize", "friction", "both"])
@pytest.mark.parametrize("passes", [0, 1, 4])
def test_tail_equals_twin(cuda, passes, stages):
    """T8, one cooperative launch a call, after T2's contact substep on the
    soup's contacts: positions and previous positions everywhere and the
    friction impulse at the incident nodes (the only ones T4 reads) equal
    to the twin's, with 0, 1 and 4 stabilization passes and each stage
    alone or both."""
    s, head, colls, setups, _ = _soup_contacts(cuda, jitter_seed=6)
    st, topo = s.state, s.topology
    x, static, _ = tetcols.contact_substep(head[0], head[1], head[2], st.node_mask, head[3],
                                           topo, 0.0, 4, st.sim_failed, setups[0][1],
                                           colls, setups[0][0],
                                           s.current_params().collision_thickness)
    cfg = dataclasses.replace(s.config, collision_stabilization_iterations=passes)
    (xk, pk, fk), (xp, pp, fp) = _tail_pair(s, colls, setups, x, static, cfg, stages=stages)
    on = incident(setups[1][0])
    assert torch.equal(xk, xp) and torch.equal(pk, pp)
    if stages & pd.FRICTION:
        assert torch.equal(fk[on], fp[on])


@pytest.mark.gpu
@pytest.mark.parametrize("stages", [1, 2], ids=["stabilize", "friction"])
def test_tail_accumulate_only_equals_twin(cuda, stages):
    """T8's accumulate-only mode (the domain's): one stage's per-node sums
    and counts equal to the twin's, positions untouched."""
    s, head, colls, setups, _ = _soup_contacts(cuda, jitter_seed=7)
    x = head[0]
    (xk, pk, ak), (xp, pp, ap) = _tail_pair(s, colls, setups, x, x, stages=stages, acc=True)
    assert torch.equal(ak, ap)
    assert torch.equal(xk, x) and torch.equal(pk, s.state.prev_positions)


@pytest.mark.gpu
def test_tail_with_edge_contacts_and_node_impulse_equals_twin(cuda):
    """The tet boxes with all three contact families (the generic path's
    T8: each pass's point-triangle and edge push-outs and the snap, then
    the friction at the velocity with the node-node impulse), the stages
    of one substep against their twins on the same inputs: T8 and its
    friction call equal."""
    from pies_tpu_torch.scene.contact_piles import branch_scene
    from pies_tpu_torch.solver.stages import contact_stages, stages_apart

    s, cfg = branch_scene("all_on", cuda)
    s.run_ticks(10)
    out = contact_stages(s.state, s.topology, s.current_params(), cfg)
    assert {"T8", "T8 friction", "T26 setup", "T27 friction"} <= set(out)
    assert stages_apart({k: out[k] for k in ("T8", "T8 friction")}) == []
    assert int(out["T26 setup"].kernel[0][-1]) > 0


@pytest.mark.gpu
def test_contact_substep_and_tail_over_an_ensemble(cuda):
    """B = 3 jittered members, member 1 latched: T2's contact substep and
    T8 equal the twins on the live members; the latched member's residual
    shares are 0 and its positions untouched by T8."""
    s, head = _contact_state(cuda)
    st, topo = s.state, s.topology
    lay = broadphase.body_layout(s.config, topo.tri_mask.shape[0])
    sc = broadphase.scalars(s.current_params())
    states = ensemble.stack_ensemble(st, 3)
    x = torch.stack([_jitter(head[0], st.node_mask, 40 + b, 0.01) for b in range(3)])
    states.sim_failed[1, 0] = 1
    over = torch.zeros((3, 1), dtype=torch.int32, device=cuda)
    pk = broadphase.pt_narrowphase(x, states.prev_positions, topo.tri_mask, states.bp, lay, sc,
                                   over, states.sim_failed)
    _, msn, diag, wf, active = head
    colls = CollisionSet(floor_active=stack_members([active] * 3), pt_idx=pk[0],
                         pt_mask=pk[1], pt_count=pk[2], overflow=over)
    _, h2 = pd._h_h2(s.current_params())
    w3 = stack_members([wf] * 3)
    setups, d = _setups(colls, states.mass, topo, h2, stack_members([diag] * 3), w3,
                        states.sim_failed)
    thick = s.current_params().collision_thickness
    fused, plain = _t2_fused(x, (x, stack_members([msn] * 3), d, w3, None), topo,
                             states.node_mask, colls, setups, thick, states.sim_failed, 4)
    _assert_t2_equal(fused, plain, [0, 2])
    assert float(fused[2][1].abs().sum()) == 0.0
    s._state = states
    (xk, pk_, fk), (xp, pp, fp) = _tail_pair(s, colls, setups, fused[0], fused[1])
    assert torch.equal(xk, xp) and torch.equal(pk_, pp) and torch.equal(xk[1], fused[0][1])
    on = torch.stack([incident(member(setups[1][0], b)) for b in range(3)])
    assert torch.equal(fk[on], fp[on])


@pytest.mark.gpu
def test_contact_substep_and_tail_past_one_resident_launch(cuda):
    """More members than one cooperative launch keeps resident (T2's
    contact launch at its card occupancy and one block a member; T8's
    256-thread blocks at most 8 an SM), every seventh latched, one
    contact set for all: several launches each, every live member equal
    to the twins."""
    s, head, colls1, _, d1 = _soup_contacts(cuda, 256)
    st, topo = s.state, s.topology
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    members = max(8, tetcols.contact_occupancy()) * sms + 7
    states = ensemble.stack_ensemble(st, members)
    rng = np.random.default_rng(31)
    j = torch.from_numpy((0.01 * rng.standard_normal((members,) + tuple(head[0].shape))).astype(
        np.float32)).to(cuda)
    x = head[0] + j * st.node_mask[..., None]
    states.sim_failed[::7, 0] = 1
    live = [b for b in range(members) if b % 7]
    colls = CollisionSet(floor_active=stack_members([colls1.floor_active] * members),
                         pt_idx=stack_members([colls1.pt_idx] * members),
                         pt_mask=stack_members([colls1.pt_mask] * members),
                         pt_count=stack_members([colls1.pt_count] * members),
                         overflow=torch.zeros((members, 1), dtype=torch.int32, device=cuda))
    _, h2 = pd._h_h2(s.current_params())
    wm = stack_members([head[3]] * members)
    setups, d = _setups(colls, states.mass, topo, h2, stack_members([d1] * members), wm,
                        states.sim_failed)
    thick = s.current_params().collision_thickness
    fused, plain = _t2_fused(x, (x, stack_members([head[1]] * members), d, wm, None), topo,
                             states.node_mask, colls, setups, thick, states.sim_failed, 4)
    _assert_t2_equal(fused, plain, live)
    s._state = states
    (xk, pk, fk), (xp, pp, fp) = _tail_pair(s, colls, setups, fused[0], fused[1])
    assert torch.equal(xk[live], xp[live]) and torch.equal(pk[live], pp[live])


@pytest.mark.gpu
def test_each_call_is_one_kernel_without_copies(cuda):
    """On the contact soup: T5 launches one kernel a call as found and one
    with a rebuild (beside the fill that forces it), T6 and T7's setup one
    kernel a call and T7's force one, T2's contact substep one
    (cooperative) and T8 one, with no memcpy and no memset (the profiler's
    count)."""
    from torch.profiler import ProfilerActivity, profile

    from pies_tpu_torch.tick_profile import device_events

    s, head = _contact_state(cuda)
    st, topo = s.state, s.topology
    lay = broadphase.body_layout(s.config, topo.tri_mask.shape[0])
    sc = broadphase.scalars(s.current_params())
    over = torch.zeros(1, dtype=torch.int32, device=cuda)
    pk = broadphase.pt_narrowphase(head[0], st.prev_positions, topo.tri_mask, st.bp, lay, sc,
                                   over, st.sim_failed)
    colls, mass, topo_, h2, diag, wf, failed, x, thick = _coupling_inputs(s, head, pk,
                                                                          st.sim_failed)
    inc, ptd = tetcols.pt_coupling_setup(colls, mass, topo_, h2, diag, wf, failed)
    x2, static, _ = tetcols.contact_substep(x, head[1], diag, st.node_mask, wf, topo,
                                            0.0, 4, failed, ptd, colls, inc, thick)
    st8, x8 = clone_state(st), x2.clone()  # (T8 updates both in place)
    found, forced = st.bp.clone(), st.bp.clone()

    def rebuild():
        forced.fresh.zero_()
        broadphase.body_broadphase(head[0], st.prev_positions, topo.tri_mask, forced, lay, sc,
                                   over, st.sim_failed)

    calls = {
        "T5 as found": (lambda: broadphase.body_broadphase(
            head[0], st.prev_positions, topo.tri_mask, found, lay, sc, over, st.sim_failed), 1),
        "T5 rebuild (and the fill that forces it)": (rebuild, 2),
        "T6": (lambda: broadphase.pt_narrowphase(head[0], st.prev_positions, topo.tri_mask,
                                                 st.bp, lay, sc, over, st.sim_failed), 1),
        "T7 setup": (lambda: tetcols.pt_coupling_setup(colls, mass, topo_, h2, diag, wf,
                                                       failed), 1),
        "T7 force": (lambda: tetcols.pt_force(x, colls, inc, thick, failed), 1),
        "T2 contact substep": (lambda: tetcols.contact_substep(
            x, head[1], diag, st.node_mask, wf, topo, 0.0, 4, failed, ptd, colls, inc,
            thick), 1),
        "T8": (lambda: pd.pt_tail(st8, s.current_params(), s.config, colls, inc, x8, static),
               1),
    }
    for name, (fn, per_call) in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                fn()
            torch.cuda.synchronize()
        kinds = {}
        for e, _us in device_events(prof):
            kind = e.key.split()[0] if e.key.startswith(("Memcpy", "Memset")) else "kernel"
            kinds[kind] = kinds.get(kind, 0) + e.count
            if name.startswith("T5") and "bp_kernel" in e.key:
                kinds["T5"] = kinds.get("T5", 0) + e.count
        want = {"kernel": 4 * per_call} | ({"T5": 4} if name.startswith("T5") else {})
        assert kinds == want, (name, kinds)
