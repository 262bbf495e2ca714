"""The main path's point-triangle kernels T6 (narrowphase) and T7 (coupling)
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
The CPU tests cover the face table the wrappers keep on the device and the
scratch they keep across calls.
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


def _contact_state(device, n=512, ticks=25):
    """A self-contact soup after ``ticks`` ticks of the kernels, with the
    predicted positions of its next substep."""
    s = pt.Solver(pt.SolverOptions(), enable_collisions=True, device=device)
    s.create_tet_soup(n, **SCENE)
    s.run_ticks(ticks)
    st, topo, cfg, params = s.state, s.topology, s.config, s.current_params()
    head = pd.substep_head_plain(clone_state(st), topo, params, cfg, True)
    return s, head


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


def _t2_fused(x, head, topo, mask, colls, setups, thick, failed):
    """One T2 contact iteration with T7's force inside the launch (on the
    kernel's setup), and the plain twin given T7's plain force (on the
    twin's setup): ``(kernel's, twin's)`` outputs.  ``setups`` is
    ``[(inc, ptd)]`` of the kernel and of the twin."""
    _, msn, diag, wf, _ = head
    args = (msn, diag, mask, wf, None, topo, 0.0, 1, failed)
    (ik, dk), (ip, dp) = setups
    count = colls.pt_count
    fused = tetcols.substep_cols(x, *args, (dk, None, ik.row_start, count),
                                 fused=(colls, ik, thick))
    plain = tetcols.substep_cols_plain(
        x, *args, (dp, tetcols.pt_force_plain(x, colls, ip, thick, failed), ip.row_start, count))
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


@pytest.mark.gpu
def test_each_call_is_one_kernel_without_copies(cuda):
    """On the contact soup: T6 and T7's setup launch one kernel a call and
    T7's force one, with no memcpy and no memset (the profiler's count)."""
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
    inc, _ = tetcols.pt_coupling_setup(colls, mass, topo_, h2, diag, wf, failed)
    calls = {
        "T6": lambda: broadphase.pt_narrowphase(head[0], st.prev_positions, topo.tri_mask,
                                                st.bp, lay, sc, over, st.sim_failed),
        "T7 setup": lambda: tetcols.pt_coupling_setup(colls, mass, topo_, h2, diag, wf, failed),
        "T7 force": lambda: tetcols.pt_force(x, colls, inc, thick, failed),
    }
    for name, fn in calls.items():
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
        assert kinds == {"kernel": 4}, (name, kinds)
