"""The port's scene ensemble (``pies_tpu_torch.parallel.ensemble``, ROADMAP
item 10a) against the JAX package's vmapped ``ensemble_tick``.

Scene: 4 members of the 32-tet soup at spacing 1.0 with self-contact, each
member's live nodes moved by its own seeded offset (uniform ±0.02), member 3
latched before the start.  The JAX ensemble warms 20 ticks (its layers meet
from tick ~11 of the window after), its state is carried across with
``convert.state_from_numpy``, and both packages step the same arrays.

Tolerances, per member: one tick 3e-6 (a few float32 ulps at |x| ≈ 3; the
single-scene slice measures 3e-6), 30 ticks 1e-3 (the contact soup's own
float32 spread, ``tests/test_torch_solver.py``).  The window passes a knife
edge at tick 16 (a tet settling on the floor amplifies one rounding): there
the JAX package's own run from the start moved by one ulp at random parts
from its run by 8.0e-4 in member 0, where it parted by 1.7e-5 at tick 15,
and by 7.6e-3 at tick 30.  So every member is held to 1e-3 up to tick 15,
members 1-3 on every tick, and member 0 from tick 16 to 1e-3 or, where
larger, that spread, which must stay below 1e-2.  Measured on the CPU: the
port parts from the JAX run by at most 1.5e-4 up to tick 15, and at tick
30 by 2.4e-3 in member 0, 5.6e-4 and 5.3e-4 in members 1 and 2.  Contact
counts and the latch are equal on every tick.  Within the port everything is exact: the
latched member is bit-unchanged, ``ensemble_tick_n`` equals that many
``ensemble_tick`` calls, and a member equals its single-scene run.

The ``gpu`` tests hold each batched kernel T1-T8 to its twins' member loop
at B = 3, and B = 1 to the unbatched call; they skip without a card.
"""

import dataclasses
from functools import partial

import jax
import numpy as np
import pytest
import torch

import pies_tpu
from pies_tpu.collision.broadphase import detect_point_tri_collisions as jdetect
from pies_tpu.options import SolverName as JName, SolverOptions as JOptions
from pies_tpu.parallel import ensemble as jens
import pies_tpu_torch as pt
from pies_tpu_torch import convert
from pies_tpu_torch.collision import broadphase
from pies_tpu_torch.constraints import projections as proj
from pies_tpu_torch.parallel import ensemble
from pies_tpu_torch.solver import pd, step, tetcols
from pies_tpu_torch.state import clone_state, member, stack_ensemble, unstack

from torch_threads import two_threads  # noqa: F401

B, N_TETS, LATCHED = 4, 32, 3
CONTACT_SCENE = dict(spacing=1.0, scale=0.8, w=2000.0, height=0.5, jitter=0.05)
WARM, TICKS = 20, 30
STEP_TOL, TRAJ_TOL = 3e-6, 1e-3
KNIFE, SPREAD_CEILING = 16, 1e-2  # the window tick of member 0's knife edge; its spread's cap
LIVE = 4 * N_TETS


def _offsets(n_live):
    """Each member's seeded offset of its live nodes (member 0 none)."""
    return [np.zeros((n_live, 3), np.float32)] + [
        np.random.default_rng(100 + b).uniform(-0.02, 0.02, (n_live, 3)).astype(np.float32)
        for b in range(1, B)]


def _jax_members(j):
    """The JAX ensemble's start: the prepared scene stacked B times, each
    member's live positions moved by its offset, member LATCHED latched."""
    base = jax.tree.map(np.asarray, j._state)
    st = jax.tree.map(lambda a: np.repeat(a[None], B, 0), base)
    pos, prev = st.positions.copy(), st.prev_positions.copy()
    for b, off in enumerate(_offsets(LIVE)):
        pos[b, :LIVE] += off
        prev[b, :LIVE] += off
    failed = np.zeros(B, bool)
    failed[LATCHED] = True
    return dataclasses.replace(st, positions=pos, prev_positions=prev, sim_failed=failed)


@pytest.fixture(scope="module")
def reference():
    """The JAX run shared by the module: the start state (after the warm-up)
    as NumPy leaves, then per tick of the window the positions, the
    contacts each member detects and the latch."""
    j = pies_tpu.Solver(JOptions(solver=JName.PD), enable_collisions=True,
                        dense_operator_max=0)
    j.create_tet_soup(N_TETS, **CONTACT_SCENE)
    j._prepare()
    topo, params, cfg = j._topology, j.current_params(), j._config
    tick = jax.jit(jens.ensemble_tick, static_argnames=("config",))

    @jax.jit
    def contacts(states):
        def one(s):
            x = s.positions + params.dt * s.velocities * s.node_mask[:, None]
            _, mask, _, _ = jdetect(x, s.prev_positions, topo.triangles, topo.tri_mask, params,
                                    config=cfg, cache=s.bp)
            return jax.numpy.where(s.sim_failed, 0, mask.sum().astype(jax.numpy.int32))
        return jax.vmap(one)(states)

    states = jax.tree.map(jax.numpy.asarray, _jax_members(j))
    for _ in range(WARM):
        states, _ = tick(states, topo, params, config=cfg)
    start = jax.tree.map(np.asarray, states)
    pos, counts, failed, res = [], [], [], []
    for _ in range(TICKS):
        counts.append(np.asarray(contacts(states)).tolist())
        states, r = tick(states, topo, params, config=cfg)
        pos.append(np.asarray(states.positions)[:, :LIVE])
        failed.append(np.asarray(states.sim_failed).tolist())
        res.append(np.asarray(r))
    # The JAX package's own spread: the window from the start with half the
    # live coordinates moved one ulp up or down.
    rng = np.random.default_rng(7)
    x = start.positions[:, :LIVE]
    inf = np.where(rng.random(x.shape) < 0.5, np.float32(np.inf), np.float32(-np.inf))
    moved = np.where(rng.random(x.shape) < 0.5, np.nextafter(x, inf.astype(np.float32)), x)
    states = jax.tree.map(jax.numpy.asarray, dataclasses.replace(
        start, positions=np.concatenate([moved, start.positions[:, LIVE:]], axis=1)))
    for _ in range(TICKS):
        states, _ = tick(states, topo, params, config=cfg)
    spread = np.abs(np.asarray(states.positions)[:, :LIVE] - pos[-1]).reshape(B, -1).max(1)
    return dict(start=start, pos=np.stack(pos), counts=counts, failed=failed, res=res,
                spread=spread, cfg=cfg, topo=jax.tree.map(np.asarray, topo), params=params)


def _port(reference):
    """The port's ensemble at the reference's start, with its topology,
    parameters and configuration."""
    topo = convert.topology_from_numpy(reference["topo"])
    params = convert.params_from(jax.tree.map(np.asarray, reference["params"]))
    return (convert.state_from_numpy(reference["start"]), topo, params,
            convert.config_from(reference["cfg"]))


@pytest.fixture(scope="module")
def port_run(reference):
    """The port's window: positions, per-member contacts and latch per
    tick, the final state and the start state."""
    states, topo, params, cfg = _port(reference)
    start = unstack_all(states)
    pos, counts, failed = [], [], []
    for _ in range(TICKS):
        c = pd.new_counters("cpu", B)
        ensemble.ensemble_tick(states, topo, params, cfg, counters=c)
        pos.append(states.positions[:, :LIVE].numpy().copy())
        counts.append(c["contacts"].tolist())
        failed.append((states.sim_failed != 0).any(-1).tolist())
    return dict(pos=np.stack(pos), counts=counts, failed=failed, states=states, start=start,
                env=(topo, params, cfg))


def unstack_all(states):
    return [unstack(states, b) for b in range(states.members)]


def test_carried_start_is_an_ensemble_on_the_tet_column_path(reference):
    states, topo, _, cfg = _port(reference)
    assert states.members == B and tuple(states.sim_failed.shape) == (B, 2)
    assert tuple(states.bp.pairs.shape[:1]) == (B,) and tuple(states.bp.fresh.shape) == (B, 1)
    assert tetcols.applies(states, topo, cfg) and broadphase.packed(cfg)
    assert states.sim_failed[:, 0].tolist() == [0, 0, 0, 1]


def test_one_tick_matches_reference(reference, port_run):
    d = np.abs(port_run["pos"][0] - reference["pos"][0]).reshape(B, -1).max(axis=1)
    assert (d <= STEP_TOL).all(), d
    assert port_run["counts"][0] == reference["counts"][0]


def test_window_matches_reference(reference, port_run):
    """30 ticks: every member within 1e-3, but member 0 past its knife edge
    within the JAX package's own spread where that is larger; contacts equal
    per member on every tick (and live in the window), the latch on the same
    tick."""
    assert port_run["counts"] == reference["counts"]
    live = np.asarray(port_run["counts"])
    assert live[:, :LATCHED].sum(axis=0).min() > 0 and live[:, LATCHED].sum() == 0
    assert port_run["failed"] == reference["failed"]
    d = np.abs(port_run["pos"] - reference["pos"]).reshape(TICKS, B, -1).max(-1)
    assert (d[:KNIFE - 1] <= TRAJ_TOL).all(), d[:KNIFE - 1]
    assert (d[:, 1:] <= TRAJ_TOL).all(), d[:, 1:]
    spread = reference["spread"][0]
    assert spread < SPREAD_CEILING, spread
    assert (d[KNIFE - 1:, 0] <= max(TRAJ_TOL, spread)).all(), (d[KNIFE - 1:, 0], spread)
    assert np.isfinite(port_run["pos"]).all()


def test_latched_member_is_frozen(port_run):
    states, start = port_run["states"], port_run["start"][LATCHED]
    after = member(states, LATCHED)
    for f in ("positions", "prev_positions", "velocities", "forces", "sim_failed"):
        assert torch.equal(getattr(after, f), getattr(start, f)), f
    for f in ("pairs", "valid", "ref", "fresh"):
        assert torch.equal(getattr(after.bp, f), getattr(start.bp, f)), f


def test_member_equals_its_single_scene_run(port_run):
    """Member 2 of the ensemble equals the same scene run alone."""
    topo, params, cfg = port_run["env"]
    single = port_run["start"][2]
    for _ in range(TICKS):
        step.tick(single, topo, params, cfg)
    assert torch.equal(member(port_run["states"], 2).positions, single.positions)
    assert torch.equal(member(port_run["states"], 2).bp.pairs, single.bp.pairs)


def test_tick_n_equals_ticks(reference):
    a, topo, params, cfg = _port(reference)
    b = convert.state_from_numpy(reference["start"])
    res_n = ensemble.ensemble_tick_n(a, topo, params, cfg, 6)
    for _ in range(6):
        res = ensemble.ensemble_tick(b, topo, params, cfg)
    assert torch.equal(a.positions, b.positions) and torch.equal(a.bp.pairs, b.bp.pairs)
    assert float(res_n) == float(res.max()) and float(res[LATCHED]) == 0.0


def test_step_reduces_over_members(reference):
    """``ensemble_step`` gives the largest residual and the latched count,
    as ``make_sharded_step``'s pmax and psum do; the JAX residuals of the
    first tick, which are float32 roundoff of a direct solve, agree in
    size."""
    a, topo, params, cfg = _port(reference)
    b = convert.state_from_numpy(reference["start"])
    max_res, num_failed = ensemble.ensemble_step(a, topo, params, cfg)
    res = ensemble.ensemble_tick(b, topo, params, cfg)
    assert float(max_res) == float(res.max()) and int(num_failed) == 1
    assert int(num_failed) == sum(reference["failed"][0])
    ref = reference["res"][0]
    assert ref[LATCHED] == 0.0 and float(res[LATCHED]) == 0.0
    assert 0.1 < float(max_res) / float(ref.max()) < 10.0


def test_other_paths_are_not_ported():
    """The generic path with self-contact (``create_sheet`` with collisions
    on) runs as an ensemble (ROADMAP item 10b-ii,
    ``tests/test_torch_ensemble_contacts.py``): it steps, each member as
    its single-scene run; so does the PBD tet soup (item 10b-iv,
    ``tests/test_torch_ensemble_pbd.py``)."""
    s = pt.Solver(pt.SolverOptions(solver=pt.SolverName.PD), enable_collisions=True,
                  device="cpu")
    s.create_sheet((0.0, 0.5, 0.0), 0.5, 1.0, 5000.0)
    s._prepare()
    states = stack_ensemble(s.state, 2)
    single = unstack(states, 0)
    start = states.positions.clone()
    for _ in range(2):  # (the first tick from rest leaves the positions)
        res = ensemble.ensemble_tick(states, s.topology, s.current_params(), s.config)
        step.tick(single, s.topology, s.current_params(), s.config)
    assert not torch.equal(states.positions, start) and bool(torch.isfinite(res).all())
    assert torch.equal(states.positions[0], single.positions)
    assert torch.equal(states.positions[0], states.positions[1])
    p = pt.Solver(pt.SolverOptions(solver=pt.SolverName.PBD), enable_collisions=False,
                  device="cpu")
    # (a PBD weight is the fraction of the projection applied: the PD
    # stiffness 2000 overshoots and the first tick goes non-finite)
    p.create_tet_soup(8, **dict(CONTACT_SCENE, w=1.0))
    p._prepare()
    states = stack_ensemble(p.state, 2)
    single = unstack(states, 0)
    start = states.positions.clone()
    for _ in range(2):
        res = ensemble.ensemble_tick(states, p.topology, p.current_params(), p.config)
        step.tick(single, p.topology, p.current_params(), p.config)
    assert not torch.equal(states.positions, start) and not bool(res.any())
    assert not states.failed() and bool(torch.isfinite(states.positions).all())
    assert torch.equal(states.positions[0], single.positions)
    assert torch.equal(states.positions[1], single.positions)
    assert torch.equal(states.velocities[1], single.velocities)


def test_stack_ensemble_copies():
    s = pt.Solver(pt.SolverOptions(), enable_collisions=True, device="cpu")
    s.create_tet_soup(8, **CONTACT_SCENE)
    s._prepare()
    states = stack_ensemble(s.state, 3)
    states.positions[1, 0, 0] += 1.0
    assert states.positions.is_contiguous() and states.bp.pairs.is_contiguous()
    assert float(states.positions[0, 0, 0]) == float(s.state.positions[0, 0])
    assert torch.equal(unstack(states, 2).positions, s.state.positions)


# ---------------------------------------------------------------------------
# the batched kernels on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _card_ensemble(dev, n=3, ticks=40):
    """An n-member contact soup on the card (96 tets at spacing 1.0, seeded
    offsets) after ``ticks`` kernel ticks: contacts are live."""
    s = pt.Solver(pt.SolverOptions(), enable_collisions=True, device=dev)
    s.create_tet_soup(96, **CONTACT_SCENE)
    s._prepare()
    states = stack_ensemble(s.state, n)
    live = s._builder.num_nodes
    for b, off in enumerate(_offsets(live)[:n]):
        states.positions[b, :live] += torch.from_numpy(off).to(dev)
        states.prev_positions[b, :live] += torch.from_numpy(off).to(dev)
    ensemble.ensemble_tick_n(states, s.topology, s.current_params(), s.config, ticks)
    return states, s.topology, s.current_params(), s.config


def _stages(states, topo, params, cfg, kernel):
    """One substep's T1-T8 outputs on a copy of ``states``, every stage by
    the kernels (``kernel``) or every stage by the twins."""
    st = clone_state(states)
    pick = (lambda k, p: k) if kernel else (lambda k, p: p)
    out = {}
    head = pick(pd.substep_head, pd.substep_head_plain)(st, topo, params, cfg, True)
    x, msn, diag, wf, active = out["T3"] = head
    colls = pd.detect_point_tri(st, x, topo, params, cfg, active, plain=not kernel)
    out["T5"] = (st.bp.pairs, st.bp.valid, st.bp.fresh, colls.rebuilt)
    out["T6"] = (colls.pt_idx, colls.pt_mask, colls.pt_count, colls.overflow)
    h2 = float(np.float32(params.dt) * np.float32(params.dt))
    inc, ptd = pick(tetcols.pt_coupling_setup, tetcols.pt_coupling_setup_plain)(
        colls, st.mass, topo, h2, diag, wf, st.sim_failed)
    # (a member without contacts leaves its incidence unwritten on the card)
    live = colls.pt_count > 0
    on = (inc.row_start[..., 1:] > inc.row_start[..., :-1]) & live
    out["T7 setup"] = (torch.where(live, inc.row_start, 0), torch.where(on, ptd, 0.0), diag)
    f0 = pick(proj.tet_force12, proj.tet_force12_plain)(x, topo.strain, topo.volume,
                                                        st.sim_failed)
    out["T1"] = (f0,)
    contact = pick(tetcols.pt_force, tetcols.pt_force_plain)(x, colls, inc,
                                                             params.collision_thickness,
                                                             st.sim_failed)
    out["T7 force"] = (torch.where(on[..., None], contact, 0.0),)
    plane = pd.floor_plane(params, cfg.reference_quirks)
    x_new, stat, r2 = out["T2"] = pick(tetcols.substep_cols, tetcols.substep_cols_plain)(
        x, msn, diag, st.node_mask, wf, topo, plane, 1, st.sim_failed,
        (ptd, contact, inc.row_start, colls.pt_count))
    fric = pick(pd.pt_tail, pd.pt_tail_plain)(st, params, cfg, colls, inc, x_new, stat)
    out["T8"] = (x_new, st.prev_positions.clone(), torch.where(on[..., None], fric, 0.0))
    pick(pd.substep_tail, pd.substep_tail_plain)(st, topo, params, active, x_new, stat, colls,
                                                 inc, fric)
    out["T4"] = (st.positions, st.velocities, st.forces, st.sim_failed)
    return out


@pytest.mark.gpu
def test_batched_kernels_equal_the_twins_member_loop(cuda):
    """B = 3: each of T1-T8 batched equals its twin run member by member
    (``-fmad=false``: bit for bit)."""
    states, topo, params, cfg = _card_ensemble(cuda)
    k, p = _stages(states, topo, params, cfg, True), _stages(states, topo, params, cfg, False)
    torch.cuda.synchronize()
    assert int(k["T6"][2].sum()) > 0
    for stage in k:
        for a, b in zip(k[stage], p[stage]):
            assert torch.equal(a, b), stage


@pytest.mark.gpu
def test_one_member_equals_the_single_scene_kernels(cuda):
    """B = 1 gives the unbatched call's outputs."""
    states, topo, params, cfg = _card_ensemble(cuda, n=1)
    k1 = _stages(states, topo, params, cfg, True)
    single = _stages(unstack(states, 0), topo, params, cfg, True)
    torch.cuda.synchronize()
    for stage in k1:
        for a, b in zip(k1[stage], single[stage]):
            assert torch.equal(a.reshape(b.shape), b), stage


# ---------------------------------------------------------------------------
# the tet-column path off the packed bodies (ROADMAP item 10c)

BRANCH_B, BRANCH_LATCHED, BRANCH_WARM, BRANCH_TICKS = 3, 1, 33, 2


def _branch_fields(branch, budget):
    """The StepConfig fields that take the soup's detection off the packed
    bodies: none for the reference sweep (the Solver's own, with its
    budget), or the cell list (the budget's bodies unpacked with 32 narrow
    slots a row, as the cell list's own budget has, the super-body layout
    off, no all-pairs)."""
    if branch == "reference":
        return {}
    from pies_tpu_torch.scene.contact_piles import SUPER_OFF

    return dict(body_nodes=0, body_node_offset=0, body_faces=(), allpairs_broadphase_max=0,
                budget=dataclasses.replace(budget, body_stride=1, max_narrow_candidates=32),
                **SUPER_OFF)


@pytest.fixture(scope="module", params=["reference", "celllist"])
def branch_reference(request):
    """The JAX vmapped tick of the 32-tet soup in one branch: B = 3 members,
    member 1 latched, each other member's live nodes moved by its seeded
    offset; after ``BRANCH_WARM`` ticks the start (contacts from tick 31),
    then per tick the positions and each member's contact set on the tick's
    predicted positions."""
    branch = request.param
    j = pies_tpu.Solver(JOptions(solver=JName.PD), enable_collisions=True,
                        dense_operator_max=0, broadphase_mode=branch)
    j.create_tet_soup(N_TETS, **CONTACT_SCENE)
    j._prepare()
    topo, params = j._topology, j.current_params()
    cfg = dataclasses.replace(j._config, unroll_loops=False,
                              **_branch_fields(branch, j._config.budget))
    base = jax.tree.map(np.asarray, j._state)
    st = jax.tree.map(lambda a: np.repeat(a[None], BRANCH_B, 0), base)
    pos, prev = st.positions.copy(), st.prev_positions.copy()
    for b, off in enumerate(_offsets(LIVE)[:BRANCH_B]):
        pos[b, :LIVE] += off
        prev[b, :LIVE] += off
    failed = np.arange(BRANCH_B) == BRANCH_LATCHED
    st = dataclasses.replace(st, positions=pos, prev_positions=prev, sim_failed=failed)
    # (XLA's backend optimization level 0: half the compile time)
    opt0 = {"xla_backend_optimization_level": 0}
    tick = jax.jit(jens.ensemble_tick, static_argnames=("config",), compiler_options=opt0)

    @partial(jax.jit, compiler_options=opt0)
    def contacts(states):
        def one(s):
            x = s.positions + params.dt * s.velocities * s.node_mask[:, None]
            out = jdetect(x, s.prev_positions, topo.triangles, topo.tri_mask, params, cfg)
            return out[0], jax.numpy.where(s.sim_failed, 0.0, out[1])
        return jax.vmap(one)(states)

    states = jax.tree.map(jax.numpy.asarray, st)
    for _ in range(BRANCH_WARM):
        states, _ = tick(states, topo, params, config=cfg)
    start = jax.tree.map(np.asarray, states)
    xs, sets = [], []
    for _ in range(BRANCH_TICKS):
        sets.append(_contact_sets(*contacts(states)))
        states, _ = tick(states, topo, params, config=cfg)
        xs.append(np.asarray(states.positions)[:, :LIVE])
    return dict(branch=branch, start=start, pos=np.stack(xs), sets=sets, cfg=cfg,
                topo=jax.tree.map(np.asarray, topo), params=jax.tree.map(np.asarray, params))


def _contact_sets(pt_idx, pt_mask):
    """Each member's contacts as a set of (a, b, c, d) rows."""
    return [{tuple(int(v) for v in row) for row, m in zip(idx, mask) if m > 0}
            for idx, mask in zip(np.asarray(pt_idx), np.asarray(pt_mask))]


def test_tet_column_ensembles_run_off_the_packed_bodies(branch_reference):
    """Item 10c: the tet-column ensemble with self-contact in reference mode
    and on the cell list.  One tick within 3e-6 of the JAX package's vmapped
    tick and each member's contact set equal on every tick of the window
    (live in members 0 and 2); the latched member frozen; each member
    equal to its single-scene run."""
    ref = branch_reference
    cfg = convert.config_from(ref["cfg"])
    topo = convert.topology_from_numpy(ref["topo"])
    params = convert.params_from(ref["params"])
    states = convert.state_from_numpy(ref["start"])
    assert tetcols.applies(states, topo, cfg)
    assert broadphase.tri_mode(cfg, topo.tri_mask.shape[0]) == ref["branch"]
    singles = unstack_all(states)
    h = float(np.float32(params.dt))
    pos, sets = [], []
    for _ in range(BRANCH_TICKS):
        x = states.positions + h * states.velocities * states.node_mask[..., None]
        idx, mask, _, _, _ = broadphase.detect_point_tri_collisions(
            x, states.prev_positions, topo.tri_mask, params, cfg, failed=states.sim_failed,
            triangles=topo.triangles)
        mask = torch.where((states.sim_failed != 0).any(-1, keepdim=True), 0.0, mask)
        sets.append(_contact_sets(idx.numpy(), mask.numpy()))
        ensemble.ensemble_tick(states, topo, params, cfg)
        pos.append(states.positions[:, :LIVE].numpy().copy())
    assert sets == ref["sets"], [[len(m) for m in s] for s in sets]
    assert all(len(s[0]) and len(s[2]) and not s[BRANCH_LATCHED] for s in sets), \
        [[len(m) for m in s] for s in sets]
    d = np.abs(pos[0] - ref["pos"][0]).reshape(BRANCH_B, -1).max(axis=1)
    assert (d <= STEP_TOL).all(), d
    assert torch.equal(states.positions[BRANCH_LATCHED], singles[BRANCH_LATCHED].positions)
    for b in range(BRANCH_B):
        for _ in range(BRANCH_TICKS):
            step.tick(singles[b], topo, params, cfg)
        assert torch.equal(member(states, b).positions, singles[b].positions), b
