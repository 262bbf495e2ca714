"""The port's ensembles on the contact-free generic PD path
(``pies_tpu_torch.parallel.ensemble``, ROADMAP item 10b-i) against the JAX
package's vmapped ``ensemble_tick``.

Cases (the JAX solvers with ``dense_operator_max=0``: the port always runs
Jacobi-PCG; each member's live nodes moved by its own seeded offset, member
0 as built):

* ``rope``, ``rope_rtol``: ``tests/test_parallel.py``'s ``rope_scene`` (12
  nodes, one pin, w 2000, ``StepConfig`` defaults) at B = 4, offsets uniform
  ±0.02 (seeds 101-103), member 3 latched before the start; ``cg_rtol`` 0
  (every solve runs its 16 trips) and 1e-4 (each member leaves at its own
  trip);
* ``cube``: ``tet_cube_drop``'s cube meshed by the port's mesher at
  resolution 3 (64 nodes, 135 tets), B = 3 with ``scene.cube_drop``'s seeded
  lifts, 22 JAX ticks before the window (member 0 meets the floor at tick
  27);
* ``cloth``: ``tests/test_torch_cloth.py``'s 32 x 32 rigged cloth
  (distance, bend, shape and goal), B = 2, 10 ticks before the window;
* ``soup``: 24 tets at spacing 1.0 with ``tet_cols=False`` (the block
  preconditioner, the band operator), B = 2, 18 ticks before the window
  (on the floor from tick 24).

Tolerances.  One tick, 3e-6 (a few float32 ulps at |x| ≈ 8; measured on
the CPU: 9.5e-7 on the ropes, 8.3e-7 on the cube, 4.8e-7 on the soup),
but 1e-5 on the cloth (``tests/test_torch_cloth.py``'s one-tick bound; the
JAX package's own tick from a state one ulp away parts by 5.1e-6 there,
the port by 7.3e-6).  Over the 10-tick window each member within 3x the
JAX package's own float32 spread on it (its window from the start with half
the live coordinates moved one ulp, the largest gap over the window; the
factor 3 of ``tests/test_torch_cloth.py``): measured, the port parts by
2.3e-5 against a spread of 2.8e-5 (rope member 1), 5.0e-6 against 1.4e-5
(cube member 1), 6.0e-6 against 9.5e-6 (soup), 1.2e-5 against 1.6e-5
(cloth), at most 1.25x the spread (rope member 2 under rtol 1e-4: 1.7e-5
against 1.3e-5).  The latched member is bit-unchanged in both packages.

Within the port everything is exact: each member equals its single-scene
run with its CG trip counts, ``ensemble_tick_n`` equals that many
``ensemble_tick`` calls, ``ensemble_step`` reduces over the members, and
the members' trip counts differ under ``cg_rtol`` 1e-4.

The ``gpu`` tests hold each batched kernel T3, T9 (both stages), T10-T13,
T22 and T4 at B = 3 to its twins' member loop on identical inputs (bit for
bit, the bend and shape rows within 1e-6 of the largest row: ``acosf``,
``sinf`` and ``cosf`` against torch's), and B = 1 to the unbatched call,
on the cube, the cloth, the soup and a star whose operator is CSR (T10's
three forms); they skip without a card.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import pies_tpu
from pies_tpu.options import (
    SolverName as JName, SolverOptions as JOptions, StepConfig as JConfig, make_params)
from pies_tpu.parallel import ensemble as jens
import pies_tpu_torch as pt
from pies_tpu_torch import convert
from pies_tpu_torch.parallel import ensemble
from pies_tpu_torch.scene.cube_drop import add_cube_drop, lifted_ensemble, member_offsets
from pies_tpu_torch.scene.rigged_cloth import add_rigged_cloth
from pies_tpu_torch.solver import assembly, pd, step, tetcols
from pies_tpu_torch.state import clone_state, member, stack_ensemble, unstack
from pies_tpu_torch.topology import row_layout

from test_parallel import rope_scene
from torch_threads import two_threads  # noqa: F401

TICKS = 10
STEP_TOL = 3e-6
SPREAD_FACTOR = 3.0


def _soup(s):
    s.create_tet_soup(24, spacing=1.0, scale=0.8, w=2000.0, height=0.5, jitter=0.05)


# case -> (builder (None: rope_scene), StepConfig fields, members, ticks before the
# window, offsets ("jitter" or "lift"), latched member, one-tick bound)
CASES = {
    "rope": (None, {}, 4, 0, "jitter", 3, STEP_TOL),
    "rope_rtol": (None, dict(cg_rtol=1e-4), 4, 0, "jitter", 3, STEP_TOL),
    "cube": (lambda s: add_cube_drop(s, 3), {}, 3, 22, "lift", None, STEP_TOL),
    "cloth": (lambda s: add_rigged_cloth(s, 32), {}, 2, 10, "jitter", None, 1e-5),
    "soup": (_soup, dict(tet_cols=False), 2, 18, "jitter", None, STEP_TOL),
}


def _jax_scene(case):
    """The JAX scene: its state with NumPy leaves, topology, parameters,
    configuration and live node count."""
    build, fields = CASES[case][:2]
    if build is None:
        state, topo = rope_scene()
        cfg = dataclasses.replace(JConfig(solver=JName.PD, enable_collisions=False), **fields)
        return jax.tree.map(np.asarray, state), topo, make_params(JOptions()), cfg, 12
    j = pies_tpu.Solver(JOptions(solver=JName.PD), enable_collisions=False, dense_operator_max=0)
    build(j)
    j._prepare()
    cfg = dataclasses.replace(j._config, **fields)
    return (jax.tree.map(np.asarray, j._state), j._topology, j.current_params(), cfg,
            j._builder.num_nodes)


def _offsets(kind, members, live):
    if kind == "lift":
        return member_offsets(members, live)
    return np.stack([np.zeros((live, 3), np.float32)] + [
        np.random.default_rng(100 + b).uniform(-0.02, 0.02, (live, 3)).astype(np.float32)
        for b in range(1, members)])


@pytest.fixture(scope="module", params=list(CASES))
def reference(request):
    """The JAX ensemble of a case: its start (after the ticks before the
    window) as NumPy leaves, the window's positions, residuals and latch per
    tick, its last shape rotations, and its own float32 spread per member."""
    case = request.param
    _, _, members, warm, kind, latched, _ = CASES[case]
    state, topo, params, cfg, live = _jax_scene(case)
    st = jax.tree.map(lambda a: np.repeat(a[None], members, 0), state)
    pos, prev = st.positions.copy(), st.prev_positions.copy()
    off = _offsets(kind, members, live)
    pos[:, :live] += off
    prev[:, :live] += off
    failed = np.zeros(members, bool)
    if latched is not None:
        failed[latched] = True
    st = dataclasses.replace(st, positions=pos, prev_positions=prev, sim_failed=failed)
    tick = jax.jit(jens.ensemble_tick, static_argnames=("config",))
    states = jax.tree.map(jax.numpy.asarray, st)
    for _ in range(warm):
        states, _ = tick(states, topo, params, config=cfg)
    start = jax.tree.map(np.asarray, states)
    xs, res, latch = [], [], []
    for _ in range(TICKS):
        states, r = tick(states, topo, params, config=cfg)
        xs.append(np.asarray(states.positions)[:, :live])
        res.append(np.asarray(r))
        latch.append(np.asarray(states.sim_failed).tolist())
    quats = np.asarray(states.shape_quats)
    rng = np.random.default_rng(7)
    x = start.positions[:, :live]
    inf = np.where(rng.random(x.shape) < 0.5, np.float32(np.inf), np.float32(-np.inf))
    moved = np.where(rng.random(x.shape) < 0.5, np.nextafter(x, inf), x)
    states = jax.tree.map(jax.numpy.asarray, dataclasses.replace(
        start, positions=np.concatenate([moved, start.positions[:, live:]], axis=1)))
    spread = np.zeros(members)
    for k in range(TICKS):
        states, _ = tick(states, topo, params, config=cfg)
        gap = np.abs(np.asarray(states.positions)[:, :live] - xs[k]).reshape(members, -1)
        spread = np.maximum(spread, gap.max(1))
    return dict(case=case, start=start, pos=np.stack(xs), res=res, latch=latch, quats=quats,
                spread=spread, live=live, topo=jax.tree.map(np.asarray, topo), cfg=cfg,
                params=jax.tree.map(np.asarray, params))


def _port(ref):
    """The port's ensemble at the reference's start, with its topology,
    parameters and configuration."""
    cfg = ref["cfg"]
    return (convert.state_from_numpy(ref["start"]),
            convert.topology_from_numpy(ref["topo"], tet_fused=cfg.tet_fused),
            convert.params_from(ref["params"]), convert.config_from(cfg))


@pytest.fixture(scope="module")
def port_run(reference):
    """The port's window: positions and per-member counters per tick, the
    residuals, the final state, and the start."""
    states, topo, params, cfg = _port(reference)
    start = clone_state(states)
    pos, counts, res = [], [], []
    for _ in range(TICKS):
        c = pd.new_counters("cpu", states.members)
        res.append(ensemble.ensemble_tick(states, topo, params, cfg, counters=c).numpy())
        pos.append(states.positions[:, :reference["live"]].numpy().copy())
        counts.append({k: v.tolist() for k, v in c.items()})
    return dict(pos=np.stack(pos), counts=counts, res=res, states=states, start=start,
                env=(topo, params, cfg))


def test_the_case_takes_the_generic_path(reference):
    states, topo, _, cfg = _port(reference)
    assert states.members == CASES[reference["case"]][2]
    assert not tetcols.applies(states, topo, cfg)
    if reference["case"] == "soup":
        assert pd.block_layout(states, topo) and topo.tet_band is not None


def test_one_tick_matches_reference(reference, port_run):
    tol = CASES[reference["case"]][6]
    d = np.abs(port_run["pos"][0] - reference["pos"][0]).reshape(len(reference["spread"]), -1)
    assert (d.max(1) <= tol).all(), d.max(1)


def test_window_matches_reference(reference, port_run):
    """Each member within 3x the JAX package's own spread over the window;
    the latched member bit-unchanged and residual 0 in both; the latch
    equal on every tick."""
    members = len(reference["spread"])
    d = np.abs(port_run["pos"] - reference["pos"]).reshape(TICKS, members, -1).max(-1)
    latched = CASES[reference["case"]][5]
    for b in range(members):
        if b == latched:
            assert not d[:, b].any() and all(r[b] == 0.0 for r in reference["res"])
            assert all(float(r[b]) == 0.0 for r in port_run["res"])
            assert all(c[k][b] == 0 for c in port_run["counts"] for k in c)  # nothing counted
            continue
        assert 0.0 < reference["spread"][b]
        assert (d[:, b] <= SPREAD_FACTOR * reference["spread"][b]).all(), (
            b, d[:, b], reference["spread"][b])
    assert [[bool(f) for f in t] for t in reference["latch"]] == [
        [b == latched for b in range(members)]] * TICKS
    assert np.isfinite(port_run["pos"]).all()
    if reference["case"] == "cube":  # the floor acts in the window
        assert sum(sum(c["floor_active"]) for c in port_run["counts"]) > 0
    if reference["case"] == "cloth":  # the shape rotations carried, per member
        assert tuple(port_run["start"].shape_quats.shape) == reference["quats"].shape
        assert reference["quats"].ndim == 3 and reference["quats"].shape[0] == members
        q = port_run["states"].shape_quats.numpy()
        assert np.abs(q - reference["quats"]).max() <= 1e-4


def test_members_equal_their_single_scene_runs(reference, port_run):
    """Every member, trip counts included, bit-equal to its single-scene
    run; under ``cg_rtol`` 1e-4 the rope's live members' trip counts
    differ, and the latched one's are 0."""
    topo, params, cfg = port_run["env"]
    states = port_run["states"]
    trips = []
    for b in range(states.members):
        single = unstack(port_run["start"], b)
        mine = []
        for _ in range(TICKS):
            c = pd.new_counters("cpu")
            step.tick(single, topo, params, cfg, counters=c)
            mine.append(int(c["cg_trips"]))
        after = member(states, b)
        for f in ("positions", "prev_positions", "velocities", "forces", "sim_failed",
                  "shape_quats"):
            assert torch.equal(getattr(after, f), getattr(single, f)), (b, f)
        assert mine == [c["cg_trips"][b] for c in port_run["counts"]], b
        trips.append(sum(mine))
    if reference["case"] == "rope_rtol":
        assert len(set(trips[:3])) == 3 and trips[3] == 0, trips


@pytest.mark.parametrize("rtol", [0.0, 1e-4])
def test_tick_n_and_step_reduce_over_members(rtol):
    """On the rope at B = 4 with member 3 latched: ``ensemble_tick_n(6)``
    equals six ``ensemble_tick`` calls and returns the largest of the last
    residuals; ``ensemble_step`` returns that largest residual and the
    latched count, as ``make_sharded_step``'s pmax and psum do."""
    s = pt.Solver(pt.SolverOptions(), enable_collisions=False, device="cpu")
    s.create_rope((0.0, 8.0, 0.0), (5.5, 8.0, 0.0), 12, 2000.0)
    s._prepare()
    topo, params = s.topology, s.current_params()
    cfg = dataclasses.replace(s.config, cg_rtol=rtol)
    a = stack_ensemble(s.state, 4)
    a.positions[1:, :12] += torch.from_numpy(_offsets("jitter", 4, 12)[1:])
    a.sim_failed[3, 0] = 1
    b, c = clone_state(a), clone_state(a)
    res_n = ensemble.ensemble_tick_n(a, topo, params, cfg, 6)
    for _ in range(6):
        res = ensemble.ensemble_tick(b, topo, params, cfg)
    assert torch.equal(a.positions, b.positions) and torch.equal(a.velocities, b.velocities)
    assert float(res_n) == float(res.max()) and float(res[3]) == 0.0
    assert float(res.min()) == 0.0 and float(res[:3].min()) > 0.0
    for _ in range(5):
        ensemble.ensemble_tick(c, topo, params, cfg)
    max_res, num_failed = ensemble.ensemble_step(c, topo, params, cfg)
    assert float(max_res) == float(res.max()) and int(num_failed) == 1
    assert torch.equal(c.positions, b.positions)


def test_convert_carries_batched_shape_rotations():
    """A JAX ensemble's ``shape_quats`` f32[B, G, 4] (the 32 x 32 rigged
    cloth's four shape groups) comes across as the port's per-member
    rotations, its latch bool[B] as latch slot 0."""
    j = pies_tpu.Solver(JOptions(solver=JName.PD), enable_collisions=False, dense_operator_max=0)
    add_rigged_cloth(j, 32)
    j._prepare()
    st = jax.tree.map(lambda a: np.repeat(np.asarray(a)[None], 3, 0), j._state)
    quats = np.random.default_rng(4).normal(size=st.shape_quats.shape).astype(np.float32)
    st = dataclasses.replace(st, shape_quats=quats, sim_failed=np.array([False, True, False]))
    port = convert.state_from_numpy(st)
    assert port.members == 3 and quats.shape[1] > 1
    assert torch.equal(port.shape_quats, torch.from_numpy(quats))
    assert torch.equal(member(port, 1).shape_quats, torch.from_numpy(quats[1]))
    assert port.sim_failed[:, 0].tolist() == [0, 1, 0]


def test_contact_paths_are_not_ported_in_an_ensemble():
    """Self-contact and the entry-list floor (item 10b-ii) and edge-edge and
    node-node contacts (item 10b-iii) run in an ensemble: each steps, its
    members equal to the single-scene run."""
    def steps(s, cfg):
        states = stack_ensemble(s.state, 2)
        single = unstack(states, 0)
        start = states.positions.clone()
        for _ in range(2):  # (the first tick from rest leaves the positions)
            res = ensemble.ensemble_tick(states, s.topology, s.current_params(), cfg)
            step.tick(single, s.topology, s.current_params(), cfg)
        assert not torch.equal(states.positions, start) and bool(torch.isfinite(res).all())
        assert torch.equal(states.positions[0], single.positions)
        assert torch.equal(states.positions[1], single.positions)

    for kw in (dict(enable_collisions=True), dict(enable_edge_collisions=True),
               dict(enable_node_collisions=True)):
        s = pt.Solver(pt.SolverOptions(), device="cpu", **{"enable_collisions": False, **kw})
        s.create_sheet((0.0, 0.5, 0.0), 0.5, 1.0, 5000.0)
        s._prepare()
        steps(s, s.config)
    s = pt.Solver(pt.SolverOptions(), enable_collisions=False, device="cpu")
    add_cube_drop(s, 2)
    s._prepare()
    steps(s, dataclasses.replace(s.config, dense_floor=False))


# ---------------------------------------------------------------------------
# the batched kernels on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _star(s, spokes=80):
    """A hub joined to ``spokes`` rim nodes and the rim closed to a ring
    (``tests/test_torch_kernels.py``'s star): the hub's operator row has
    more than 64 entries, so the operator is CSR."""
    ang = np.linspace(0.0, 2 * np.pi, spokes, endpoint=False)
    pts = np.concatenate([[[0.0, 2.0, 0.0]],
                          np.stack([np.cos(ang), 2.0 + 0.1 * np.sin(3 * ang), np.sin(ang)], 1)])
    ids = s._builder._emit_nodes(pts.astype(np.float32), inv_mass=1.0, radius=0.05)
    rim = ids[1:]
    s._builder._emit_distance(np.stack([np.full(spokes, ids[0]), rim], 1), 3000.0)
    s._builder._emit_distance(np.stack([rim, np.roll(rim, -1)], 1), 3000.0)
    s._builder._emit_triangles(np.stack([np.full(spokes, ids[0]), rim, np.roll(rim, -1)], 1))
    s._dirty = True


def _card_ensemble(dev, case, members=3, ticks=12):
    """A ``members``-member ensemble of a case's scene on the card (the
    cube with its lifts at resolution 4, the 32 x 32 rigged cloth, the soup
    off the tet-column path, the star with its CSR operator), after
    ``ticks`` kernel ticks."""
    s = pt.Solver(pt.SolverOptions(), enable_collisions=False, device=dev)
    {"cube": lambda: add_cube_drop(s, 4), "cloth": lambda: add_rigged_cloth(s, 32),
     "soup": lambda: _soup(s), "star": lambda: _star(s)}[case]()
    s._prepare()
    cfg = dataclasses.replace(s.config, tet_cols=False)
    states = lifted_ensemble(s.state, members, s._builder.num_nodes)
    ensemble.ensemble_tick_n(states, s.topology, s.current_params(), cfg, ticks)
    return states, s.topology, s.current_params(), cfg


def _stages(states, topo, params, cfg):
    """One substep's stages, kernel and twin on the same inputs (the
    kernel's outputs carried forward): ``{stage: (kernel outputs, twin
    outputs)}``."""
    out = {}
    a, b = clone_state(states), clone_state(states)
    head = pd.substep_head(a, topo, params, cfg, True)
    out["T3"] = (head, pd.substep_head_plain(b, topo, params, cfg, True))
    x, msn, diag, wf, active = head
    failed = a.sim_failed
    block = None
    if pd.block_layout(a, topo):
        block = assembly.tet_block_factor(diag, topo.tet_block6, failed)
        out["T22"] = ((block,), (assembly.tet_block_factor_plain(diag, topo.tet_block6),))
    qk, qp = a.shape_quats.clone(), a.shape_quats.clone()
    rows = assembly.local_step(x, a.inv_mass, a.mass, qk, topo, cfg.rotation_iterations, failed)
    rows_p = assembly.local_step(x, a.inv_mass, a.mass, qp, topo, cfg.rotation_iterations,
                                 failed, plain=True)
    for name, (at, n) in row_layout(topo).items():
        if n:
            out[f"rows {name}"] = ((rows[..., at:at + n, :],), (rows_p[..., at:at + n, :],))
    out["quats"] = ((qk,), (qp,))
    plane = pd.floor_plane(params, cfg.reference_quirks)
    force = assembly.assemble_force(x, msn, wf, rows, topo, plane, failed)
    out["T9 stage 2"] = (force, assembly.assemble_force_plain(x, msn, wf, rows, topo, plane))
    _, h2 = pd._h_h2(params)
    out["T10"] = (assembly.apply_system(x, a.mass, wf, h2, topo, failed, part=True),
                  assembly.apply_system_plain(x, a.mass, wf, h2, topo, part=True))
    args = (force[0], x, diag, a.mass, wf, h2, a.node_mask, topo, cfg.cg_iterations,
            cfg.cg_rtol, failed, block)
    sol = assembly.pcg_solve(*args)
    out["T11"] = (sol, assembly.pcg_solve_plain(*args))
    c, d = clone_state(a), clone_state(a)
    pd.substep_tail(c, topo, params, active, sol[0], force[1])
    pd.substep_tail_plain(d, topo, params, active, sol[0], force[1])
    out["T4"] = ((c.positions, c.velocities, c.forces, c.sim_failed),
                 (d.positions, d.velocities, d.forces, d.sim_failed))
    return out


ROUNDOFF = ("rows bend", "rows shape", "quats")  # acosf, sinf, cosf against torch's


CARD_CASES = ["cube", "cloth", "soup", "star"]  # T10's ELL, ELL width 9, band, CSR


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES)
def test_batched_kernels_equal_the_twins_member_loop(cuda, case):
    states, topo, params, cfg = _card_ensemble(cuda, case)
    assert (topo.csr_start is not None) == (case == "star")
    states.sim_failed[1, 0] = 1  # a latched member in the batch
    out = _stages(states, topo, params, cfg)
    torch.cuda.synchronize()
    for stage, (k, p) in out.items():
        for i, (a, b) in enumerate(zip(k, p)):
            # A latched member's outputs are not written by the kernels (the
            # state, the residual partials and the trip count are).
            if not (stage == "T4" or (stage == "T11" and i > 0)):
                a, b = a[[0, 2]], b[[0, 2]]
            if stage in ROUNDOFF:
                assert float((a - b).abs().max()) <= 1e-6 * max(float(b.abs().max()), 1.0), stage
            else:
                assert torch.equal(a, b), stage
    trips = out["T11"][0][2]
    assert trips[1, 0] == 0 and trips[0, 0] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES)
def test_one_member_equals_the_single_scene_kernels(cuda, case):
    """B = 1 gives the unbatched call's outputs, bit for bit."""
    states, topo, params, cfg = _card_ensemble(cuda, case, members=1)
    batched = _stages(states, topo, params, cfg)
    single = _stages(unstack(states, 0), topo, params, cfg)
    torch.cuda.synchronize()
    for stage in batched:
        for a, b in zip(batched[stage][0], single[stage][0]):
            assert torch.equal(a.reshape(b.shape), b), stage
