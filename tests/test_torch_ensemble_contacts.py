"""The port's ensembles on the generic PD path with point-triangle
self-contact (``pies_tpu_torch.parallel.ensemble``, ROADMAP item 10b-ii)
against the JAX package's vmapped ``ensemble_tick``.

Cases (``scene.contact_piles.add_tet_boxes``: two tet boxes, the upper
thrown down onto the lower, in contact from tick ~5; the JAX solvers with
``dense_operator_max=0``; member 0 as built, each other member's live nodes
moved by its own seeded offset, uniform ±0.02):

* ``allpairs``: B = 3, member 2 latched before the start, the Solver's
  defaults (96 triangles: the all-pairs branch, T16 + T17, recentered
  coupling, the dense floor);
* ``super``: B = 2 with ``allpairs_broadphase_max=0`` (the super-body
  layout, T14 + T15, with its per-member cache);
* ``full_entry``: B = 2 with ``contact_coupling="full"`` and
  ``dense_floor=False`` (T23's blocks in the operator and the force, T24's
  entry-list floor).

The JAX solvers run with ``unroll_loops=False``, the JAX package's
``fori_loop`` form of the same PD and stabilization iterations, which its
own note (``pies_tpu/options.py:122-128``) prescribes for vmapped
rollouts: JAX then traces one iteration instead of four, and each case
compiles about three times faster (all-pairs 17 s against 51 s on the
CPU; tracing, not the 0.03 s ticks, is what these cases cost).

Each JAX ensemble warms ``WARM`` ticks, its state is carried across with
``convert.state_from_numpy`` (the super-body cache included) and both
packages step the same arrays for ``TICKS`` ticks.  Before every tick each
member's contacts are detected by both packages on the predicted positions
of the tick's first substep (the port's detection batched, on a copy of the
cache) and must be equal as sets; the latch fires on the same tick (never:
the boxes stay inside every cap).

Tolerances.  One tick, 3e-6 (a few float32 ulps at |x| ≈ 2; measured on
the CPU: 4.8e-7 to 1.4e-6 over the cases' live members).  Over the window
each member within 3x the JAX package's own float32 spread on it (its
window from the start with half the live coordinates moved one ulp, the
largest gap over the window; ``tests/test_torch_ensemble_generic.py``'s
factor): measured on the CPU, the port parts by 4.3e-6 to 6.4e-6 against
spreads of 4.5e-6 to 2.4e-4, at most 1.17x the spread (full coupling,
member 0).  The latched member is bit-unchanged with residual 0 in both packages.

Within the port, without JAX: every member equals its single-scene run,
positions, contacts, rebuilds and CG trips per tick, in the cell-list,
per-body and reference branches as in the three above; ``ensemble_tick_n``
equals that many ticks and ``ensemble_step`` reduces over the members; the
per-member counters of a small box pile (phase 16b's scene) equal each
member's own.

The ``gpu`` tests hold each batched stage of the path (T14, T15, T16 in its
four branches, T17, T7's setup and force, T9's stage 2 with the contact
terms, T23 in T10 and T9, T24, T8 and T4) at B = 3 with a latched member to
its twins' member loop on identical inputs, bit for bit, and B = 1 to the
unbatched call; they skip without a card.
"""

import dataclasses

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
from pies_tpu_torch.parallel import ensemble
from pies_tpu_torch.scene.contact_piles import (
    BRANCHES, add_box_pile, add_tet_boxes, branch_scene, jitter_offsets, jittered_ensemble)
from pies_tpu_torch.solver import pd, step, tetcols
from pies_tpu_torch.solver.stages import contact_stages, stages_apart
from pies_tpu_torch.state import clone_state, member, unstack

from torch_threads import two_threads  # noqa: F401

WARM, TICKS = 3, 8
STEP_TOL = 3e-6
SPREAD_FACTOR = 3.0
FIELDS = ("positions", "prev_positions", "velocities", "forces", "sim_failed")

# case -> (Solver arguments, StepConfig fields, members, latched member, branch)
CASES = {
    "allpairs": ({}, {}, 3, 2, "allpairs"),
    "super": (dict(allpairs_broadphase_max=0), {}, 2, None, None),
    "full_entry": (dict(contact_coupling="full"), dict(dense_floor=False), 2, None, "allpairs"),
}


def _offsets(members, live):
    return jitter_offsets(members, live, seed0=100)


def _contact_sets(pt_idx, pt_mask):
    """Each member's contacts as a set of (a, b, c, d) rows."""
    return [{tuple(int(v) for v in row) for row, m in zip(idx, mask) if m > 0}
            for idx, mask in zip(np.asarray(pt_idx), np.asarray(pt_mask))]


@pytest.fixture(scope="module", params=list(CASES))
def reference(request):
    """The JAX ensemble of a case: its start after ``WARM`` ticks (NumPy
    leaves), then per tick of the window the positions, residuals, latch
    and each member's contact set, and its own float32 spread per member."""
    case = request.param
    kw, fields, members, latched, _ = CASES[case]
    j = pies_tpu.Solver(JOptions(solver=JName.PD), enable_collisions=True,
                        dense_operator_max=0, **kw)
    add_tet_boxes(j)
    j._prepare()
    topo, params = j._topology, j.current_params()
    cfg = dataclasses.replace(j._config, unroll_loops=False, **fields)
    live = j._builder.num_nodes
    st = jax.tree.map(lambda a: np.repeat(np.asarray(a)[None], members, 0), j._state)
    off = _offsets(members, live)
    pos, prev = st.positions.copy(), st.prev_positions.copy()
    pos[:, :live] += off
    prev[:, :live] += off
    failed = np.zeros(members, bool)
    if latched is not None:
        failed[latched] = True
    st = dataclasses.replace(st, positions=pos, prev_positions=prev, sim_failed=failed)
    tick = jax.jit(jens.ensemble_tick, static_argnames=("config",))

    @jax.jit
    def contacts(states):
        def one(s):
            x = s.positions + params.dt * s.velocities * s.node_mask[:, None]
            out = jdetect(x, s.prev_positions, topo.triangles, topo.tri_mask, params, cfg,
                          cache=s.bp, corners=topo.super_corners, adj=topo.super_adj)
            return out[0], jax.numpy.where(s.sim_failed, 0.0, out[1])
        return jax.vmap(one)(states)

    states = jax.tree.map(jax.numpy.asarray, st)
    for _ in range(WARM):
        states, _ = tick(states, topo, params, config=cfg)
    start = jax.tree.map(np.asarray, states)
    xs, res, latch, sets = [], [], [], []
    for _ in range(TICKS):
        sets.append(_contact_sets(*contacts(states)))
        states, r = tick(states, topo, params, config=cfg)
        xs.append(np.asarray(states.positions)[:, :live])
        res.append(np.asarray(r))
        latch.append(np.asarray(states.sim_failed).tolist())
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
    return dict(case=case, start=start, pos=np.stack(xs), res=res, latch=latch, sets=sets,
                spread=spread, live=live, topo=jax.tree.map(np.asarray, topo), cfg=cfg,
                params=jax.tree.map(np.asarray, params))


def _port(ref):
    cfg = ref["cfg"]
    return (convert.state_from_numpy(ref["start"]),
            convert.topology_from_numpy(ref["topo"], tet_fused=cfg.tet_fused),
            convert.params_from(ref["params"]), convert.config_from(cfg))


def _port_contacts(states, topo, params, cfg):
    """Each member's contacts of the next tick's first substep, detected in
    one batched call on a copy of the cache."""
    h = float(np.float32(params.dt))
    x = states.positions + h * states.velocities * states.node_mask[..., None]
    bp = clone_state(states.bp) if states.bp is not None else None
    pt_idx, pt_mask, _, _, _ = broadphase.detect_point_tri_collisions(
        x, states.prev_positions, topo.tri_mask, params, cfg, cache=bp,
        failed=states.sim_failed, corners=topo.super_corners, adj=topo.super_adj,
        triangles=topo.triangles)
    return _contact_sets(pt_idx.numpy(), pt_mask.numpy())


@pytest.fixture(scope="module")
def port_run(reference):
    """The port's window: positions, residuals, per-member counters and
    contact sets per tick, the final state and the start."""
    states, topo, params, cfg = _port(reference)
    start = clone_state(states)
    pos, counts, res, sets, latch = [], [], [], [], []
    for _ in range(TICKS):
        sets.append(_port_contacts(states, topo, params, cfg))
        c = pd.new_counters("cpu", states.members)
        res.append(ensemble.ensemble_tick(states, topo, params, cfg, counters=c).numpy())
        pos.append(states.positions[:, :reference["live"]].numpy().copy())
        counts.append({k: v.tolist() for k, v in c.items()})
        latch.append((states.sim_failed != 0).any(-1).tolist())
    return dict(pos=np.stack(pos), counts=counts, res=res, sets=sets, latch=latch,
                states=states, start=start, env=(topo, params, cfg))


def test_the_case_takes_its_branch(reference):
    states, topo, _, cfg = _port(reference)
    _, _, members, _, branch = CASES[reference["case"]]
    assert states.members == members
    assert not tetcols.applies(states, topo, cfg)
    assert broadphase.tri_mode(cfg, topo.tri_mask.shape[0]) == branch
    if branch is None:  # the super-body layout with the members' caches
        assert broadphase.super_body(cfg)
        assert tuple(states.bp.pairs.shape) == (members, cfg.super_k,
                                                cfg.budget.max_narrow_bodies)
        assert tuple(states.bp.ref.shape) == (members, states.capacity, 3)
    assert cfg.contact_coupling == ("full" if reference["case"] == "full_entry" else "recentered")
    assert cfg.dense_floor == (reference["case"] != "full_entry")


def test_one_tick_matches_reference(reference, port_run):
    d = np.abs(port_run["pos"][0] - reference["pos"][0]).reshape(len(reference["spread"]), -1)
    assert (d.max(1) <= STEP_TOL).all(), d.max(1)


def test_window_matches_reference(reference, port_run):
    """Each member within 3x the JAX package's own spread; contact sets
    equal per member and tick, and live in every unlatched member; the
    latch on the same tick; the latched member bit-unchanged, residual 0
    and counting nothing."""
    _, _, members, latched, _ = CASES[reference["case"]]
    assert port_run["sets"] == reference["sets"]
    assert port_run["latch"] == [[bool(f) for f in t] for t in reference["latch"]]
    d = np.abs(port_run["pos"] - reference["pos"]).reshape(TICKS, members, -1).max(-1)
    for b in range(members):
        if b == latched:
            assert not d[:, b].any() and all(float(r[b]) == 0.0 for r in reference["res"])
            assert all(float(r[b]) == 0.0 for r in port_run["res"])
            assert all(c[k][b] == 0 for c in port_run["counts"] for k in c)
            assert not any(s[b] for s in port_run["sets"])
            continue
        assert sum(c["contacts"][b] for c in port_run["counts"]) > 0, b
        assert any(s[b] for s in reference["sets"]), b
        assert 0.0 < reference["spread"][b]
        assert (d[:, b] <= SPREAD_FACTOR * reference["spread"][b]).all(), (
            b, d[:, b], reference["spread"][b])
    assert np.isfinite(port_run["pos"]).all()


def test_members_equal_their_single_scene_runs(reference, port_run):
    """Every member, contact and rebuild counts and CG trips per tick
    included, bit-equal to its single-scene run."""
    topo, params, cfg = port_run["env"]
    states = port_run["states"]
    for b in range(states.members):
        single = unstack(port_run["start"], b)
        for t in range(TICKS):
            c = pd.new_counters("cpu")
            step.tick(single, topo, params, cfg, counters=c)
            for k in ("contacts", "rebuilds", "cg_trips", "floor_active"):
                assert int(c[k]) == port_run["counts"][t][k][b], (b, t, k)
        after = member(states, b)
        for f in FIELDS:
            assert torch.equal(getattr(after, f), getattr(single, f)), (b, f)
        if states.bp is not None:
            assert torch.equal(after.bp.pairs, single.bp.pairs), b


# ---------------------------------------------------------------------------
# within the port: the other branches, tick_n and step, the counters


def _members(s, members, latched=None):
    """The prepared scene's ensemble with the JAX cases' offsets (seeds
    100 + b), member ``latched`` latched."""
    states = jittered_ensemble(s.state, members, s._builder.num_nodes, seed0=100)
    if latched is not None:
        states.sim_failed[latched, 0] = 1
    return states


# branch -> ticks before the compared window (the soup's tets meet from tick
# 32 in members 0 and 1; at tick 36 member 1's per-body rows overflow and it
# latches)
BRANCH_WARM = {"celllist": 3, "reference": 3, "bodies": 31}


@pytest.mark.parametrize("kind", list(BRANCH_WARM))
def test_branch_members_equal_their_single_scene_runs(kind):
    """B = 3 with member 2 latched: each member's state and counters over 4
    ticks equal its single-scene run's; contacts live in the others."""
    s, cfg = branch_scene(kind, "cpu")
    topo, params = s.topology, s.current_params()
    assert broadphase.tri_mode(cfg, topo.tri_mask.shape[0]) == kind
    states = _members(s, 3, latched=2)
    ensemble.ensemble_tick_n(states, topo, params, cfg, BRANCH_WARM[kind])
    singles = [unstack(states, b) for b in range(3)]
    contacts = np.zeros(3, np.int64)
    for _ in range(4):
        c = pd.new_counters("cpu", 3)
        ensemble.ensemble_tick(states, topo, params, cfg, counters=c)
        contacts += c["contacts"].numpy()
        for b, single in enumerate(singles):
            cs = pd.new_counters("cpu")
            step.tick(single, topo, params, cfg, counters=cs)
            assert all(int(cs[k]) == int(c[k][b]) for k in cs), (b, cs, c)
    for b, single in enumerate(singles):
        for f in FIELDS:
            assert torch.equal(getattr(member(states, b), f), getattr(single, f)), (b, f)
    assert contacts[2] == 0 and contacts[:2].min() > 0, contacts


def test_tick_n_and_step_reduce_over_members():
    """The super-body boxes at B = 3 with member 2 latched:
    ``ensemble_tick_n(4)`` equals four ``ensemble_tick`` calls (the caches
    too) and returns the largest last residual; ``ensemble_step`` returns
    that and the latched count."""
    s, cfg = branch_scene("super", "cpu")
    topo, params = s.topology, s.current_params()
    a = _members(s, 3, latched=2)
    b, c = clone_state(a), clone_state(a)
    res_n = ensemble.ensemble_tick_n(a, topo, params, cfg, 4)
    for _ in range(4):
        res = ensemble.ensemble_tick(b, topo, params, cfg)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(a.bp.pairs, b.bp.pairs) and torch.equal(a.bp.ref, b.bp.ref)
    assert float(res_n) == float(res.max()) and float(res[2]) == 0.0 and float(res[:2].min()) > 0
    for _ in range(3):
        ensemble.ensemble_tick(c, topo, params, cfg)
    max_res, num_failed = ensemble.ensemble_step(c, topo, params, cfg)
    assert float(max_res) == float(res.max()) and int(num_failed) == 1
    assert torch.equal(c.positions, b.positions)


def test_counters_are_per_member_on_a_box_pile():
    """Two ``create_box``es 0.05 apart (phase 16b's box pile, cut to two
    boxes), B = 2: the per-member contact and rebuild counters equal each
    member's single-scene counters on every tick (they once added member
    0's count to every member)."""
    s = pt.Solver(pt.SolverOptions(), enable_collisions=True, device="cpu")
    add_box_pile(s, 2, gap=0.05)
    s._prepare()
    topo, params, cfg = s.topology, s.current_params(), s.config
    assert broadphase.tri_mode(cfg, topo.tri_mask.shape[0]) == "allpairs"
    states = _members(s, 2)
    singles = [unstack(states, b) for b in range(2)]
    per_member = []
    for _ in range(6):
        c = pd.new_counters("cpu", 2)
        ensemble.ensemble_tick(states, topo, params, cfg, counters=c)
        for b, single in enumerate(singles):
            cs = pd.new_counters("cpu")
            step.tick(single, topo, params, cfg, counters=cs)
            assert int(cs["contacts"]) == int(c["contacts"][b]), b
            assert int(cs["rebuilds"]) == int(c["rebuilds"][b]), b
        per_member.append(c["contacts"].tolist())
    per_member = np.asarray(per_member)
    assert per_member.sum(0).min() > 0 and (per_member[:, 0] != per_member[:, 1]).any()


# ---------------------------------------------------------------------------
# the batched kernels on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _card_ensemble(dev, kind, members=3, ticks=6):
    """A ``members``-member ensemble of a branch scene on ``dev``, after
    ``ticks`` kernel ticks (the soup of the per-body branch after 31, when
    its tets meet)."""
    s, cfg = branch_scene(kind, dev)
    states = _members(s, members)
    ensemble.ensemble_tick_n(states, s.topology, s.current_params(), cfg,
                             BRANCH_WARM["bodies"] if kind == "bodies" else ticks)
    return states, s.topology, s.current_params(), cfg


def test_contact_stages_run_on_the_cpu():
    """The stage chain the card tests and ``chip_smoke.py`` phase 16c hold
    kernel against twin runs on the CPU (where every wrapper takes its
    twin), each stage's two outputs equal."""
    states, topo, params, cfg = _card_ensemble("cpu", "full_entry")
    states.sim_failed[2, 0] = 1
    out = contact_stages(states, topo, params, cfg)
    assert {"T24", "detection", "T7 setup", "T9 stage 2", "T10", "T11", "T8", "T4"} <= set(out)
    assert stages_apart(out, [0, 1]) == []
    counts = out["detection"][0][2][:, 0].tolist()
    assert counts[2] == 0 and min(counts[:2]) > 0, counts


@pytest.mark.gpu
@pytest.mark.parametrize("scene", BRANCHES)
def test_batched_contact_kernels_equal_the_twins_member_loop(cuda, scene):
    """B = 3 with member 2 latched: every stage's kernel outputs equal its
    twins' member loop on identical inputs, bit for bit."""
    states, topo, params, cfg = _card_ensemble(cuda, scene)
    states.sim_failed[2, 0] = 1  # a latched member in the batch
    out = contact_stages(states, topo, params, cfg)
    torch.cuda.synchronize()
    assert stages_apart(out, [0, 1]) == []
    counts = out["detection"][0][2][:, 0].tolist()
    assert counts[2] == 0 and max(counts[:2]) > 0, counts


@pytest.mark.gpu
@pytest.mark.parametrize("scene", BRANCHES)
def test_one_member_equals_the_single_scene_contact_kernels(cuda, scene):
    """B = 1 gives the unbatched call's outputs, bit for bit."""
    states, topo, params, cfg = _card_ensemble(cuda, scene, members=1)
    batched = contact_stages(states, topo, params, cfg)
    single = contact_stages(unstack(states, 0), topo, params, cfg)
    torch.cuda.synchronize()
    for stage in batched:
        for a, b in zip(batched[stage][0], single[stage][0]):
            assert torch.equal(a.reshape(b.shape), b), stage
