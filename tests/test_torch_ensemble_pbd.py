"""The port's PBD ensembles (``pies_tpu_torch.parallel.ensemble`` under
``SolverName.PBD``, ROADMAP item 10b-iv) against the JAX package's vmapped
``ensemble_tick``.

Cases: the scenes of ``tests/test_torch_pbd.py`` (the JAX ``Solver`` and
the port's build them alike), stacked and each member's live nodes moved by
``contact_piles.jitter_offsets`` (uniform ±0.02, seeds 101, 102; member 0
as built), stepped from the start:

* ``rope``: 2 ropes of 128 nodes, collisions on (the node-pair cache), the
  chain walk; B = 3 with member 1 latched before the start;
* ``pile``: 512 nodes, collisions on; B = 3 (every member rebuilds its
  cache every tick while the pile falls, each on its own iterations);
* ``net``: the 8 x 8 net, the colour classes; B = 2;
* ``tet_box_quirks``, ``tet_box_fixed``: the tet box in both
  ``reference_quirks`` modes (strain); B = 2;
* ``bend_sheet``: ``create_bend_sheet`` (bend); B = 2.

Tolerances.  One tick within 3e-6 (``tests/test_torch_pbd.py``'s bound).
Over the 10-tick window each member within 3x the JAX package's own
float32 spread on it (its window from the start with half the live
coordinates moved one ulp, the largest gap over the window), as
``tests/test_torch_ensemble_generic.py`` does; the latched member
bit-unchanged in both packages, residual 0.  Measured on the CPU: one tick
within 1.4e-6; over the window the port parts by at most 0.95x the spread
(the fixed tet box's member 1, 7.2e-6 against 7.5e-6), by 8.6e-6 against
1.2e-5 on the rope, 2.1e-5 against 5.0e-5 on the pile, 0.31 against 0.39 on
the quirk-mode tet box (it flattens on the floor plane at tick 2, where the
JAX package's own run from one ulp away parts as far).  With collisions on, each
member's pair cache after every tick holds the JAX package's pairs (the
prefix as a set, and its count), and is rebuilt on the same ticks.

Within the port everything is exact: each member equals its single-scene
run, counters included; ``ensemble_tick_n`` equals that many
``ensemble_tick`` calls; ``ensemble_step`` reduces over the members.  And
the repairs of this slice: the latch fold per member (member 1's slot 1
does not latch member 0), the counters per member, the node-node response
over ``x.shape[-2]`` nodes with a cache per member, and
``convert.node_cache_from_numpy`` for a vmapped cache.

The ``gpu`` tests hold each stage of ``solver/stages.pbd_stages`` at B = 3
(member 1 latched) to its twins' member loop on the kernels' inputs (bit
for bit, the bend rows within 1e-6: ``acosf`` against ``torch.acos``), and
B = 1 to the unbatched call; they skip without a card.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import pies_tpu
from pies_tpu.options import SolverName as JName, SolverOptions as JOptions
from pies_tpu.parallel import ensemble as jens
import pies_tpu_torch as pt
from pies_tpu_torch import convert
from pies_tpu_torch.collision import broadphase
from pies_tpu_torch.parallel import ensemble
from pies_tpu_torch.scene.contact_piles import jitter_offsets, jittered_ensemble
from pies_tpu_torch.solver import pbd, step
from pies_tpu_torch.solver.stages import PBD_ROUNDOFF, PBD_WHOLE, pbd_stages, stages_apart
from pies_tpu_torch.state import (
    clone_state, member, pair_incidence, stack_ensemble, unstack)

from test_torch_pbd import SCENES
from torch_threads import two_threads  # noqa: F401

TICKS = 10
STEP_TOL = 3e-6
SPREAD_FACTOR = 3.0
SEED0 = 100

# case -> (members, latched member)
CASES = {
    "rope": (3, 1),
    "pile": (3, None),
    "net": (2, None),
    "tet_box_quirks": (2, None),
    "tet_box_fixed": (2, None),
    "bend_sheet": (2, None),
}


def _jax_solver(case):
    build, kw = SCENES[case]
    j = build(pies_tpu.Solver(JOptions(solver=JName.PBD), **kw))
    j._prepare()
    return j


def _cache_np(nn):
    """A vmapped JAX cache's (count, pi, pj, ref) as numpy, or None."""
    if nn is None:
        return None
    return tuple(np.asarray(getattr(nn, f)).copy() for f in ("count", "pi", "pj", "ref"))


def _window(tick, states, live, topo, params, cfg):
    """``TICKS`` JAX ensemble ticks: positions, residuals, latch and cache
    per tick."""
    xs, res, latch, caches = [], [], [], []
    for _ in range(TICKS):
        states, r = tick(states, topo, params, config=cfg)
        xs.append(np.asarray(states.positions)[:, :live])
        res.append(np.asarray(r))
        latch.append(np.asarray(states.sim_failed).tolist())
        caches.append(_cache_np(states.nn))
    return np.stack(xs), res, latch, caches, states


@pytest.fixture(scope="module", params=list(CASES))
def reference(request):
    """The JAX ensemble of a case: its start as NumPy leaves, the window's
    positions, residuals, latch and pair caches per tick, and its own
    float32 spread per member."""
    case = request.param
    members, latched = CASES[case]
    j = _jax_solver(case)
    live = j._builder.num_nodes
    topo, params, cfg = j._topology, j.current_params(), j._config
    st = jax.tree.map(lambda a: np.repeat(np.asarray(a)[None], members, 0), j._state)
    off = jitter_offsets(members, live, seed0=SEED0)
    pos, prev = st.positions.copy(), st.prev_positions.copy()
    pos[:, :live] += off
    prev[:, :live] += off
    failed = np.zeros(members, bool)
    if latched is not None:
        failed[latched] = True
    start = dataclasses.replace(st, positions=pos, prev_positions=prev, sim_failed=failed)
    tick = jax.jit(jens.ensemble_tick, static_argnames=("config",))
    xs, res, latch, caches, last = _window(tick, jax.tree.map(jax.numpy.asarray, start), live,
                                           topo, params, cfg)
    rng = np.random.default_rng(7)
    x = start.positions[:, :live]
    inf = np.where(rng.random(x.shape) < 0.5, np.float32(np.inf), np.float32(-np.inf))
    moved = np.where(rng.random(x.shape) < 0.5, np.nextafter(x, inf), x)
    perturbed = dataclasses.replace(
        start, positions=np.concatenate([moved, start.positions[:, live:]], axis=1))
    other = _window(tick, jax.tree.map(jax.numpy.asarray, perturbed), live, topo, params, cfg)[0]
    spread = np.abs(other - xs).reshape(TICKS, members, -1).max(-1).max(0)
    return dict(case=case, start=start, pos=xs, res=res, latch=latch, caches=caches,
                spread=spread, live=live, last=jax.tree.map(np.asarray, last),
                topo=jax.tree.map(np.asarray, topo), cfg=cfg,
                params=jax.tree.map(np.asarray, params))


def _port(ref):
    """The port's ensemble at the reference's start (its node-pair cache
    carried per member), with topology, parameters and configuration."""
    return (convert.state_from_numpy(ref["start"]), convert.topology_from_numpy(ref["topo"]),
            convert.params_from(ref["params"]), convert.config_from(ref["cfg"]))


@pytest.fixture(scope="module")
def port_run(reference):
    """The port's window: positions, per-member counters, residuals and
    caches per tick, the final state and the start."""
    states, topo, params, cfg = _port(reference)
    start = clone_state(states)
    pos, counts, res, caches = [], [], [], []
    for _ in range(TICKS):
        c = pbd.new_counters("cpu", states.members)
        res.append(ensemble.ensemble_tick(states, topo, params, cfg, counters=c).numpy())
        pos.append(states.positions[:, :reference["live"]].numpy().copy())
        counts.append({k: v.tolist() for k, v in c.items()})
        caches.append(None if states.nn is None else states.nn.clone())
    return dict(pos=np.stack(pos), counts=counts, res=res, caches=caches, states=states,
                start=start, env=(topo, params, cfg))


def test_the_ensemble_carries_a_cache_per_member(reference):
    """With collisions on, the carried start has a node-pair cache per
    member (every field with the member axis), each stale (fresh 0)."""
    states, _, _, cfg = _port(reference)
    members = CASES[reference["case"]][0]
    assert states.members == members and cfg.solver == pt.SolverName.PBD
    assert (states.nn is not None) == cfg.enable_collisions
    if states.nn is not None:
        for f in dataclasses.fields(states.nn):
            assert getattr(states.nn, f.name).shape[0] == members, f.name
        assert states.nn.fresh.tolist() == [[0]] * members


def test_one_tick_matches_reference(reference, port_run):
    members = CASES[reference["case"]][0]
    d = np.abs(port_run["pos"][0] - reference["pos"][0]).reshape(members, -1).max(1)
    assert (d <= STEP_TOL).all(), d


def test_window_matches_reference(reference, port_run):
    """Each member within 3x the JAX package's own spread over the window;
    the latched member bit-unchanged, residual 0 and nothing counted; the
    latch equal on every tick."""
    members, latched = CASES[reference["case"]]
    d = np.abs(port_run["pos"] - reference["pos"]).reshape(TICKS, members, -1).max(-1)
    start = port_run["start"]
    for b in range(members):
        if b == latched:
            assert not d[:, b].any() and all(r[b] == 0.0 for r in reference["res"])
            assert all(float(r[b]) == 0.0 for r in port_run["res"])
            assert all(c[k][b] == 0 for c in port_run["counts"] for k in c)
            after, before = member(port_run["states"], b), member(start, b)
            for f in ("positions", "prev_positions", "velocities", "sim_failed"):
                assert torch.equal(getattr(after, f), getattr(before, f)), f
            if after.nn is not None:
                for f in dataclasses.fields(after.nn):
                    assert torch.equal(getattr(after.nn, f.name), getattr(before.nn, f.name))
            continue
        assert 0.0 < reference["spread"][b]
        assert (d[:, b] <= SPREAD_FACTOR * reference["spread"][b]).all(), (
            b, d[:, b], reference["spread"][b])
    assert [[bool(f) for f in t] for t in reference["latch"]] == [
        [b == latched for b in range(members)]] * TICKS
    assert np.isfinite(port_run["pos"]).all()
    assert all(float(np.abs(r).max()) == 0.0 for r in port_run["res"])
    if reference["case"] == "pile":  # (the others are above the floor in the window)
        assert min(sum(c["floor_active"][b] for c in port_run["counts"])
                   for b in range(members)) > 0


def _pairs(pi, pj, count):
    return set(zip(np.asarray(pi)[:count].tolist(), np.asarray(pj)[:count].tolist()))


def test_pair_caches_match_reference(reference, port_run):
    """Each member's cache after every tick: its count and its pairs (as a
    set) the JAX package's, rebuilt on the JAX package's ticks; the ropes'
    members rebuild on different ticks, the pile's members a different
    number of times within a tick."""
    if reference["caches"][0] is None:
        pytest.skip("no node-pair cache: collisions off")
    members, latched = CASES[reference["case"]]
    jax_prev = np.asarray(reference["start"].nn.ref)
    ticks = {b: [] for b in range(members)}
    for t in range(TICKS):
        count, pi, pj, ref = reference["caches"][t]
        nn = port_run["caches"][t]
        for b in range(members):
            c = int(count[b])
            assert int(nn.count[b, 0]) == c, (t, b)
            assert _pairs(nn.pi[b], nn.pj[b], c) == _pairs(pi[b], pj[b], c), (t, b)
            rebuilt = not np.array_equal(ref[b], jax_prev[b])
            assert (port_run["counts"][t]["rebuilds"][b] > 0) == rebuilt, (t, b)
            if rebuilt:
                ticks[b].append(t)
        jax_prev = ref
    live = [b for b in range(members) if b != latched]
    assert all(ticks[b] for b in live) and not (latched is not None and ticks[latched])
    if reference["case"] == "rope":
        assert len({tuple(ticks[b]) for b in live}) > 1, ticks
    else:
        per_tick = [tuple(c["rebuilds"]) for c in port_run["counts"]]
        assert any(len(set(r)) > 1 for r in per_tick), per_tick


def test_members_equal_their_single_scene_runs(reference, port_run):
    """Every member bit-equal to its single-scene run, cache and counters
    included."""
    topo, params, cfg = port_run["env"]
    states = port_run["states"]
    for b in range(states.members):
        single = unstack(port_run["start"], b)
        mine = []
        for _ in range(TICKS):
            c = pbd.new_counters("cpu")
            step.tick(single, topo, params, cfg, counters=c)
            mine.append({k: int(v) for k, v in c.items()})
        after = member(states, b)
        for f in ("positions", "prev_positions", "velocities", "sim_failed"):
            assert torch.equal(getattr(after, f), getattr(single, f)), (b, f)
        if single.nn is not None:
            for f in dataclasses.fields(single.nn):
                assert torch.equal(getattr(after.nn, f.name), getattr(single.nn, f.name)), f
        assert mine == [{k: v[b] for k, v in c.items()} for c in port_run["counts"]], b


def _rope(members=3, latched=1):
    """The port's rope case at ``members``, member ``latched`` latched."""
    build, kw = SCENES["rope"]
    s = build(pt.Solver(pt.SolverOptions(solver=pt.SolverName.PBD), device="cpu", **kw))
    s._prepare()
    states = jittered_ensemble(s.state, members, s._builder.num_nodes, seed0=SEED0)
    if latched is not None:
        states.sim_failed[latched, 0] = 1
    return states, (s.topology, s.current_params(), s.config)


def test_tick_n_and_step_reduce_over_members():
    """``ensemble_tick_n(4)`` equals four ``ensemble_tick`` calls, caches
    and counters too, and returns the largest residual (0 under PBD);
    ``ensemble_step`` returns it and the latched count."""
    a, env = _rope()
    b, c = clone_state(a), clone_state(a)
    ca, cb = pbd.new_counters("cpu", 3), pbd.new_counters("cpu", 3)
    res_n = ensemble.ensemble_tick_n(a, *env, 4, counters=ca)
    for _ in range(4):
        res = ensemble.ensemble_tick(b, *env, counters=cb)
    assert torch.equal(a.positions, b.positions) and torch.equal(a.nn.pi, b.nn.pi)
    assert all(torch.equal(ca[k], cb[k]) for k in ca) and int(ca["touching"][0]) > 0
    assert float(res_n) == 0.0 and res.shape == (3,) and not res.any()
    for _ in range(3):
        ensemble.ensemble_tick(c, *env)
    max_res, num_failed = ensemble.ensemble_step(c, *env)
    assert float(max_res) == 0.0 and int(num_failed) == 1
    assert torch.equal(c.positions, b.positions)


def test_the_latch_folds_per_member():
    """Member 1's latch slot 1 (a failure in its last substep) latches
    member 1 alone at the next tick's fold: member 0 steps on, member 1
    stays as it is and counts nothing."""
    states, env = _rope(latched=None)
    states.sim_failed[1, 1] = 1
    start = clone_state(states)
    c = pbd.new_counters("cpu", 3)
    ensemble.ensemble_tick(states, *env, counters=c)
    assert states.sim_failed.tolist() == [[0, 0], [1, 1], [0, 0]]
    assert torch.equal(states.positions[1], start.positions[1])
    assert not torch.equal(states.positions[0], start.positions[0])
    assert c["floor_active"].shape == (3,) and [int(c[k][1]) for k in c] == [0] * len(c)
    assert int(c["pairs"][0]) > 0 and int(c["rebuilds"][2]) > 0


def test_node_response_takes_the_node_axis():
    """``pbd_node_node_response`` on an ensemble with no cache (the JAX
    package's uncached form) builds a cache per member over ``x.shape[-2]``
    nodes: each member's response equals its single-scene call."""
    states, env = _rope(latched=None)
    _, params, cfg = env
    x, vel = states.positions.clone(), states.velocities.clone()
    vel += torch.from_numpy(np.random.default_rng(5).normal(0, 1.0, vel.shape).astype(np.float32))
    out = broadphase.pbd_node_node_response(states, x, vel, params, cfg, None)
    assert out[2].shape == (3, 1) and out[3].tolist() == [[1]] * 3
    for b in range(3):
        one = broadphase.pbd_node_node_response(member(states, b), x[b], vel[b], params, cfg, None)
        for k in range(4):
            assert torch.equal(out[k][b], one[k]), (b, k)
    assert int(out[2].sum()) > 0


def test_convert_carries_a_vmapped_node_cache(reference):
    """A vmapped JAX cache (count i32[B], ref f32[B, N, 3]) comes across as
    the port's batched cache: each member equal to the single-scene
    conversion of its slice, with the incidence of its own prefix."""
    last = reference["last"]
    if last.nn is None:
        pytest.skip("no node-pair cache: collisions off")
    nn = convert.node_cache_from_numpy(last.nn)
    members = CASES[reference["case"]][0]
    assert nn.count.shape == (members, 1) and nn.ref.shape == last.nn.ref.shape
    n = nn.ref.shape[-2]
    for b in range(members):
        one = convert.node_cache_from_numpy(jax.tree.map(lambda a: a[b], last.nn))
        for f in dataclasses.fields(one):
            assert torch.equal(getattr(member(nn, b), f.name), getattr(one, f.name)), f.name
        c = int(last.nn.count[b])
        assert int(nn.count[b, 0]) == c and (c > 0) == bool(last.nn.fresh[b])
        for t, u in zip(pair_incidence(nn.pi[b], nn.pj[b], c, n),
                        (nn.row_off[b], nn.inc_start[b], nn.inc_pair[b])):
            assert torch.equal(t, u)
        np.testing.assert_array_equal(nn.pi[b].numpy(), last.nn.pi[b])
        np.testing.assert_array_equal(nn.ref[b].numpy(), last.nn.ref[b])
    assert nn.fresh[:, 0].tolist() == last.nn.fresh.astype(int).tolist()


def test_stack_ensemble_copies_the_node_cache():
    """``stack_ensemble`` gives the node-pair cache a member axis on every
    field, members that share no memory, and ``unstack`` a single scene's
    cache."""
    build, kw = SCENES["pile"]
    s = build(pt.Solver(pt.SolverOptions(solver=pt.SolverName.PBD), device="cpu", **kw))
    s._prepare()
    s.run_ticks(2)
    states = stack_ensemble(s.state, 3)
    for f in dataclasses.fields(states.nn):
        t, one = getattr(states.nn, f.name), getattr(s.state.nn, f.name)
        assert t.shape == (3,) + one.shape and t.is_contiguous(), f.name
        assert torch.equal(t[2], one)
    states.nn.pi[1].add_(1)
    states.nn.count[1] += 1
    assert torch.equal(states.nn.pi[0], s.state.nn.pi) and int(states.nn.count[0, 0]) > 0
    single = unstack(states, 2)
    assert single.nn.count.shape == (1,) and torch.equal(single.nn.ref, s.state.nn.ref)


# ---------------------------------------------------------------------------
# the batched kernels on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _card_ensemble(dev, case, members=3, ticks=6):
    """A ``members``-member ensemble of a case's scene on the card, after
    ``ticks`` kernel ticks."""
    build, kw = SCENES[case]
    s = build(pt.Solver(pt.SolverOptions(solver=pt.SolverName.PBD), device=dev, **kw))
    s._prepare()
    states = jittered_ensemble(s.state, members, s._builder.num_nodes, seed0=SEED0)
    env = (s.topology, s.current_params(), s.config)
    ensemble.ensemble_tick_n(states, *env, ticks)
    return states, env


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_batched_stages_equal_the_twins_member_loop(cuda, case):
    states, env = _card_ensemble(cuda, case)
    states.sim_failed[1, 0] = 1
    out = pbd_stages(states, *env)
    torch.cuda.synchronize()
    apart = stages_apart(out, [0, 2], PBD_WHOLE, PBD_ROUNDOFF)
    assert not apart, apart
    if "T21" in out:
        assert out["T21"].kernel[2][1, 0] == 0 and int(out["T21"].kernel[2].sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_one_member_equals_the_single_scene_stages(cuda, case):
    """B = 1 gives the unbatched call's outputs, bit for bit."""
    states, env = _card_ensemble(cuda, case, members=1)
    batched = pbd_stages(states, *env, twins=False)
    single = pbd_stages(unstack(states, 0), *env, twins=False)
    torch.cuda.synchronize()
    for stage in batched:
        for a, b in zip(batched[stage].kernel, single[stage].kernel):
            assert torch.equal(a.reshape(b.shape), b), stage
